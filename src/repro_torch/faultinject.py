"""Deterministic fault injection for the exploration pipeline.

Robustness claims are only real when every degradation path runs in CI.
This module is the mechanism: production code calls :func:`fire` at its
named fault sites (one call per unit of per-pair/per-app work), and a
test — or ``python -m repro_torch.explore --inject-fault`` — arms injections
that deterministically fail the *nth* occurrence of a site.

An injection spec is ``site:kind:nth``:

* ``site`` — a fault-site name (``mine``, ``map``, ``pnr``, ``schedule``,
  ``simulate``, ``store.write`` — see the call sites);
* ``kind`` — what happens when it fires:
  - ``exc``      raise :class:`repro_torch.errors.InjectedFault`,
  - ``budget``   raise :class:`repro_torch.errors.BudgetExceeded`,
  - ``kill``     ``SIGKILL`` the current process (crash-resume testing),
  - ``truncate`` non-raising: flags the site (the DiskStore write path
    checks :func:`consume_flag` and truncates its just-committed entry,
    simulating a torn write);
* ``nth`` — fire on the nth occurrence only (0-based), or ``N+`` to fire
  on the nth and every later occurrence (persistent fault).

An optional fourth part scopes the injection to matching fire-site
context: ``site:kind:nth:key=val`` (e.g. ``mine:exc:0+:app=poison``)
only counts — and only fails — occurrences whose :func:`fire` call
carried ``key=val`` in its ``ctx``.  This is how the serving tests
poison one client's request while its batchmates stay healthy.

State is process-global and explicitly armed/cleared; nothing here runs
unless a spec was armed, so the zero-injection fast path is one dict
lookup on an empty dict.
"""

from __future__ import annotations

import os
import signal
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .errors import BudgetExceeded, InjectedFault

__all__ = ["arm", "disarm_all", "active", "fire", "consume_flag",
           "FaultSpec"]

KINDS = ("exc", "budget", "kill", "truncate")


@dataclass
class FaultSpec:
    """One armed injection, counting occurrences of its site."""

    site: str
    kind: str
    nth: int
    persistent: bool = False      # "N+" specs keep firing past nth
    match: Dict[str, str] = field(default_factory=dict)  # ctx filter
    count: int = field(default=0)

    def matches(self, ctx: Dict[str, object]) -> bool:
        return all(str(ctx.get(k)) == v for k, v in self.match.items())

    def should_fire(self) -> bool:
        n = self.count
        self.count += 1
        return n == self.nth or (self.persistent and n >= self.nth)

    @staticmethod
    def parse(spec: str) -> "FaultSpec":
        parts = spec.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                f"bad fault spec {spec!r}: expected site:kind:nth or "
                f"site:kind:nth:key=val (e.g. pnr:exc:0, "
                f"schedule:budget:1+, mine:exc:0+:app=poison)")
        site, kind, nth = parts[:3]
        match: Dict[str, str] = {}
        if len(parts) == 4:
            k, sep, v = parts[3].partition("=")
            if not sep or not k:
                raise ValueError(
                    f"bad fault context {parts[3]!r}: expected key=val")
            match[k] = v
        if kind not in KINDS:
            raise ValueError(f"bad fault kind {kind!r}: one of {KINDS}")
        persistent = nth.endswith("+")
        try:
            n = int(nth[:-1] if persistent else nth)
        except ValueError:
            raise ValueError(f"bad fault occurrence {nth!r}: an int or N+")
        return FaultSpec(site=site, kind=kind, nth=n, persistent=persistent,
                         match=match)


_ARMED: Dict[str, List[FaultSpec]] = {}
_FLAGS: Dict[str, int] = {}           # non-raising fired kinds per site


def arm(spec: str) -> FaultSpec:
    """Arm one ``site:kind:nth`` injection; returns the parsed spec."""
    fs = FaultSpec.parse(spec)
    _ARMED.setdefault(fs.site, []).append(fs)
    return fs


def disarm_all() -> None:
    """Clear every armed injection and pending flag."""
    _ARMED.clear()
    _FLAGS.clear()


def active() -> bool:
    return bool(_ARMED)


def fire(site: str, **ctx: object) -> None:
    """Count one occurrence of ``site``; fail if an armed spec matches.

    ``kind="exc"`` raises :class:`InjectedFault`, ``"budget"`` raises
    :class:`BudgetExceeded`, ``"kill"`` SIGKILLs the process (the
    crash-resume harness), ``"truncate"`` raises nothing but sets a flag
    for :func:`consume_flag`.  ``ctx`` decorates the message and feeds
    each spec's optional ``key=val`` filter: a spec with a filter only
    counts (and only fails) occurrences whose ctx matches.
    """
    specs = _ARMED.get(site)
    if not specs:
        return
    where = site if not ctx else (
        site + "[" + ",".join(f"{k}={v}" for k, v in sorted(ctx.items()))
        + "]")
    for fs in specs:
        if fs.match and not fs.matches(ctx):
            continue
        if not fs.should_fire():
            continue
        if fs.kind == "exc":
            raise InjectedFault(f"injected fault at {where} "
                                f"(occurrence {fs.count - 1})")
        if fs.kind == "budget":
            raise BudgetExceeded(f"injected budget exhaustion at {where}",
                                 injected=True, occurrence=fs.count - 1)
        if fs.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)    # never returns
        if fs.kind == "truncate":
            _FLAGS[site] = _FLAGS.get(site, 0) + 1


def consume_flag(site: str) -> bool:
    """True once per non-raising injection fired at ``site`` (used by the
    DiskStore write path to corrupt its just-committed entry)."""
    n = _FLAGS.get(site, 0)
    if n <= 0:
        return False
    _FLAGS[site] = n - 1
    return True
