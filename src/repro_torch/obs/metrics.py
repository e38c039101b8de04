"""Process-local metrics: counters, gauges, and pow2-bucket histograms.

Zero-dependency.  A :class:`MetricsRegistry` is a plain dict-backed
store; counters are always-on (a dict increment is the whole cost), so
pipeline accounting — memo hit/miss per stage, batched dispatch counts,
scheduler rounds/backtracks — always flows through a registry instead of
ad-hoc ``collections.Counter`` plumbing.

Each :class:`repro_torch.explore.pipeline.Explorer` owns a registry (shared
across ``with_config`` clones, like the memo store); code outside an
explorer falls back to the process-global registry from :func:`global_registry`.

:meth:`MetricsRegistry.view` returns a ``Counter``-compatible mutable
mapping over a key prefix, which is what ``Explorer.stats`` now is: the
legacy ``stats["pnr_dispatch"] += 1`` call sites keep working, but the
numbers live in (and are reported from) the registry.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator, MutableMapping

__all__ = ["Histogram", "MetricsRegistry", "CounterView",
           "global_registry", "reset_global_registry"]


class Histogram:
    """Scalar distribution: count/sum/min/max + power-of-two buckets."""

    __slots__ = ("count", "total", "vmin", "vmax", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.buckets: Dict[int, int] = {}   # bucket upper bound -> count

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        # bucket = smallest power of two >= |v| (0 gets its own bucket)
        mag = abs(v)
        ub = 0
        if mag > 0:
            ub = 1
            while ub < mag:
                ub *= 2
        self.buckets[ub] = self.buckets.get(ub, 0) + 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "sum": self.total,
                "min": self.vmin if self.count else None,
                "max": self.vmax if self.count else None,
                "mean": self.mean,
                "buckets": {str(k): v
                            for k, v in sorted(self.buckets.items())}}


class MetricsRegistry:
    """Counters + gauges + histograms under dotted string names."""

    def __init__(self):
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, Any] = {}
        self._hists: Dict[str, Histogram] = {}

    # -- counters ----------------------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        return self._counters.get(name, 0)

    def counters(self, prefix: str = "") -> Dict[str, int]:
        return {k: v for k, v in self._counters.items()
                if k.startswith(prefix)}

    # -- gauges ------------------------------------------------------------
    def set_gauge(self, name: str, value: Any) -> None:
        """Last-write-wins; value may be any JSON-serializable object
        (cost-curve snapshots are stored as lists of floats)."""
        self._gauges[name] = value

    def gauge(self, name: str, default: Any = None) -> Any:
        return self._gauges.get(name, default)

    # -- histograms --------------------------------------------------------
    def observe(self, name: str, value: float) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        h.observe(value)

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        return h

    # -- views / export ----------------------------------------------------
    def view(self, prefix: str = "") -> "CounterView":
        return CounterView(self, prefix)

    def to_dict(self) -> Dict[str, Any]:
        return {"counters": dict(sorted(self._counters.items())),
                "gauges": dict(sorted(self._gauges.items())),
                "histograms": {k: h.to_dict()
                               for k, h in sorted(self._hists.items())}}

    def write_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2, sort_keys=True)

    def merge_from(self, other: "MetricsRegistry") -> None:
        """Fold another registry's contents into this one."""
        for k, v in other._counters.items():
            self.inc(k, v)
        self._gauges.update(other._gauges)
        for k, h in other._hists.items():
            mine = self.histogram(k)
            mine.count += h.count
            mine.total += h.total
            mine.vmin = min(mine.vmin, h.vmin)
            mine.vmax = max(mine.vmax, h.vmax)
            for ub, c in h.buckets.items():
                mine.buckets[ub] = mine.buckets.get(ub, 0) + c


class CounterView(MutableMapping):
    """``collections.Counter``-compatible window onto registry counters.

    ``view[k]`` reads ``prefix + k`` (missing keys read 0, like Counter);
    ``view[k] += n`` writes through.  ``dict(view)`` / iteration cover
    every registry counter under the prefix.
    """

    __slots__ = ("registry", "_prefix")

    def __init__(self, registry: MetricsRegistry, prefix: str = ""):
        self.registry = registry
        self._prefix = prefix

    def __getitem__(self, key: str) -> int:
        return self.registry.counter(self._prefix + key)

    def __setitem__(self, key: str, value: int) -> None:
        self.registry._counters[self._prefix + key] = int(value)

    def __delitem__(self, key: str) -> None:
        del self.registry._counters[self._prefix + key]

    def __iter__(self) -> Iterator[str]:
        p = self._prefix
        return (k[len(p):] for k in list(self.registry._counters)
                if k.startswith(p))

    def __len__(self) -> int:
        return sum(1 for _ in iter(self))

    def __contains__(self, key: object) -> bool:
        return self._prefix + str(key) in self.registry._counters

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"CounterView({dict(self)!r})"


# ---------------------------------------------------------------------------
# process-global fallback registry
# ---------------------------------------------------------------------------
_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return _GLOBAL


def reset_global_registry() -> MetricsRegistry:
    global _GLOBAL
    _GLOBAL = MetricsRegistry()
    return _GLOBAL
