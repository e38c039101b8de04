"""Hook kernel builds into the obs tracer/metrics.

The port's counterpart of the JAX package's ``jaxprof``: where that
module forwards ``jax.monitoring`` compile events, this one is fired by
the port's own two compilers —

* an ``nvcc`` run in :func:`repro_torch.kernels.build.build` (leaf: the
  ``.cu`` source's stem, e.g. ``pnr_anneal``; a library already on disk
  is loaded, not compiled, and fires nothing);
* each new Triton JIT specialisation of a generated ``pe_kernel`` in
  :mod:`repro_torch.kernels.pe_fused` (leaf: ``triton``), timed around
  the launch that compiles it.

When enabled, each compile lands in

* the global :class:`~repro_torch.obs.metrics.MetricsRegistry` (or one
  given to :func:`enable`): counters ``kernels.compile.events`` /
  ``kernels.compile.<leaf>`` and histogram ``kernels.compile.secs``;
* the active tracer, as a completed span on a ``kernel-compile`` side
  track, so a Perfetto timeline separates build time from launch time
  (the span ends when the compile returns; its start is backdated by
  the compile's duration).

Builds can run in worker threads (the serving batcher's executor, a
parallel build), so recording holds a lock.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from .metrics import MetricsRegistry, global_registry
from .trace import current as current_tracer

__all__ = ["enable", "disable", "is_enabled", "record"]

_ENABLED = False
_REGISTRY: Optional[MetricsRegistry] = None
_LOCK = threading.Lock()


def record(leaf: str, secs: float, **attrs: Any) -> None:
    """One finished compile of ``secs`` seconds (a no-op unless enabled)."""
    with _LOCK:
        if not _ENABLED:
            return
        reg = _REGISTRY or global_registry()
        reg.inc("kernels.compile.events")
        reg.inc(f"kernels.compile.{leaf}")
        reg.observe("kernels.compile.secs", secs)
        tracer = current_tracer()
        if tracer is not None:
            t1 = tracer.now()
            tracer.add_complete(leaf, max(t1 - secs, 0.0), secs,
                                track="kernel-compile", **attrs)


def enable(registry: Optional[MetricsRegistry] = None) -> None:
    """Start recording compiles into ``registry`` (default: the global
    registry) and the active tracer."""
    global _ENABLED, _REGISTRY
    with _LOCK:
        _REGISTRY = registry
        _ENABLED = True


def disable() -> None:
    global _ENABLED, _REGISTRY
    with _LOCK:
        _ENABLED = False
        _REGISTRY = None


def is_enabled() -> bool:
    return _ENABLED
