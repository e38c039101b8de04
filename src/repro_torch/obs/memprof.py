"""Memory observability: per-stage host peaks + live CUDA device bytes.

:func:`stage_memory` wraps a pipeline stage and — only while
:func:`repro_torch.obs.enable_telemetry` is on, because tracemalloc is far
too expensive to leave armed — records two registry gauges:

* ``mem.host_peak_bytes.<stage>`` — peak traced host allocation inside
  the stage (``tracemalloc``; the peak counter is reset at stage entry);
* ``mem.device_bytes.<stage>`` — bytes PyTorch's CUDA allocator holds in
  live tensors at stage exit (``torch.cuda.memory_allocated()``; 0 on a
  host without a card).

Observation only — no computed bit depends on any of it.
"""

from __future__ import annotations

import tracemalloc
from contextlib import contextmanager
from typing import Optional

from .metrics import MetricsRegistry

__all__ = ["stage_memory", "device_bytes", "host_peak_gauges"]


def device_bytes() -> int:
    """Bytes of live CUDA tensors (0 without a card)."""
    import torch
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.memory_allocated())


@contextmanager
def stage_memory(registry: Optional[MetricsRegistry], stage: str):
    """Record host-peak / device-byte gauges for one stage.

    A no-op (one function call, no clock or allocator work) unless
    telemetry is enabled and a registry is given.
    """
    from . import telemetry_enabled
    if registry is None or not telemetry_enabled():
        yield
        return
    started_here = not tracemalloc.is_tracing()
    if started_here:
        tracemalloc.start()
    else:
        tracemalloc.reset_peak()
    try:
        yield
    finally:
        _, peak = tracemalloc.get_traced_memory()
        registry.set_gauge(f"mem.host_peak_bytes.{stage}", int(peak))
        registry.set_gauge(f"mem.device_bytes.{stage}", device_bytes())
        if started_here:
            tracemalloc.stop()


def host_peak_gauges(registry: MetricsRegistry) -> dict:
    """{stage: peak bytes} for every recorded host-peak gauge."""
    prefix = "mem.host_peak_bytes."
    doc = registry.to_dict()["gauges"]
    return {k[len(prefix):]: v for k, v in doc.items()
            if k.startswith(prefix)}
