"""Observability for the exploration pipeline: traces, metrics, reports.

Zero-dependency and off by default — instrumented code paths cost ~one
dict lookup when nothing is enabled, and enabling them never changes a
computed bit.

* :mod:`repro_torch.obs.trace` — nested span tree, Chrome trace-event /
  flat-jsonl export (``span("pnr", variant=..., app=...)``);
* :mod:`repro_torch.obs.metrics` — process-local counters/gauges/
  histograms; ``Explorer.stats`` is a
  :class:`~repro_torch.obs.metrics.CounterView` over an explorer-owned
  registry;
* :mod:`repro_torch.obs.buildprof` — records the kernels' builds
  (``nvcc`` runs, Triton JIT specialisations) into both, so a timeline
  separates build time from launch time;
* :mod:`repro_torch.obs.manifest` — the environment record (torch, CUDA,
  driver, GPU) every records file and trace carries;
* :mod:`repro_torch.obs.memprof` — per-stage host-peak / CUDA-byte gauges
  when telemetry is on.

Post-pnr utilization / operand-skew reports live in
:mod:`repro_torch.obs.analyzer`; ``python -m repro_torch.obs.report``
summarizes exported artifacts.  :mod:`repro_torch.obs.diff` diffs two
artifacts with noise-aware thresholds, and
:mod:`repro_torch.obs.history` / ``python -m repro_torch.obs.regress``
keep and check a per-commit trajectory under ``results/torch/history/``.
Typical session::

    from repro_torch import obs
    tracer = obs.enable_tracing()
    obs.buildprof.enable()
    ...                       # run the pipeline
    tracer.write_chrome("out.trace.json")     # load in Perfetto
"""

from . import buildprof
from .analyzer import OperandSkew, PnrReport, analyze_pnr

# process-wide switch for heavier instrumentation (anneal acceptance/cost
# curves; results stay bit-identical, but the extra outputs are only
# materialized when this is on)
_TELEMETRY = False


def enable_telemetry(on: bool = True) -> None:
    global _TELEMETRY
    _TELEMETRY = bool(on)


def telemetry_enabled() -> bool:
    return _TELEMETRY


from .metrics import (CounterView, Histogram, MetricsRegistry,  # noqa: E402
                      global_registry, reset_global_registry)
from .trace import (Span, Tracer, current as current_tracer,  # noqa: E402
                    disable as disable_tracing, enable as enable_tracing,
                    event, span)
from .manifest import RunManifest, capture as capture_manifest  # noqa: E402
from .diff import (NoiseModel, StageDelta, diff_metrics,  # noqa: E402
                   diff_traces, summarize_repeats)
from . import diff, history, manifest, memprof  # noqa: E402

__all__ = [
    "span", "event", "enable_tracing", "disable_tracing", "current_tracer",
    "Span", "Tracer",
    "MetricsRegistry", "CounterView", "Histogram", "global_registry",
    "reset_global_registry",
    "buildprof", "enable_telemetry", "telemetry_enabled",
    "analyze_pnr", "PnrReport", "OperandSkew",
    "RunManifest", "capture_manifest",
    "NoiseModel", "StageDelta", "diff_metrics", "diff_traces",
    "summarize_repeats",
    "diff", "history", "manifest", "memprof",
]
