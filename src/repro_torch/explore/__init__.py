"""Staged, batch-first design-space-exploration pipeline.

The paper's flow (Sec. IV, Fig. 6) as an explicit pipeline object over a
single config::

    from repro_torch.explore import ExploreConfig, Explorer
    from repro_torch.fabric import FabricOptions, FabricSpec

    cfg = ExploreConfig(mode="per_app",
                        mining=MiningConfig(min_support=3),
                        fabric=FabricOptions(spec=FabricSpec(rows=8,
                                                             cols=8)))
    res = Explorer(apps, cfg).run()          # anneals on device="cuda"
    res.to_jsonl("results/explore.jsonl")

Stages (``mine -> rank -> merge -> map -> pnr -> schedule -> simulate``)
are individually invokable and memoized by content key; the ``pnr`` stage
anneals all (variant, app) placements of a bucket signature in one kernel
launch, and the ``simulate`` stage steps every program of a sim bucket in
one launch of the cycle-stepper kernel.  ``python -m repro_torch.explore
--help`` drives the same pipeline from the command line.

Robustness: pass a :class:`DiskStore` as the Explorer's store for
crash-safe resumption; with ``on_error="isolate"`` (the default) a
twice-failing (variant, app) pair degrades to a structured
:class:`StageFailure` row in ``ExploreResult.failures`` instead of
killing the run.
"""

from .config import CONFIG_SCHEMA, ConfigFormatError, ExploreConfig
from .persist import DiskStore, FileLock, ThreadSafeStore
from .pipeline import (Explorer, ExploreResult, evaluate_pairs, graph_key,
                       pnr_grouped)
from .records import (FAILURE_SCHEMA, RECORD_SCHEMA, ExploreRecord,
                      RecordFormatError, StageFailure, failures_from_jsonl,
                      from_jsonl, read_manifest, summarize_failures,
                      to_jsonl)

__all__ = [
    "CONFIG_SCHEMA", "ConfigFormatError", "ExploreConfig",
    "DiskStore", "FileLock", "ThreadSafeStore",
    "Explorer", "ExploreResult",
    "evaluate_pairs", "graph_key", "pnr_grouped",
    "FAILURE_SCHEMA", "RECORD_SCHEMA", "ExploreRecord",
    "RecordFormatError", "StageFailure", "failures_from_jsonl",
    "from_jsonl", "to_jsonl", "read_manifest", "summarize_failures",
]
