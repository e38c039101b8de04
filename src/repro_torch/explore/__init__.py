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

Stages (``mine -> rank -> merge -> map -> pnr``) are individually
invokable and memoized by content key; the ``pnr`` stage anneals all
(variant, app) placements of a bucket signature in one kernel launch.
``python -m repro_torch.explore --help`` drives the same pipeline from
the command line.  The ``schedule``/``simulate`` stages and the on-disk
store of the JAX package are not ported yet.
"""

from .config import CONFIG_SCHEMA, ConfigFormatError, ExploreConfig
from .pipeline import (Explorer, ExploreResult, evaluate_pairs, graph_key,
                       pnr_grouped)
from .records import (FAILURE_SCHEMA, RECORD_SCHEMA, ExploreRecord,
                      RecordFormatError, StageFailure, failures_from_jsonl,
                      from_jsonl, read_manifest, summarize_failures,
                      to_jsonl)

__all__ = [
    "CONFIG_SCHEMA", "ConfigFormatError", "ExploreConfig",
    "Explorer", "ExploreResult",
    "evaluate_pairs", "graph_key", "pnr_grouped",
    "FAILURE_SCHEMA", "RECORD_SCHEMA", "ExploreRecord",
    "RecordFormatError", "StageFailure", "failures_from_jsonl",
    "from_jsonl", "to_jsonl", "read_manifest", "summarize_failures",
]
