"""Append-only per-commit performance history under
``results/torch/history/``.

One jsonl file per benchmark (``results/torch/history/<bench>.jsonl``);
each row is one measured trajectory point: the producing commit
(manifest ``git_sha``), the bench mode (smoke/full budgets are different
populations and never compared against each other), a manifest subset,
and the flattened scalar metrics of that run.  Rows are appended by
``python -m repro_torch.obs.regress --append`` and consumed by
:mod:`repro_torch.obs.regress` (rolling baselines).  The JAX package
keeps its own trajectory under ``results/history/``; the two never mix
(their manifests differ, and so do their devices).

The store is **append-only** and **idempotent per (sha, bench, mode)**:
re-running the nightly on the same commit does not duplicate rows, and
nothing ever rewrites an existing line — a corrupted trajectory would be
indistinguishable from a real regression.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .diff import summarize_repeats
from .manifest import capture

__all__ = ["HISTORY_SCHEMA", "DEFAULT_DIR", "history_path", "make_row",
           "append", "load", "rolling_stats"]

#: bump on any row-shape change; load() rejects other versions
HISTORY_SCHEMA = 1

DEFAULT_DIR = os.path.join("results", "torch", "history")

#: manifest fields worth carrying per row (enough to explain a step in
#: the trajectory without bloating every line with the full manifest)
_MANIFEST_SUBSET = ("python", "torch", "cuda", "driver", "platform",
                    "device_kind", "capability", "power_limit", "cpu_count")


def history_path(directory: str, bench: str) -> str:
    """File for one benchmark's trajectory (slashes in schema-style bench
    ids like ``pnr_bench/v2`` become filename-safe underscores)."""
    safe = bench.replace("/", "_").replace(os.sep, "_")
    return os.path.join(directory, f"{safe}.jsonl")


def make_row(bench: str, mode: str, metrics: Dict[str, float], *,
             manifest: Optional[Dict[str, Any]] = None,
             ts: Optional[float] = None) -> Dict[str, Any]:
    """One history row; ``metrics`` is the flattened scalar view of a
    BENCH artifact (see :func:`repro_torch.obs.regress.flatten_bench`)."""
    man = manifest if manifest is not None else capture().to_dict()
    return {"schema": HISTORY_SCHEMA,
            "bench": bench,
            "mode": mode,
            "sha": man.get("git_sha", "unknown"),
            "ts": float(ts if ts is not None else time.time()),
            "env": {k: man[k] for k in _MANIFEST_SUBSET if k in man},
            "metrics": {k: metrics[k] for k in sorted(metrics)}}


def _key(row: Dict[str, Any]) -> Tuple[str, str, str]:
    return (str(row.get("sha")), str(row.get("bench")),
            str(row.get("mode")))


def append(row: Dict[str, Any], *, directory: str = DEFAULT_DIR) -> bool:
    """Append one row to its bench's history file.

    Idempotent per (sha, bench, mode): if the trajectory already has a
    point for that key, nothing is written and False is returned — the
    first measurement of a commit wins, later re-runs never silently
    replace it.
    """
    path = history_path(directory, row["bench"])
    existing = {_key(r) for r in load(directory, row["bench"])}
    if _key(row) in existing:
        return False
    os.makedirs(directory, exist_ok=True)
    with open(path, "a") as fh:
        fh.write(json.dumps(row, sort_keys=True) + "\n")
    return True


def load(directory: str, bench: str) -> List[Dict[str, Any]]:
    """All trajectory rows for one bench, oldest first (file order).

    A corrupted line (truncated write, merge damage) is skipped with a
    warning on stderr rather than failing the whole regression gate —
    one bad trajectory point must not block every future nightly.  A
    *parseable* row with a foreign schema still raises: that is a build
    mismatch, not corruption.
    """
    path = history_path(directory, bench)
    if not os.path.exists(path):
        return []
    rows = []
    with open(path) as fh:
        for i, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError as e:
                print(f"warning: {path}:{i}: skipping corrupted history "
                      f"row ({e})", file=sys.stderr)
                continue
            if not isinstance(row, dict):
                print(f"warning: {path}:{i}: skipping non-object history "
                      f"row", file=sys.stderr)
                continue
            if row.get("schema") != HISTORY_SCHEMA:
                raise ValueError(
                    f"{path}:{i}: history schema {row.get('schema')!r} "
                    f"not supported (this build reads {HISTORY_SCHEMA})")
            rows.append(row)
    return rows


def rolling_stats(rows: Sequence[Dict[str, Any]], metric: str, *,
                  mode: Optional[str] = None,
                  window: int = 8) -> Optional[Dict[str, Any]]:
    """Median/IQR of ``metric`` over the last ``window`` rows (optionally
    restricted to one mode); None when no row carries the metric — the
    caller treats that as "no baseline yet"."""
    vals = [r["metrics"][metric] for r in rows
            if (mode is None or r.get("mode") == mode)
            and metric in r.get("metrics", {})
            and isinstance(r["metrics"][metric], (int, float))]
    if not vals:
        return None
    return summarize_repeats(vals[-window:])
