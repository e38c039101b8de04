"""Schema-versioned flat result rows for exploration sweeps.

Every (variant, app) pair an :class:`~repro_torch.explore.Explorer` evaluates
becomes one :class:`ExploreRecord`: the full ``AppCost`` column set
(per-tile, CGRA-level, array-accurate ``fabric_*``, measured ``sim_*``)
plus exploration identity — the pipeline mode, the variant's merged-
subgraph count, and the content key of the producing config, so a row can
always be traced back to the exact exploration that made it.

Pairs that *failed* (twice — batch group, then the serial retry) become
:class:`StageFailure` rows instead: stage, pair, exception class, budget
state.  They ride the same jsonl file as ``{"kind": "stage_failure"}``
lines, so a partial run's output records both what succeeded and exactly
what degraded.

Rows round-trip through jsonl (:func:`to_jsonl` / :func:`from_jsonl` /
:func:`failures_from_jsonl`) and stay directly consumable by
``results/make_tables.py ... fabric`` (the record is a strict superset
of the AppCost dict that table reads).  Malformed input fails with a
one-line :class:`RecordFormatError` naming the file, line, and fix —
never a stack trace from deep inside a parser.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

from ..core.costmodel import AppCost

#: bump on any field add/rename/retype; from_jsonl rejects other versions
#: (2: added sim_bucket — the batched-simulate bucket the row rode)
RECORD_SCHEMA = 2

#: schema for StageFailure rows (independent of RECORD_SCHEMA)
FAILURE_SCHEMA = 1


class RecordFormatError(ValueError):
    """A records jsonl / record dict that can't be parsed — reported as a
    one-line error by the CLI, never a stack trace."""


@dataclass
class StageFailure:
    """One structured failure row: a (variant, app) pair that failed a
    stage twice (batch group, then the serial retry), or a per-app /
    per-variant unit that failed a scalar stage.

    ``budget`` carries the budget state at exhaustion when the failure
    was a :class:`repro_torch.errors.BudgetExceeded` (empty otherwise);
    ``retried`` records whether the serial retry path ran.
    """

    schema: int
    stage: str                 # mine|rank|merge|map|pnr|schedule|simulate
    pe_name: str               # "" for per-app stages with no variant
    app: str                   # "" for per-variant stages with no app
    error_type: str            # exception class name, e.g. "BudgetExceeded"
    error: str                 # str(exception), first line only
    retried: bool = False
    budget: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_exception(stage: str, exc: BaseException, *, pe_name: str = "",
                       app: str = "", retried: bool = False) -> "StageFailure":
        budget = dict(getattr(exc, "budget", {}) or {})
        msg = str(exc).splitlines()[0] if str(exc) else type(exc).__name__
        return StageFailure(schema=FAILURE_SCHEMA, stage=stage,
                            pe_name=pe_name, app=app,
                            error_type=type(exc).__name__, error=msg,
                            retried=retried, budget=budget)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["kind"] = "stage_failure"
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "StageFailure":
        d = dict(d)
        kind = d.pop("kind", "stage_failure")
        if kind != "stage_failure":
            raise RecordFormatError(f"not a stage_failure row (kind={kind!r})")
        schema = d.get("schema")
        if schema != FAILURE_SCHEMA:
            raise RecordFormatError(
                f"StageFailure schema {schema!r} not supported (this build "
                f"reads schema {FAILURE_SCHEMA})")
        known = {f.name for f in dataclasses.fields(StageFailure)}
        unknown = set(d) - known
        if unknown:
            raise RecordFormatError(
                f"unknown StageFailure fields {sorted(unknown)} — "
                f"regenerate the jsonl or use a matching build")
        return StageFailure(**d)


def summarize_failures(failures: Iterable[StageFailure]) -> str:
    """One-line summary for the CLI: ``pnr=2 schedule=1 (3 failures)``."""
    by_stage: Dict[str, int] = {}
    total = 0
    for f in failures:
        by_stage[f.stage] = by_stage.get(f.stage, 0) + 1
        total += 1
    if not total:
        return "no failures"
    parts = " ".join(f"{s}={n}" for s, n in sorted(by_stage.items()))
    return f"{parts} ({total} failure{'s' if total != 1 else ''})"


# -- type checking for hardened parsing ----------------------------------

_FIELD_TYPES = {"schema": int, "n_merged": int, "n_pes": int,
                "total_ops": int, "unmapped": int, "fabric_wirelength": int,
                "sim_ii": int, "sim_min_ii": int, "sim_latency_cycles": int,
                "sim_verified": int,
                "mode": str, "config_key": str, "sim_bucket": str,
                "app": str, "pe_name": str}


def _check_types(d: Dict[str, Any]) -> Optional[str]:
    """First type violation as a one-line description, or None."""
    for name, want in _FIELD_TYPES.items():
        if name in d:
            v = d[name]
            if not isinstance(v, want) or isinstance(v, bool):
                return (f"field {name!r} must be {want.__name__}, "
                        f"got {type(v).__name__} ({v!r})")
    for fld in dataclasses.fields(ExploreRecord):
        if fld.name in _FIELD_TYPES or fld.name not in d:
            continue
        v = d[fld.name]          # remaining columns are float-valued
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            return (f"field {fld.name!r} must be a number, "
                    f"got {type(v).__name__} ({v!r})")
    return None


@dataclass
class ExploreRecord:
    """One flat row per (variant, app): identity + the AppCost columns."""

    schema: int
    mode: str                  # "per_app" | "domain"
    config_key: str            # content key of the producing ExploreConfig
    n_merged: int              # subgraphs merged into this variant
    sim_bucket: str            # batched-simulate bucket signature ("serial"
    # for the per-pair loop, "" when the pair was not simulated); outputs
    # are bucket-independent — this is provenance, not a result column
    # -- AppCost columns (names match costmodel.AppCost exactly) ----------
    app: str
    pe_name: str
    n_pes: int
    total_ops: int
    pe_area_um2: float
    total_area_um2: float
    energy_pj: float
    energy_per_op_pj: float
    fmax_ghz: float
    ops_per_pe: float
    unmapped: int
    cgra_area_um2: float = 0.0
    cgra_energy_pj: float = 0.0
    cgra_energy_per_op_pj: float = 0.0
    fabric_area_um2: float = 0.0
    fabric_energy_per_op_pj: float = 0.0
    fabric_fmax_ghz: float = 0.0
    fabric_wirelength: int = 0
    fabric_utilization: float = 0.0
    sim_ii: int = 0
    sim_min_ii: int = 0
    sim_latency_cycles: int = 0
    sim_active_frac: float = 0.0
    sim_throughput_gops: float = 0.0
    sim_energy_per_op_pj: float = 0.0
    sim_verified: int = -1

    @staticmethod
    def from_cost(cost: AppCost, *, mode: str, config_key: str,
                  n_merged: int = 0, sim_bucket: str = "") -> "ExploreRecord":
        return ExploreRecord(schema=RECORD_SCHEMA, mode=mode,
                             config_key=config_key, n_merged=n_merged,
                             sim_bucket=sim_bucket,
                             **dataclasses.asdict(cost))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ExploreRecord":
        if not isinstance(d, dict):
            raise RecordFormatError(
                f"ExploreRecord row must be an object, got "
                f"{type(d).__name__}")
        schema = d.get("schema")
        if schema != RECORD_SCHEMA:
            raise RecordFormatError(
                f"ExploreRecord schema {schema!r} not supported (this build "
                f"reads schema {RECORD_SCHEMA}) — regenerate with "
                f"`python -m repro_torch.explore` or use a matching build")
        known = {f.name for f in dataclasses.fields(ExploreRecord)}
        unknown = set(d) - known
        if unknown:
            raise RecordFormatError(
                f"unknown ExploreRecord fields {sorted(unknown)} — "
                f"regenerate the jsonl or use a matching build")
        missing = {f.name for f in dataclasses.fields(ExploreRecord)
                   if f.default is dataclasses.MISSING} - set(d)
        if missing:
            raise RecordFormatError(
                f"missing ExploreRecord fields {sorted(missing)}")
        bad = _check_types(d)
        if bad:
            raise RecordFormatError(f"bad ExploreRecord row: {bad}")
        return ExploreRecord(**d)


def to_jsonl(records: Iterable[ExploreRecord], path: str, *,
             manifest: Dict[str, Any] = None,
             failures: Iterable[StageFailure] = ()) -> int:
    """Write one record per line; returns the row count.

    The first line is a run-manifest header (``{"schema": ...,
    "manifest": {...}}`` — what environment produced these rows; see
    :mod:`repro_torch.obs.manifest`).  :func:`from_jsonl` skips it
    transparently; :func:`read_manifest` reads it back.  Pass
    ``manifest=None`` (the default) to capture the current process's, or
    an explicit dict to embed a foreign one.  ``failures`` appends one
    ``{"kind": "stage_failure"}`` line per degraded pair after the
    records (read back via :func:`failures_from_jsonl`).
    """
    if manifest is None:
        from ..obs.manifest import capture
        manifest = capture().to_dict()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = 0
    with open(path, "w") as f:
        f.write(json.dumps({"schema": RECORD_SCHEMA,
                            "manifest": manifest}) + "\n")
        for r in records:
            f.write(json.dumps(r.to_dict()) + "\n")
            n += 1
        for fl in failures:
            f.write(json.dumps(fl.to_dict()) + "\n")
    return n


def _rows(path: str):
    """Yield (line_number, parsed dict) with one-line decode errors."""
    with open(path) as f:
        for i, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError as e:
                raise RecordFormatError(
                    f"{path}:{i}: not valid JSON ({e.msg} at column "
                    f"{e.colno}) — the file is corrupt or truncated")
            yield i, d


def from_jsonl(path: str) -> List[ExploreRecord]:
    """Read records back, validating the schema version per row (the
    manifest header and any stage_failure lines are skipped)."""
    out = []
    for i, d in _rows(path):
        if not isinstance(d, dict) or "manifest" in d or "kind" in d:
            continue             # header / failure line, not a record
        try:
            out.append(ExploreRecord.from_dict(d))
        except RecordFormatError as e:
            raise RecordFormatError(f"{path}:{i}: {e}")
    return out


def failures_from_jsonl(path: str) -> List[StageFailure]:
    """The StageFailure rows embedded in a records jsonl ([] when the
    run was clean)."""
    out = []
    for i, d in _rows(path):
        if not isinstance(d, dict) or d.get("kind") != "stage_failure":
            continue
        try:
            out.append(StageFailure.from_dict(d))
        except RecordFormatError as e:
            raise RecordFormatError(f"{path}:{i}: {e}")
    return out


def read_manifest(path: str) -> Dict[str, Any]:
    """The run manifest embedded in a records jsonl ({} for pre-manifest
    files written before the trajectory layer)."""
    for _i, d in _rows(path):
        if isinstance(d, dict):
            return d.get("manifest", {}) if "manifest" in d else {}
        return {}
    return {}
