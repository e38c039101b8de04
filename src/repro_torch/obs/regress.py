"""History-backed regression detector: ``python -m repro_torch.obs.regress``.

Compares fresh ``BENCH_*.json`` artifacts of the port (under
``results/torch/``) against the rolling baseline in
``results/torch/history/`` (see :mod:`repro_torch.obs.history`).  Where a
bench gate checks *invariants* (ratios >= 1, bit-identity flags), this
gates the *trajectory*: a wall-clock that drifted past its
noise bound, a speedup that eroded, a dispatch count that grew.

Per-metric rules (the :mod:`repro_torch.obs.diff` discipline):

* ``time``  — regression when the fresh median exceeds the rolling
  baseline median by ``max(abs_floor, rel_tol * median, iqr_k * IQR)``;
  the IQR comes from the baseline window *and* the fresh ``repeats``
  block, so both run-to-run and commit-to-commit noise are priced in.
* ``ratio`` — same rule, inverted (lower is worse).
* ``count`` — zero-tolerance upward: fresh must not exceed the window
  maximum (dispatch counts are deterministic; growth means batching
  broke).
* ``flag``  — must be true (hard fail, no baseline needed).

A metric with no baseline rows passes with a note — the first run of a
new benchmark (or mode) bootstraps its own trajectory.  ``--smoke``
downgrades time/ratio regressions to warnings (tier-1 CI runs on shared
runners whose absolute wall-clocks are not trustworthy enough to block a
merge; the nightly runs full-strength).  ``--append`` records the fresh
artifacts into the history store after checking (idempotent per
commit+bench+mode).

Run::

    PYTHONPATH=src python -m repro_torch.obs.regress results/torch/BENCH_*.json
    PYTHONPATH=src python -m repro_torch.obs.regress --smoke  # tier-1 CI
    PYTHONPATH=src python -m repro_torch.obs.regress --append # nightly
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from . import history as history_mod
from .diff import NoiseModel
from .manifest import validate_manifest

__all__ = ["flatten_bench", "check_artifact", "Finding", "main"]


# ---------------------------------------------------------------------------
# flattening: one scalar-metric view per benchmark schema
# ---------------------------------------------------------------------------
def _flatten_explore(doc: Dict[str, Any], times: Tuple[str, ...],
                     counts: Tuple[str, ...],
                     flags: Tuple[str, ...]) -> Dict[str, Tuple[float, str]]:
    out: Dict[str, Tuple[float, str]] = {}
    for k in times:
        if isinstance(doc.get(k), (int, float)):
            out[k] = (float(doc[k]), "time")
    if isinstance(doc.get("speedup"), (int, float)):
        out["speedup"] = (float(doc["speedup"]), "ratio")
    for k in counts:
        if isinstance(doc.get(k), (int, float)):
            out[k] = (float(doc[k]), "count")
    for k in flags:
        out[k] = (1.0 if doc.get(k) is True else 0.0, "flag")
    for k, v in sorted(doc.get("metrics", {}).items()):
        if isinstance(v, (int, float)):
            kind = "count" if k in ("pnr_dispatch", "sim_dispatch",
                                    "sched_group") else "info"
            out[f"metrics.{k}"] = (float(v), kind)
    return out


def _flatten_pnr(doc: Dict[str, Any]) -> Dict[str, Tuple[float, str]]:
    out: Dict[str, Tuple[float, str]] = {}
    for s in doc.get("sizes", []):
        tag = f"{s.get('rows')}x{s.get('cols')}"
        for k in ("delta_wall_s", "full_wall_s"):
            if isinstance(s.get(k), (int, float)):
                out[f"{tag}.{k}"] = (float(s[k]), "time")
        if isinstance(s.get("speedup"), (int, float)):
            out[f"{tag}.speedup"] = (float(s["speedup"]), "ratio")
        out[f"{tag}.bit_identical"] = (
            1.0 if s.get("bit_identical") is True else 0.0, "flag")
    a64 = doc.get("anneal64")
    if a64:
        if isinstance(a64.get("wall_s"), (int, float)):
            out["64x64.anneal_wall_s"] = (float(a64["wall_s"]), "time")
        out["64x64.completed"] = (
            1.0 if a64.get("completed") is True else 0.0, "flag")
    return out


def _flatten_pnr_v3(doc: Dict[str, Any]) -> Dict[str, Tuple[float, str]]:
    """v2's metrics plus the hierarchical section (hier.<tag>.*)."""
    out = _flatten_pnr(doc)
    for h in doc.get("hier", []):
        tag = f"hier.{h.get('rows')}x{h.get('cols')}"
        for k in ("hier_wall_s", "flat_wall_s"):
            if isinstance(h.get(k), (int, float)):
                out[f"{tag}.{k}"] = (float(h[k]), "time")
        if isinstance(h.get("speedup_vs_flat"), (int, float)):
            out[f"{tag}.speedup_vs_flat"] = (
                float(h["speedup_vs_flat"]), "ratio")
        levels = h.get("bit_identical_levels")
        ok = (isinstance(levels, dict) and levels
              and all(v is True for v in levels.values()))
        out[f"{tag}.levels_identical"] = (1.0 if ok else 0.0, "flag")
        out[f"{tag}.completed"] = (
            1.0 if h.get("completed") is True else 0.0, "flag")
    c1 = doc.get("hier_cluster1")
    if c1 is not None:
        out["hier.cluster1_identical"] = (
            1.0 if c1.get("cluster1_identical") is True else 0.0, "flag")
    return out


#: benchmark id -> flattener returning {metric: (value, kind)} with kind
#: in {"time", "ratio", "count", "flag", "info"}
_FLATTENERS = {
    "explore_pnr_batch": lambda d: _flatten_explore(
        d, ("serial_s", "grouped_s"),
        ("serial_dispatches", "grouped_dispatches"), ()),
    "explore_sim_batch": lambda d: _flatten_explore(
        d, ("serial_s", "grouped_s"),
        ("serial_compiles", "grouped_sim_dispatches",
         "grouped_sched_groups"),
        ("bit_identical", "ii_identical", "verified")),
    "pnr_bench/v2": _flatten_pnr,
    "pnr_bench/v3": _flatten_pnr_v3,
    "serve_bench/v1": lambda d: _flatten_explore(
        d, ("serial_s", "batched_s", "cache_hit_ms"),
        ("serial_dispatches", "batched_dispatches", "single_dispatches",
         "n_clients"),
        ("bit_identical",)),
}


def flatten_bench(doc: Dict[str, Any]) -> Tuple[str, str,
                                                Dict[str, float],
                                                Dict[str, str]]:
    """(bench id, mode, {metric: value}, {metric: kind}) for one artifact.

    Raises on unknown benchmark kinds — like the bench gate, adding an
    artifact forces teaching the trajectory layer how to read it.
    """
    kind = doc.get("bench") or doc.get("schema")
    fl = _FLATTENERS.get(kind)
    if fl is None:
        raise ValueError(f"unknown benchmark kind {kind!r} — add a "
                         f"flattener to repro_torch/obs/regress.py")
    mode = doc.get("mode") or ("smoke" if doc.get("smoke") else "full")
    flat = fl(doc)
    return (kind, mode, {k: v for k, (v, _) in flat.items()},
            {k: kd for k, (_, kd) in flat.items()})


def _fresh_iqr(doc: Dict[str, Any], metric: str) -> float:
    """IQR of a time metric from the artifact's own repeats block."""
    rep = doc.get("repeats")
    if not isinstance(rep, dict):
        return 0.0
    # explore benches: repeats[metric]; pnr bench: sizes/hier entries carry
    # their own repeats blocks, flattened metric names are "<tag>.<key>"
    # (hier entries flatten as "hier.<tag>.<key>")
    entry = rep.get(metric)
    if entry is None and metric.startswith("hier."):
        tag, key = metric[len("hier."):].split(".", 1)
        for h in doc.get("hier", []):
            if f"{h.get('rows')}x{h.get('cols')}" == tag:
                entry = (h.get("repeats") or {}).get(key)
    elif entry is None and "." in metric:
        tag, key = metric.split(".", 1)
        for s in doc.get("sizes", []):
            if f"{s.get('rows')}x{s.get('cols')}" == tag:
                entry = (s.get("repeats") or {}).get(key)
    if isinstance(entry, dict) and isinstance(entry.get("iqr"),
                                              (int, float)):
        return float(entry["iqr"])
    return 0.0


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------
@dataclass
class Finding:
    """One per-metric verdict."""

    path: str
    bench: str
    metric: str
    kind: str
    status: str          # "ok" | "regress" | "warn" | "no-baseline" | "info"
    detail: str

    def line(self) -> str:
        mark = {"ok": "OK  ", "regress": "FAIL", "warn": "WARN",
                "no-baseline": "NEW ", "info": "    "}[self.status]
        return f"  {mark} {self.bench:<20} {self.metric:<28} {self.detail}"


def _structural(doc: Dict[str, Any], path: str) -> List[Finding]:
    """Manifest + repeats shape checks (hard failures)."""
    out = []
    bench = doc.get("bench") or doc.get("schema") or "?"
    errors = validate_manifest(doc.get("manifest"))
    if doc.get("manifest") is None:
        errors = ["missing manifest block (regenerate the artifact)"]
    for e in errors:
        out.append(Finding(path, bench, "manifest", "flag", "regress", e))
    if not errors:
        out.append(Finding(path, bench, "manifest", "flag", "ok",
                           f"sha={doc['manifest']['git_sha'][:9]} "
                           f"torch={doc['manifest']['torch']} "
                           f"cuda={doc['manifest']['cuda']} "
                           f"device={doc['manifest']['device_kind']} "
                           f"power_limit={doc['manifest']['power_limit']}"))
    rep = doc.get("repeats")
    if rep is not None:
        if not isinstance(rep.get("n"), int) or rep["n"] < 1:
            out.append(Finding(path, bench, "repeats", "flag", "regress",
                               f"repeats.n={rep.get('n')!r}, expected a "
                               f"positive int"))
        else:
            out.append(Finding(path, bench, "repeats", "flag", "ok",
                               f"n={rep['n']}"))
    return out


def check_artifact(doc: Dict[str, Any], path: str, *,
                   history_dir: str = history_mod.DEFAULT_DIR,
                   noise: Optional[NoiseModel] = None,
                   rel_tol: float = 0.35, window: int = 8,
                   smoke: bool = False) -> List[Finding]:
    """Every Finding for one BENCH artifact vs its rolling baseline."""
    noise = noise or NoiseModel(rel_floor=rel_tol)
    findings = _structural(doc, path)
    bench, mode, metrics, kinds = flatten_bench(doc)
    rows = history_mod.load(history_dir, bench)

    for metric in sorted(metrics):
        kind = kinds[metric]
        val = metrics[metric]
        if kind == "flag":
            ok = val == 1.0
            findings.append(Finding(
                path, bench, metric, kind, "ok" if ok else "regress",
                "true" if ok else "flag is false"))
            continue
        if kind == "info":
            continue
        base = history_mod.rolling_stats(rows, metric, mode=mode,
                                         window=window)
        if base is None:
            findings.append(Finding(path, bench, metric, kind,
                                    "no-baseline",
                                    f"{val:.6g} (bootstrapping trajectory)"))
            continue
        med, iqr = base["median"], base["iqr"]
        if kind == "count":
            worst = base["max"]
            if val > worst:
                findings.append(Finding(
                    path, bench, metric, kind, "regress",
                    f"{val:.6g} > window max {worst:.6g} (count grew — "
                    f"batching regressed)"))
            else:
                findings.append(Finding(path, bench, metric, kind, "ok",
                                        f"{val:.6g} <= {worst:.6g}"))
            continue
        thr = noise.threshold(med, max(iqr, _fresh_iqr(doc, metric)))
        if kind == "time":
            bad = val > med + thr
            detail = (f"{val:.4g}s vs median {med:.4g}s "
                      f"(+{val - med:.4g}s, bound {thr:.4g}s, "
                      f"n={base['n']})")
        else:                    # ratio: lower is worse
            bad = val < med - thr
            detail = (f"{val:.4g}x vs median {med:.4g}x "
                      f"(bound {thr:.4g}, n={base['n']})")
        status = "regress" if bad else "ok"
        if bad and smoke:
            status = "warn"
            detail += " [smoke: advisory]"
        findings.append(Finding(path, bench, metric, kind, status, detail))
    return findings


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.regress",
        description="Compare fresh BENCH_*.json artifacts against the "
                    "rolling results/torch/history/ baseline.")
    ap.add_argument("artifacts", nargs="*",
                    help="BENCH_*.json files (default: "
                         "results/torch/BENCH_*.json)")
    ap.add_argument("--history", default=history_mod.DEFAULT_DIR,
                    help="history store directory")
    ap.add_argument("--smoke", action="store_true",
                    help="wall-clock/ratio drifts warn instead of fail "
                         "(tier-1 CI on shared runners)")
    ap.add_argument("--append", action="store_true",
                    help="record the fresh artifacts into the history "
                         "store after checking (nightly)")
    ap.add_argument("--rel-tol", type=float, default=0.35,
                    help="relative drift floor before a wall-clock counts "
                         "as a regression")
    ap.add_argument("--window", type=int, default=8,
                    help="rolling-baseline window (history rows)")
    args = ap.parse_args(argv)

    paths = args.artifacts or sorted(glob.glob(
        os.path.join("results", "torch", "BENCH_*.json")))
    if not paths:
        print("regress: no BENCH_*.json artifacts found", file=sys.stderr)
        return 2

    failures = 0
    print(f"regress: {len(paths)} artifact(s) vs history in "
          f"{args.history!r} (window={args.window}, "
          f"rel_tol={args.rel_tol}{', smoke' if args.smoke else ''})")
    for path in paths:
        with open(path) as fh:
            doc = json.load(fh)
        findings = check_artifact(
            doc, path, history_dir=args.history, rel_tol=args.rel_tol,
            window=args.window, smoke=args.smoke)
        print(f"{path}:")
        for f in findings:
            if f.status != "info":
                print(f.line())
        failures += sum(1 for f in findings if f.status == "regress")
        if args.append:
            bench, mode, metrics, _ = flatten_bench(doc)
            row = history_mod.make_row(bench, mode, metrics,
                                       manifest=doc.get("manifest"))
            wrote = history_mod.append(row, directory=args.history)
            print(f"  {'APPEND' if wrote else 'DUP   '} "
                  f"history[{bench}] sha={row['sha'][:9]} mode={mode}"
                  + ("" if wrote else " (already recorded)"))
    if failures:
        print(f"\nregress FAILED: {failures} regression(s)",
              file=sys.stderr)
        return 1
    print("regress passed")
    return 0


if __name__ == "__main__":      # pragma: no cover - exercised via CLI
    sys.exit(main())
