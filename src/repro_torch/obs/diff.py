"""Diff two performance artifacts with noise-aware thresholds.

``python -m repro_torch.obs.diff a.trace.json b.trace.json`` (or two metrics
registry dumps) aligns the artifacts and reports per-stage deltas.  The
load-bearing rule, shared with :mod:`repro_torch.obs.regress`:

* **exact-valued series** — counters (dispatch counts, memo hits,
  scheduler rounds), gauges, flags — diff with **zero tolerance**: any
  change is significant, because these numbers are deterministic and a
  drift means behavior changed;
* **wall-clocks** — span durations, histogram sums of seconds — diff
  with **noise-aware thresholds**: a delta is significant only when it
  clears ``max(abs_floor, rel_floor * base, iqr_k * IQR)``, where the
  IQR comes from repeated measurement (:func:`summarize_repeats` — the
  benchmarks' ``--repeats N`` blocks) when available.

Traces align by slash-joined span *path* (aggregated: total seconds and
count per path), so a renamed or newly nested stage shows up as one
removed and one added row instead of silently matching by position.
"""

from __future__ import annotations

import argparse
import json
import statistics
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["NoiseModel", "StageDelta", "summarize_repeats",
           "diff_stage_rows", "diff_traces", "diff_metrics",
           "render_deltas", "main"]


def summarize_repeats(samples: Sequence[float]) -> Dict[str, Any]:
    """Median + IQR summary of repeated measurements.

    This is the shape the benchmarks' ``repeats`` blocks carry: artifacts
    record a distribution, never a lone sample, so downstream comparisons
    know how noisy the number is.
    """
    xs = sorted(float(s) for s in samples)
    if not xs:
        raise ValueError("summarize_repeats needs at least one sample")
    med = statistics.median(xs)
    if len(xs) >= 2:
        q = statistics.quantiles(xs, n=4, method="inclusive")
        iqr = q[2] - q[0]
    else:
        iqr = 0.0
    return {"n": len(xs), "median": med, "iqr": iqr,
            "min": xs[0], "max": xs[-1]}


@dataclass(frozen=True)
class NoiseModel:
    """Significance thresholds for wall-clock deltas.

    ``threshold(base, iqr)`` is the smallest absolute delta considered
    real: an absolute floor (timer/runner jitter), a relative floor
    (shared-runner variance scales with the measurement), and an IQR
    multiple when repeated measurement supplied one.
    """

    abs_floor_s: float = 0.005
    rel_floor: float = 0.10
    iqr_k: float = 3.0

    def threshold(self, base: float, iqr: float = 0.0) -> float:
        return max(self.abs_floor_s, self.rel_floor * abs(base),
                   self.iqr_k * iqr)


@dataclass
class StageDelta:
    """One aligned row of a diff: a -> b for a path/metric."""

    path: str
    kind: str                 # "time" | "exact"
    a: Optional[float]        # None: only present in b
    b: Optional[float]        # None: only present in a
    delta: float = 0.0
    rel: float = 0.0          # delta / a (0 when a is 0/None)
    significant: bool = False
    noise_s: float = 0.0      # the threshold the delta was held against
    detail: str = ""

    def row(self) -> str:
        mark = "!" if self.significant else " "
        a = "-" if self.a is None else f"{self.a:.6g}"
        b = "-" if self.b is None else f"{self.b:.6g}"
        return (f"{mark} {self.kind:<5} {self.path:<40} {a:>12} {b:>12} "
                f"{self.delta:>+12.6g} {100 * self.rel:>+8.1f}% "
                f"{self.detail}")


def _mk_delta(path: str, kind: str, a: Optional[float], b: Optional[float],
              noise: float = 0.0, detail: str = "") -> StageDelta:
    if a is None or b is None:
        # appearing/disappearing series are always significant
        return StageDelta(path, kind, a, b, significant=True,
                          noise_s=noise, detail=detail or "added/removed")
    delta = b - a
    rel = delta / a if a else 0.0
    if kind == "exact":
        sig = delta != 0
    else:
        sig = abs(delta) > noise
    return StageDelta(path, kind, a, b, delta, rel, sig, noise, detail)


def diff_stage_rows(rows_a: List[Dict[str, Any]],
                    rows_b: List[Dict[str, Any]], *,
                    noise: Optional[NoiseModel] = None,
                    iqr: Dict[str, float] = None) -> List[StageDelta]:
    """Align two flat trace-row lists by span path; per-path total-seconds
    deltas (noise-aware) plus span-count deltas (exact)."""
    noise = noise or NoiseModel()
    iqr = iqr or {}

    def agg(rows):
        by_path: Dict[str, Dict[str, float]] = {}
        for r in rows:
            a = by_path.setdefault(r.get("path", r["name"]),
                                   {"total_s": 0.0, "count": 0})
            a["total_s"] += r.get("dur_s", 0.0)
            a["count"] += 1
        return by_path

    agg_a, agg_b = agg(rows_a), agg(rows_b)
    out: List[StageDelta] = []
    for path in sorted(set(agg_a) | set(agg_b)):
        a, b = agg_a.get(path), agg_b.get(path)
        ta = a["total_s"] if a else None
        tb = b["total_s"] if b else None
        thr = noise.threshold(ta or 0.0, iqr.get(path, 0.0))
        out.append(_mk_delta(path, "time", ta, tb, thr))
        ca = float(a["count"]) if a else None
        cb = float(b["count"]) if b else None
        out.append(_mk_delta(f"{path}#count", "exact", ca, cb))
    return out


def diff_traces(path_a: str, path_b: str, *,
                noise: Optional[NoiseModel] = None) -> List[StageDelta]:
    """Diff two trace files (Chrome JSON or flat jsonl) by span path."""
    from .report import load_trace_rows
    return diff_stage_rows(load_trace_rows(path_a), load_trace_rows(path_b),
                           noise=noise)


def diff_metrics(doc_a: Dict[str, Any], doc_b: Dict[str, Any], *,
                 noise: Optional[NoiseModel] = None) -> List[StageDelta]:
    """Diff two metrics-registry dumps (``MetricsRegistry.to_dict``).

    Counters and numeric gauges are exact-valued (zero tolerance);
    histogram sums are wall-clock-like only for second-valued series
    (name ends in ``secs``/``_s``), exact otherwise.
    """
    noise = noise or NoiseModel()
    out: List[StageDelta] = []

    def num(v):
        return float(v) if isinstance(v, (int, float)) else None

    for section, kind in (("counters", "exact"), ("gauges", "exact")):
        sa = doc_a.get(section, {})
        sb = doc_b.get(section, {})
        for k in sorted(set(sa) | set(sb)):
            a, b = num(sa.get(k)) if k in sa else None, \
                num(sb.get(k)) if k in sb else None
            if (k in sa and a is None) or (k in sb and b is None):
                # non-numeric gauge (lists, strings): compare by equality
                eq = sa.get(k) == sb.get(k) and k in sa and k in sb
                out.append(StageDelta(f"{section}/{k}", "exact", None, None,
                                      significant=not eq,
                                      detail="equal" if eq else "changed"))
                continue
            out.append(_mk_delta(f"{section}/{k}", kind, a, b))
    ha = doc_a.get("histograms", {})
    hb = doc_b.get("histograms", {})
    for k in sorted(set(ha) | set(hb)):
        a = ha.get(k, {}).get("sum") if k in ha else None
        b = hb.get(k, {}).get("sum") if k in hb else None
        timelike = k.endswith("secs") or k.endswith("_s")
        thr = noise.threshold(a or 0.0) if timelike else 0.0
        out.append(_mk_delta(f"histograms/{k}.sum",
                             "time" if timelike else "exact", a, b, thr))
        ca = float(ha[k]["count"]) if k in ha else None
        cb = float(hb[k]["count"]) if k in hb else None
        out.append(_mk_delta(f"histograms/{k}.count", "exact", ca, cb))
    return out


def render_deltas(deltas: List[StageDelta], *,
                  only_significant: bool = False) -> str:
    shown = [d for d in deltas if d.significant or not only_significant]
    header = (f"  {'kind':<5} {'path':<40} {'a':>12} {'b':>12} "
              f"{'delta':>12} {'rel':>9}")
    lines = [header] + [d.row() for d in shown]
    n_sig = sum(1 for d in deltas if d.significant)
    lines.append(f"-- {len(deltas)} aligned series, {n_sig} significant "
                 f"(! = beyond noise bound; exact series have zero "
                 f"tolerance)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.diff",
        description="Diff two traces or metrics dumps with noise-aware "
                    "thresholds (exact series: zero tolerance).")
    ap.add_argument("a", help="baseline artifact")
    ap.add_argument("b", help="fresh artifact")
    ap.add_argument("--metrics", action="store_true",
                    help="inputs are metrics-registry JSON dumps, not traces")
    ap.add_argument("--all", action="store_true",
                    help="show every aligned row, not only significant ones")
    ap.add_argument("--rel-floor", type=float, default=NoiseModel.rel_floor)
    ap.add_argument("--abs-floor-s", type=float,
                    default=NoiseModel.abs_floor_s)
    args = ap.parse_args(argv)
    noise = NoiseModel(abs_floor_s=args.abs_floor_s,
                       rel_floor=args.rel_floor)
    if args.metrics:
        with open(args.a) as fa, open(args.b) as fb:
            deltas = diff_metrics(json.load(fa), json.load(fb), noise=noise)
    else:
        deltas = diff_traces(args.a, args.b, noise=noise)
    print(render_deltas(deltas, only_significant=not args.all))
    return 1 if any(d.significant and d.kind == "exact" for d in deltas) \
        else 0


if __name__ == "__main__":      # pragma: no cover - exercised via CLI
    raise SystemExit(main())
