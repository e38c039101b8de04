"""Summarize obs artifacts: ``python -m repro_torch.obs.report trace.json``.

Accepts either export format of :class:`repro_torch.obs.trace.Tracer` —
Chrome trace-event JSON (``*.trace.json``) or flat jsonl — plus an
optional ``--metrics out.metrics.json`` registry dump, and prints a
stage-timing table (per span name: count, total/mean/max wall time)
with the top individual spans.  The JAX package's
``results/make_tables.py stages`` emits the same table as markdown from
the same two functions.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

__all__ = ["TraceFormatError", "load_trace_rows", "aggregate_stages",
           "stage_table", "main"]


class TraceFormatError(ValueError):
    """A trace file that is empty, truncated, or not a trace at all —
    reported as a one-line error by the CLI, never a stack trace."""


def load_trace_rows(path: str) -> List[Dict[str, Any]]:
    """Normalize a trace file (Chrome JSON or flat jsonl) to flat rows
    with ``name`` / ``dur_s`` / ``depth`` / ``attrs``.

    Raises :class:`TraceFormatError` on empty or truncated input.
    """
    with open(path) as fh:
        text = fh.read()
    if not text.strip():
        raise TraceFormatError(f"{path}: empty trace file")
    # Chrome export is one JSON document with "traceEvents"; jsonl lines
    # also start with "{", so detect by parsing, not by first character
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    if isinstance(doc, dict) and "traceEvents" in doc:
        rows = []
        for ev in doc["traceEvents"]:
            if ev.get("ph") != "X":
                continue
            rows.append({"name": ev["name"],
                         "dur_s": ev.get("dur", 0.0) / 1e6,
                         "t0_s": ev.get("ts", 0.0) / 1e6,
                         "depth": 0 if ev.get("tid") == 1 else 1,
                         "attrs": ev.get("args", {})})
        return rows
    rows = []
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        try:
            rows.append(json.loads(line))
        except json.JSONDecodeError:
            raise TraceFormatError(
                f"{path}: line {i} is not valid JSON — not a Chrome "
                f"trace or spans jsonl (truncated write?)") from None
    return rows


def aggregate_stages(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-span-name aggregate: count, total/mean/max seconds."""
    agg: Dict[str, Dict[str, Any]] = {}
    for r in rows:
        a = agg.setdefault(r["name"], {"name": r["name"], "count": 0,
                                       "total_s": 0.0, "max_s": 0.0})
        a["count"] += 1
        a["total_s"] += r.get("dur_s", 0.0)
        a["max_s"] = max(a["max_s"], r.get("dur_s", 0.0))
    # name breaks total_s ties so the table order is deterministic even
    # when durations collide (common for sub-ms spans rounded in export)
    out = sorted(agg.values(), key=lambda a: (-a["total_s"], a["name"]))
    for a in out:
        a["mean_s"] = a["total_s"] / a["count"]
    return out


def stage_table(rows: List[Dict[str, Any]], *, markdown: bool = False,
                limit: int = 0) -> str:
    """Render the stage-timing table (plain text or markdown)."""
    stages = aggregate_stages(rows)
    if limit:
        stages = stages[:limit]
    if markdown:
        lines = ["| span | count | total (s) | mean (ms) | max (ms) |",
                 "|---|---:|---:|---:|---:|"]
        for a in stages:
            lines.append(f"| {a['name']} | {a['count']} "
                         f"| {a['total_s']:.3f} | {1e3 * a['mean_s']:.2f} "
                         f"| {1e3 * a['max_s']:.2f} |")
        return "\n".join(lines)
    lines = [f"{'span':<28} {'count':>6} {'total s':>9} {'mean ms':>9} "
             f"{'max ms':>9}"]
    for a in stages:
        lines.append(f"{a['name']:<28} {a['count']:>6} "
                     f"{a['total_s']:>9.3f} {1e3 * a['mean_s']:>9.2f} "
                     f"{1e3 * a['max_s']:>9.2f}")
    return "\n".join(lines)


def _metrics_summary(path: str) -> str:
    with open(path) as fh:
        doc = json.load(fh)
    lines = ["-- metrics --"]
    for k, v in sorted(doc.get("counters", {}).items()):
        lines.append(f"  counter    {k:<40} {v}")
    for k, v in sorted(doc.get("gauges", {}).items()):
        sv = json.dumps(v)
        if len(sv) > 48:
            sv = sv[:45] + "..."
        lines.append(f"  gauge      {k:<40} {sv}")
    for k, h in sorted(doc.get("histograms", {}).items()):
        lines.append(f"  histogram  {k:<40} n={h['count']} "
                     f"mean={h['mean']:.4g} min={h['min']} max={h['max']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a repro_torch trace / metrics artifact.")
    ap.add_argument("trace", nargs="?",
                    help="trace file (Chrome JSON or flat jsonl)")
    ap.add_argument("--metrics", help="metrics registry JSON dump")
    ap.add_argument("--markdown", action="store_true",
                    help="emit the stage table as markdown")
    ap.add_argument("--limit", type=int, default=0,
                    help="show only the top N span names")
    args = ap.parse_args(argv)
    if not args.trace and not args.metrics:
        ap.error("give a trace file and/or --metrics")
    if args.trace:
        try:
            rows = load_trace_rows(args.trace)
        except TraceFormatError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"-- stage timing ({len(rows)} spans) --")
        print(stage_table(rows, markdown=args.markdown, limit=args.limit))
    if args.metrics:
        print(_metrics_summary(args.metrics))
    return 0


if __name__ == "__main__":       # pragma: no cover - exercised via CLI
    raise SystemExit(main())
