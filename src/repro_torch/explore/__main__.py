"""CLI for the exploration pipeline (PyTorch/CUDA port).

Subcommands::

    python -m repro_torch.explore per-app --suite image --fabric \
        --rows 16 --cols 16 --out results/explore_image.jsonl
    python -m repro_torch.explore domain --suite ml --name PE_ML --fabric
    python -m repro_torch.explore --smoke     # fast end-to-end self check

``--device`` picks where the pnr stage anneals: ``cuda`` (the default;
fails without a card) or ``cpu`` (the kernels' plain PyTorch versions).
``--dump-config`` writes the resolved :class:`ExploreConfig` as JSON; the
same exploration replays later with ``--config cfg.json``.  ``--trace
[PATH]`` writes a Chrome trace of every stage; ``--metrics PATH`` dumps
the explorer's metrics registry as JSON.

Not ported yet: ``--simulate`` (the schedule/simulate stages exit 1 with
NotImplementedError), ``--pnr-mode hierarchical``, the on-disk ``--store``
and the fault/resume smokes of the JAX package's CLI.

Exit codes: 0 clean run; 1 degraded (StageFailures present, or a
fail-fast error) — one structured summary line on stderr, never a
traceback; 2 usage / malformed config or records file.
"""

import argparse
import json
import sys
from typing import Dict

from ..graphir.graph import Graph
from .config import ExploreConfig
from .pipeline import Explorer


def _suite(name: str) -> Dict[str, Graph]:
    from ..apps import image, image_graphs, ml_graphs
    if name == "ml":
        return ml_graphs()
    if name == "image":
        return image_graphs()
    if name == "camera":
        return {"camera": image.build_graph("camera")}
    raise SystemExit(f"unknown suite {name!r} (ml | image | camera)")


def _config_from_args(args, mode: str) -> ExploreConfig:
    from ..core.mining import MiningConfig
    if args.config:
        cfg = ExploreConfig.from_dict(json.load(open(args.config)))
        return cfg.replace(mode=mode)
    mining = MiningConfig(min_support=args.min_support,
                          max_pattern_nodes=args.max_pattern_nodes,
                          time_budget_s=args.mining_budget_s)
    fabric = None
    if args.fabric or args.simulate:
        from ..fabric import FabricOptions, FabricSpec
        fabric = FabricOptions(spec=FabricSpec(rows=args.rows,
                                               cols=args.cols),
                               chains=args.chains, sweeps=args.sweeps,
                               seed=args.seed, simulate=args.simulate)
    return ExploreConfig(mode=mode, mining=mining, max_merge=args.max_merge,
                         rank_mode=args.rank_mode, fabric=fabric,
                         per_app_subgraphs=args.per_app_subgraphs,
                         domain_name=args.name, pnr_batch=args.pnr_batch,
                         pnr_mode=args.pnr_mode, sim_batch=args.sim_batch,
                         on_error=args.on_error)


def _add_common(sp: argparse.ArgumentParser) -> None:
    sp.add_argument("--suite", default="ml",
                    help="application suite: ml | image | camera")
    sp.add_argument("--config", default=None,
                    help="load an ExploreConfig JSON blob (overrides knobs)")
    sp.add_argument("--min-support", type=int, default=3)
    sp.add_argument("--max-pattern-nodes", type=int, default=6)
    sp.add_argument("--mining-budget-s", type=float, default=15.0)
    sp.add_argument("--max-merge", type=int, default=3)
    sp.add_argument("--rank-mode", default="mis", choices=("mis", "utility"))
    sp.add_argument("--per-app-subgraphs", type=int, default=2)
    sp.add_argument("--name", default="PE_DOM",
                    help="domain variant name (domain mode)")
    sp.add_argument("--fabric", action="store_true",
                    help="place-and-route every (variant, app) pair")
    sp.add_argument("--simulate", action="store_true",
                    help="also modulo-schedule + cycle-accurately simulate "
                         "(implies --fabric; not ported yet)")
    sp.add_argument("--rows", type=int, default=8)
    sp.add_argument("--cols", type=int, default=8)
    sp.add_argument("--chains", type=int, default=8)
    sp.add_argument("--sweeps", type=int, default=16)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--pnr-batch", default="grouped",
                    choices=("grouped", "serial"))
    sp.add_argument("--pnr-mode", default="flat",
                    choices=("flat", "hierarchical"),
                    help="flat: single-level anneal (default); "
                         "hierarchical: not ported yet")
    sp.add_argument("--sim-batch", default="grouped",
                    choices=("grouped", "serial"),
                    help="batch-first schedule/simulate stages (grouped) "
                         "or the per-pair loop (serial); bit-identical")
    sp.add_argument("--on-error", default="isolate",
                    choices=("isolate", "raise"),
                    help="isolate: a failing (variant, app) pair degrades "
                         "to a StageFailure row, groupmates unaffected; "
                         "raise: fail fast on the first error")
    sp.add_argument("--allow-partial", action="store_true",
                    help="exit 0 even when some pairs degraded to "
                         "StageFailure rows")
    sp.add_argument("--inject-fault", action="append", default=None,
                    metavar="SITE:KIND:NTH",
                    help="arm a deterministic fault (repeatable); kinds: "
                         "exc | budget | kill | truncate; e.g. "
                         "pnr:exc:0, store.write:kill:2, schedule:budget:1+")
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the pnr stage anneals (default cuda)")
    sp.add_argument("--out", default=None, help="write records jsonl here")
    sp.add_argument("--dump-config", default=None,
                    help="write the resolved ExploreConfig JSON here")
    # also accepted after the subcommand; SUPPRESS keeps a value given
    # before the subcommand from being clobbered by a subparser default
    sp.add_argument("--trace", nargs="?", const="out.trace.json",
                    default=argparse.SUPPRESS, metavar="PATH",
                    help="write a Chrome trace of this run "
                         "(default PATH: out.trace.json)")
    sp.add_argument("--metrics", default=argparse.SUPPRESS, metavar="PATH",
                    help="write the metrics registry as JSON")


def _obs_begin(trace, metrics_path):
    """Enable tracing/telemetry for one CLI run."""
    if not (trace or metrics_path):
        return None
    from .. import obs
    obs.enable_tracing()
    obs.enable_telemetry()
    return (trace, metrics_path)


def _obs_end(handle, ex):
    if handle is None:
        return
    trace, metrics_path = handle
    from .. import obs
    tracer = obs.disable_tracing()
    obs.enable_telemetry(False)
    if trace and tracer is not None:
        tracer.write_chrome(trace)
        print(f"trace -> {trace} "
              f"({sum(1 for _ in tracer.iter_spans())} spans)")
    if metrics_path:
        ex.metrics.write_json(metrics_path)
        print(f"metrics -> {metrics_path}")


def _run(args, mode: str) -> int:
    from .. import faultinject
    from .records import summarize_failures

    apps = _suite(args.suite)
    cfg = _config_from_args(args, mode)
    if args.dump_config:
        with open(args.dump_config, "w") as f:
            json.dump(cfg.to_dict(), f, indent=2)
        print(f"config -> {args.dump_config}")
    ex = Explorer(apps, cfg, device=args.device)
    obs_handle = _obs_begin(getattr(args, "trace", None),
                            getattr(args, "metrics", None))
    try:
        for spec in args.inject_fault or ():
            faultinject.arm(spec)
        res = ex.run()
    finally:
        faultinject.disarm_all()
        _obs_end(obs_handle, ex)
    print(res.table())
    rows = res.records()
    if args.out:
        res.to_jsonl(args.out)
        print(f"{len(rows)} records -> {args.out}")
    print(f"# {len(rows)} (variant, app) records in {res.elapsed_s:.1f}s "
          f"[mode={mode}, pnr_batch={cfg.pnr_batch}, device={ex.device}]")
    if res.failures:
        print(f"# DEGRADED: {summarize_failures(res.failures)}",
              file=sys.stderr)
        if not args.allow_partial:
            return 1
    return 0


#: every stage the smoke config executes must appear as a span in its trace
_SMOKE_STAGES = ("mine", "rank", "merge", "map", "pnr")


def _smoke_case():
    """The paper's Fig. 3 convolution on a 4x4 fabric — the shared
    (apps, config) case of the self-check smoke (place-and-route only:
    the simulate stage is not ported yet)."""
    from ..core.mining import MiningConfig
    from ..fabric import FabricOptions, FabricSpec
    from ..graphir import trace_scalar

    def conv4(i0, i1, i2, i3, w0, w1, w2, w3, c):
        return (((i0 * w0) + (i1 * w1)) + (i2 * w2)) + (i3 * w3) + c

    apps = {"conv": trace_scalar(
        conv4, ["i0", "i1", "i2", "i3", "w0", "w1", "w2", "w3", "c"])}
    cfg = ExploreConfig(
        mode="per_app",
        mining=MiningConfig(min_support=2, max_pattern_nodes=5),
        max_merge=2,
        fabric=FabricOptions(spec=FabricSpec(rows=4, cols=4),
                             chains=2, sweeps=4))
    return apps, cfg


def smoke(trace=None, metrics_path=None, device="cuda") -> int:
    """Fast end-to-end self check.

    Runs the staged pipeline — including batched PnR on ``device`` — on
    the paper's Fig. 3 convolution example, then asserts the two
    load-bearing API properties: stage memoization (a downstream-only
    config change performs zero re-mines) and the jsonl round trip.  With
    ``trace`` set, the exported Chrome JSON must parse and contain one
    span per executed stage (:data:`_SMOKE_STAGES`).
    """
    from dataclasses import replace
    import tempfile

    from .records import from_jsonl

    apps, cfg = _smoke_case()
    ex = Explorer(apps, cfg, device=device)
    obs_handle = _obs_begin(trace, metrics_path)
    try:
        res = ex.run()
    finally:
        _obs_end(obs_handle, ex)
    if trace:
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        names = {e["name"] for e in events if e.get("ph") == "X"}
        missing = [s for s in _SMOKE_STAGES if s not in names]
        assert not missing, f"trace missing stage spans: {missing}"
        print(f"# trace OK: {len(events)} events cover all "
              f"{len(_SMOKE_STAGES)} stages")
    rows = res.records()
    assert rows, "no records produced"
    assert all(r.fabric_wirelength > 0 for r in rows), "pnr left no wires"
    mines = ex.stats["mine"]
    assert mines == 1, f"expected 1 mine, got {mines}"

    # downstream-only change: more annealing sweeps -> zero re-mines
    ex2 = ex.with_config(fabric=replace(cfg.fabric, sweeps=6))
    res2 = ex2.run()
    assert ex2.stats["mine"] == mines, "memoization failed: re-mined"
    assert res2.records(), "second run produced no records"

    with tempfile.NamedTemporaryFile(suffix=".jsonl") as f:
        res.to_jsonl(f.name)
        back = from_jsonl(f.name)
    assert [r.to_dict() for r in back] == [r.to_dict() for r in rows], \
        "jsonl round trip diverged"
    assert ex.stats["pnr_dispatch"] >= 1, "no batched pnr dispatch ran"

    print(res.table())
    print(f"# explore smoke OK: {len(rows)} records, "
          f"{ex.stats['pnr_dispatch']} batched pnr dispatch(es), "
          f"stats={dict(ex.stats)}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.explore",
                                 description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="fast end-to-end self check")
    ap.add_argument("--smoke-device", default="cuda", choices=("cuda", "cpu"),
                    help="where --smoke anneals (default cuda)")
    ap.add_argument("--trace", nargs="?", const="out.trace.json",
                    default=None, metavar="PATH",
                    help="record a pipeline trace and write Chrome "
                         "trace-event JSON (default PATH: out.trace.json)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write the run's metrics registry as JSON")
    sub = ap.add_subparsers(dest="cmd")
    for cmd in ("per-app", "domain"):
        _add_common(sub.add_parser(cmd))
    args = ap.parse_args(argv)
    from .config import ConfigFormatError
    from .records import RecordFormatError
    try:
        if args.smoke:
            return smoke(args.trace, args.metrics, args.smoke_device)
        if args.cmd is None:
            ap.print_help()
            return 2
        return _run(args, "per_app" if args.cmd == "per-app" else "domain")
    except (ConfigFormatError, RecordFormatError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except (ValueError, RuntimeError, OSError) as e:
        # --on-error raise (fail fast), a missing card, a stage that is
        # not ported yet and malformed CLI inputs land here: one
        # structured line, never an unhandled traceback
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
