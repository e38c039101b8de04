"""CLI for the exploration pipeline (PyTorch/CUDA port).

Subcommands::

    python -m repro_torch.explore per-app --suite ml --rows 16 --cols 16 \
        --simulate --out results/explore_ml.jsonl --dump-config cfg.json
    python -m repro_torch.explore domain --suite image --name PE_IP
    python -m repro_torch.explore per-app --suite image --fabric \
        --rows 32 --cols 32 --pnr-mode hierarchical --store store/
    python -m repro_torch.explore --smoke     # fast end-to-end self check

``--device`` picks where the pnr stage anneals and the simulate stage
steps its programs: ``cuda`` (the default; fails without a card) or
``cpu`` (the kernels' plain PyTorch versions); ``--smoke-device`` does
the same for ``--smoke``, ``--faults-smoke`` and ``--resume-smoke``.
``--pnr-mode hierarchical`` places each pair in two levels (cluster ->
detail -> deblock; ``repro_torch.fabric.place_hierarchical``).
``--dump-config`` writes the resolved :class:`ExploreConfig` as JSON; the
same exploration replays later with ``--config cfg.json``.  ``--trace
[PATH]`` writes a Chrome trace of every stage; ``--metrics PATH`` dumps
the explorer's metrics registry as JSON.

Robustness flags::

    --store DIR          crash-safe on-disk memo store; a re-invocation
                         after a crash resumes from completed stages
    --on-error MODE      isolate (default): a failing pair degrades to a
                         structured failure row; raise: fail fast
    --allow-partial      exit 0 even when pairs degraded
    --inject-fault SPEC  arm a deterministic fault (site:kind:nth);
                         repeatable — test/CI harness only

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
                         "(implies --fabric)")
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
                         "hierarchical: two-level cluster -> detail -> "
                         "deblock placement for large arrays")
    sp.add_argument("--sim-batch", default="grouped",
                    choices=("grouped", "serial"),
                    help="batch-first schedule/simulate stages (grouped) "
                         "or the per-pair loop (serial); bit-identical")
    sp.add_argument("--on-error", default="isolate",
                    choices=("isolate", "raise"),
                    help="isolate: a failing (variant, app) pair degrades "
                         "to a StageFailure row, groupmates unaffected; "
                         "raise: fail fast on the first error")
    sp.add_argument("--store", default=None, metavar="DIR",
                    help="crash-safe on-disk memo store (atomic writes, "
                         "checksummed entries); re-invoking with the same "
                         "DIR resumes from completed stages")
    sp.add_argument("--allow-partial", action="store_true",
                    help="exit 0 even when some pairs degraded to "
                         "StageFailure rows")
    sp.add_argument("--inject-fault", action="append", default=None,
                    metavar="SITE:KIND:NTH",
                    help="arm a deterministic fault (repeatable); kinds: "
                         "exc | budget | kill | truncate; e.g. "
                         "pnr:exc:0, store.write:kill:2, schedule:budget:1+")
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the pnr stage anneals and the simulate "
                         "stage runs (default cuda)")
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


def _obs_begin(trace, metrics_path, ex):
    """Enable tracing/telemetry/kernel-build profiling for one CLI run."""
    if not (trace or metrics_path):
        return None
    from .. import obs
    obs.enable_tracing()
    obs.enable_telemetry()
    obs.buildprof.enable(registry=ex.metrics)
    return (trace, metrics_path)


def _obs_end(handle, ex):
    if handle is None:
        return
    trace, metrics_path = handle
    from .. import obs
    tracer = obs.disable_tracing()
    obs.enable_telemetry(False)
    obs.buildprof.disable()
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
    store = metrics = None
    if args.store:
        from ..obs.metrics import MetricsRegistry
        from .persist import DiskStore
        metrics = MetricsRegistry()       # shared so load-time events
        store = DiskStore(args.store, metrics=metrics)   # land in it too
    ex = Explorer(apps, cfg, store=store, metrics=metrics,
                  device=args.device)
    obs_handle = _obs_begin(getattr(args, "trace", None),
                            getattr(args, "metrics", None), ex)
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
_SMOKE_STAGES = ("mine", "rank", "merge", "map", "pnr", "schedule",
                 "simulate")


def _smoke_case():
    """The paper's Fig. 3 convolution on a 4x4 fabric — the shared
    (apps, config) case every self-check smoke runs."""
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
                             chains=2, sweeps=4, simulate=True))
    return apps, cfg


def smoke(trace=None, metrics_path=None, device="cuda") -> int:
    """Fast end-to-end self check.

    Runs the full staged pipeline — including batched PnR and the cycle-
    accurate golden check on ``device`` — on the paper's Fig. 3
    convolution example, then asserts the two
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
    obs_handle = _obs_begin(trace, metrics_path, ex)
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
    assert all(r.sim_verified == 1 for r in rows), "golden check failed"
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

    # the batch-first schedule/simulate stages actually batched: every
    # simulated pair rode a bucket launch, not the per-pair loop
    assert ex.stats["sim_dispatch"] >= 1, "no batched sim dispatch ran"
    assert ex.stats["sched_group"] >= 1, "no lockstep schedule group ran"
    assert all(r.sim_bucket not in ("", "serial") for r in rows), \
        "records missing batched sim_bucket provenance"

    print(res.table())
    print(f"# explore smoke OK: {len(rows)} records, "
          f"{ex.stats['pnr_dispatch']} batched pnr dispatch(es), "
          f"{ex.stats['sim_dispatch']} batched sim dispatch(es), "
          f"stats={dict(ex.stats)}")
    return 0


def faults_smoke(device="cuda") -> int:
    """Fault-injection matrix, the pipeline on ``device``.

    One injected fault per pipeline stage, twice over:

    * transient (first attempt only) — the stage's serial retry must
      absorb it; the run stays clean and produces the full record set;
    * persistent (first attempt AND the ``.retry`` site) — the pair
      degrades to a structured :class:`StageFailure` row while every
      *untouched* pair's record stays bit-identical to a clean
      baseline (the pow2-bucket independence invariant).

    Plus a budget-exhaustion leg: an impossible scheduler II budget must
    surface as ``BudgetExceeded`` failure rows — degraded, never a hang.
    """
    from dataclasses import replace

    from .. import faultinject
    from .records import summarize_failures

    apps, cfg = _smoke_case()
    base = Explorer(apps, cfg, device=device).run()
    base_rows = {(r.pe_name, r.app): r.to_dict() for r in base.records()}
    assert base.clean and base_rows, "baseline run must be clean"

    for stage in _SMOKE_STAGES:
        faultinject.disarm_all()
        faultinject.arm(f"{stage}:exc:0")
        res = Explorer(apps, cfg, device=device).run()
        faultinject.disarm_all()
        assert res.clean, (f"{stage}: transient fault not absorbed by "
                           f"retry: {[f.to_dict() for f in res.failures]}")
        assert {(r.pe_name, r.app) for r in res.records()} \
            == set(base_rows), f"{stage}: transient fault lost records"

        faultinject.arm(f"{stage}:exc:0")
        faultinject.arm(f"{stage}.retry:exc:0")
        res = Explorer(apps, cfg, device=device).run()
        faultinject.disarm_all()
        assert res.failures, f"{stage}: persistent fault left run clean"
        assert all(f.stage == stage for f in res.failures), \
            f"{stage}: failure rows name wrong stage: {res.failures}"
        assert all(f.retried for f in res.failures), \
            f"{stage}: failure rows not marked retried"
        hit = {(f.pe_name, f.app) for f in res.failures}
        for r in res.records():
            k = (r.pe_name, r.app)
            if k in hit:      # the degraded pair keeps upstream columns
                continue
            assert r.to_dict() == base_rows[k], \
                f"{stage}: untouched pair {k} diverged from baseline"
        print(f"# {stage:<9} transient->retried clean; persistent->"
              f"{summarize_failures(res.failures)}")

    # budgets: an impossible cap degrades, never hangs — on both the
    # grouped dispatch AND its serial retry (the budget is content, not
    # a property of which batch path ran)
    for knob, stage in ((dict(anneal_max_states=1), "pnr"),
                        (dict(sim_max_cycles=1), "simulate")):
        cfg_b = cfg.replace(fabric=replace(cfg.fabric, **knob))
        res = Explorer(apps, cfg_b, device=device).run()
        assert res.failures, f"{knob}: exhausted budget left run clean"
        assert all(f.stage == stage for f in res.failures)
        assert all(f.error_type == "BudgetExceeded" for f in res.failures), \
            f"budget failures mistyped: {[f.to_dict() for f in res.failures]}"
        assert all(f.budget for f in res.failures), \
            "BudgetExceeded rows carry no budget state"
        print(f"# budget    {knob} -> {summarize_failures(res.failures)}")
    print("# explore faults-smoke OK: every stage degrades, none die")
    return 0


def resume_smoke(device="cuda") -> int:
    """Kill-resume self check, the pipeline on ``device``.

    Invokes this CLI in a subprocess with ``--store`` and an armed
    ``store.write:kill:N`` fault — the process SIGKILLs itself mid-run,
    mid-store-write.  A re-invocation against the same store directory
    must resume from the completed stages and produce records
    bit-identical to a crash-free run (manifest header excluded: it
    captures wall-clock environment).
    """
    import os
    import subprocess
    import tempfile

    def cli(extra, check=True):
        cmd = [sys.executable, "-m", "repro_torch.explore", "per-app",
               "--suite", "camera", "--simulate", "--rows", "6",
               "--cols", "6", "--chains", "2", "--sweeps", "4",
               "--min-support", "2", "--max-pattern-nodes", "5",
               "--device", device] + extra
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=600)
        if check and p.returncode != 0:
            raise AssertionError(
                f"{cmd} -> rc={p.returncode}\n{p.stdout}\n{p.stderr}")
        return p

    def records_of(path):
        with open(path) as f:
            return [ln for ln in f.read().splitlines()[1:] if ln]

    with tempfile.TemporaryDirectory() as tmp:
        clean_out = f"{tmp}/clean.jsonl"
        cli(["--out", clean_out])
        want = records_of(clean_out)
        assert want, "crash-free run produced no records"

        store = f"{tmp}/store"
        p = cli(["--store", store, "--inject-fault", "store.write:kill:3"],
                check=False)
        assert p.returncode != 0, "injected SIGKILL did not kill the run"
        n_entries = len([f for f in os.listdir(store)
                         if f.endswith(".entry")])
        assert n_entries >= 3, \
            f"killed run persisted only {n_entries} entries"

        resumed_out = f"{tmp}/resumed.jsonl"
        p = cli(["--store", store, "--out", resumed_out])
        got = records_of(resumed_out)
        assert got == want, (
            "resumed records diverge from crash-free run:\n"
            + "\n".join(ln for ln in got if ln not in want))
    print(f"# explore resume-smoke OK: killed mid-write after "
          f"{n_entries} persisted entries, resumed bit-identical "
          f"({len(want)} records)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.explore",
                                 description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="fast end-to-end self check")
    ap.add_argument("--faults-smoke", action="store_true",
                    help="fault-injection matrix: one injected fault per "
                         "stage, asserting degraded-not-dead")
    ap.add_argument("--resume-smoke", action="store_true",
                    help="kill -9 a run mid-store-write, resume from the "
                         "on-disk store, assert bit-identical records")
    ap.add_argument("--smoke-device", default="cuda", choices=("cuda", "cpu"),
                    help="where --smoke, --faults-smoke and --resume-smoke "
                         "anneal and simulate (default cuda)")
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
        if args.faults_smoke:
            return faults_smoke(args.smoke_device)
        if args.resume_smoke:
            return resume_smoke(args.smoke_device)
        if args.cmd is None:
            ap.print_help()
            return 2
        return _run(args, "per_app" if args.cmd == "per-app" else "domain")
    except (ConfigFormatError, RecordFormatError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except (ValueError, RuntimeError, OSError) as e:
        # --on-error raise (fail fast), a missing card and malformed CLI
        # inputs land here: one
        # structured line, never an unhandled traceback
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
