"""The port's observability tools against the JAX package's.

The analyzer, report, diff, history and regression modules are copies of
the JAX package's with their imports rewritten (history and regress keyed
to the port's manifest), so on the same inputs they must give equal
results: the post-pnr report of the same pair, the stage tables and
diffs of traces and metrics files written by either package's tracer and
registry, the flattened committed ``results/BENCH_*.json`` artifacts, and
the regression findings against the same history rows.  ``buildprof``,
the port's counterpart of ``jaxprof``, is driven with the compiler
replaced by a fake.  Tolerance: equal.
"""

import dataclasses
import glob
import json
import os
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from repro import obs as r_obs
from repro.core.mining import MiningConfig as RMining
from repro.explore import ExploreConfig as RConfig, Explorer as RExplorer
from repro.fabric import FabricOptions as ROptions, FabricSpec as RSpec
from repro.graphir import trace_scalar as r_trace_scalar
from repro.obs import diff as r_diff, history as r_history
from repro.obs import regress as r_regress, report as r_report
from repro.obs.manifest import capture as r_capture
from repro.obs.metrics import MetricsRegistry as RRegistry
from repro.sim import modulo_schedule as r_modulo_schedule
from repro_torch import obs
from repro_torch.core.mining import MiningConfig
from repro_torch.explore import ExploreConfig, Explorer
from repro_torch.fabric import FabricOptions, FabricSpec
from repro_torch.graphir import trace_scalar
from repro_torch.kernels import build, pe_fused
from repro_torch.obs import buildprof, diff, history, regress, report
from repro_torch.obs.manifest import capture, validate_manifest
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.sim import modulo_schedule

ROOT = Path(__file__).resolve().parents[1]
ARTIFACTS = sorted(glob.glob(str(ROOT / "results" / "BENCH_*.json")))


def conv4(i0, i1, i2, i3, w0, w1, w2, w3, c):
    return (((i0 * w0) + (i1 * w1)) + (i2 * w2)) + (i3 * w3) + c


_NAMES = ["i0", "i1", "i2", "i3", "w0", "w1", "w2", "w3", "c"]


def _asdicts(deltas):
    return [dataclasses.asdict(d) for d in deltas]


# ---------------------------------------------------------------------------
# post-pnr analyzer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pnr_pairs():
    """(reference PnRResult, port PnRResult) of the same (variant, app)
    pair: the Fig. 3 convolution on a 4x4 fabric."""
    kw = dict(mode="per_app", max_merge=2)
    ref = RExplorer({"conv": r_trace_scalar(conv4, _NAMES)}, RConfig(
        mining=RMining(min_support=2, max_pattern_nodes=5),
        fabric=ROptions(spec=RSpec(rows=4, cols=4), chains=2, sweeps=4),
        **kw)).pnr()
    port = Explorer({"conv": trace_scalar(conv4, _NAMES)}, ExploreConfig(
        mining=MiningConfig(min_support=2, max_pattern_nodes=5),
        fabric=FabricOptions(spec=FabricSpec(rows=4, cols=4), chains=2,
                             sweeps=4), **kw), device="cpu").pnr()
    assert sorted(ref) == sorted(port) and ref
    return [(ref[k], port[k]) for k in sorted(ref)]


def test_analyze_pnr_matches_reference(pnr_pairs):
    for ref, port in pnr_pairs:
        # the analyzer reads Python values, not tensors
        assert all(type(c) is int for xy in port.placement.coords.values()
                   for c in xy)
        assert all(type(u) is int for u in port.routes.edge_usage.values())
        want = r_obs.analyze_pnr(ref)
        got = obs.analyze_pnr(port)
        assert got.to_dict() == want.to_dict()
        assert got.render() == want.render()
        r_sched = r_modulo_schedule(ref.netlist, ref.placement, ref.routes,
                                    ref.spec)
        t_sched = modulo_schedule(port.netlist, port.placement, port.routes,
                                  port.spec)
        want = r_obs.analyze_pnr(ref, r_sched)
        got = obs.analyze_pnr(port, t_sched)
        assert got.skews, "conv has dependence edges; skew table empty"
        assert got.to_dict() == want.to_dict()
        assert got.render() == want.render()
        assert [dataclasses.asdict(s) for s in got.skews] \
            == [dataclasses.asdict(s) for s in want.skews]


# ---------------------------------------------------------------------------
# report and diff on either package's traces and metrics
# ---------------------------------------------------------------------------
def _record(trace_mod_enable, trace_mod_disable, scale):
    """A small span forest with a side-track event, as a pipeline run
    leaves it; ``scale`` stretches the leaf stage, and above 1 adds a
    stage (a new path: a significant delta whatever the clocks say)."""
    import time
    tracer = trace_mod_enable()
    try:
        with tracer.span("explore", mode="per_app"):
            for app in ("conv", "fir"):
                with tracer.span("mine", app=app):
                    time.sleep(0.001)
                with tracer.span("pnr", app=app):
                    with tracer.span("pnr.dispatch"):
                        time.sleep(0.002 * scale)
                if scale > 1:
                    with tracer.span("schedule", app=app):
                        pass
        tracer.add_complete("compile", 0.0, 0.003, track="kernel-compile")
    finally:
        trace_mod_disable()
    return tracer


@pytest.fixture(scope="module")
def trace_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("traces")
    files = {}
    for pkg, o in (("ref", r_obs), ("port", obs)):
        for scale in (1, 3):
            tracer = _record(o.enable_tracing, o.disable_tracing, scale)
            files[pkg, scale, "chrome"] = str(d / f"{pkg}{scale}.trace.json")
            files[pkg, scale, "jsonl"] = str(d / f"{pkg}{scale}.jsonl")
            tracer.write_chrome(files[pkg, scale, "chrome"])
            tracer.write_jsonl(files[pkg, scale, "jsonl"])
    return files


def test_report_matches_reference_on_either_tracer(trace_files):
    for path in trace_files.values():
        rows = report.load_trace_rows(path)
        assert rows == r_report.load_trace_rows(path) and rows
        agg = report.aggregate_stages(rows)
        assert agg == r_report.aggregate_stages(rows)
        for md in (False, True):
            assert report.stage_table(rows, markdown=md) \
                == r_report.stage_table(rows, markdown=md)


def test_diff_traces_matches_reference_on_either_tracer(trace_files):
    for fmt in ("chrome", "jsonl"):
        for a_pkg in ("ref", "port"):
            for b_pkg in ("ref", "port"):
                a = trace_files[a_pkg, 1, fmt]
                b = trace_files[b_pkg, 3, fmt]
                got = diff.diff_traces(a, b)
                assert _asdicts(got) == _asdicts(r_diff.diff_traces(a, b))
                assert diff.render_deltas(got) \
                    == r_diff.render_deltas(r_diff.diff_traces(a, b))
                assert any(d.significant for d in got)


def test_diff_metrics_matches_reference_on_either_registry(tmp_path):
    docs = {}
    for pkg, Registry in (("ref", RRegistry), ("port", MetricsRegistry)):
        for k, scale in (("a", 1), ("b", 2)):
            reg = Registry()
            reg.inc("pnr_dispatch", 3 * scale)
            reg.inc("memo_hit", 5)
            reg.set_gauge("serve.queue_depth", scale)
            reg.set_gauge("buckets", ["a", "b"][:scale])
            reg.observe("stage.secs", 0.5 * scale)
            reg.observe("serve.batch_apps", 3)
            path = tmp_path / f"{pkg}_{k}.metrics.json"
            reg.write_json(str(path))
            docs[pkg, k] = json.loads(path.read_text())
    assert docs["ref", "a"] == docs["port", "a"]
    for a_pkg in ("ref", "port"):
        for b_pkg in ("ref", "port"):
            a, b = docs[a_pkg, "a"], docs[b_pkg, "b"]
            got = diff.diff_metrics(a, b)
            assert _asdicts(got) == _asdicts(r_diff.diff_metrics(a, b))
            assert {d.path for d in got if d.significant} \
                >= {"counters/pnr_dispatch", "gauges/buckets"}


def test_summarize_repeats_and_noise_model_match_reference():
    for xs in ([1.0], [3.0, 1.0, 2.0], [0.1, 0.4, 0.2, 9.0, 0.3]):
        assert diff.summarize_repeats(xs) == r_diff.summarize_repeats(xs)
    for base, iqr in ((0.0, 0.0), (2.0, 0.1), (100.0, 7.0)):
        assert diff.NoiseModel().threshold(base, iqr) \
            == r_diff.NoiseModel().threshold(base, iqr)


# ---------------------------------------------------------------------------
# history and regress on the committed artifacts
# ---------------------------------------------------------------------------
def test_flatten_bench_matches_reference_on_committed_artifacts():
    assert ARTIFACTS, "no committed BENCH_*.json artifacts"
    for path in ARTIFACTS:
        doc = json.loads(Path(path).read_text())
        assert regress.flatten_bench(doc) == r_regress.flatten_bench(doc)
    with pytest.raises(ValueError, match="unknown benchmark kind"):
        regress.flatten_bench({"bench": "mystery"})


def _own_manifest(doc, man):
    return dict(doc, manifest=man)


def test_check_artifact_matches_reference_on_committed_artifacts(tmp_path):
    # the same history rows for both sides (the committed trajectory)
    hist = tmp_path / "history"
    shutil.copytree(ROOT / "results" / "history", hist)
    t_man, r_man = capture().to_dict(), r_capture().to_dict()
    assert validate_manifest(t_man) == []
    for path in ARTIFACTS:
        doc = json.loads(Path(path).read_text())
        for smoke in (False, True):
            got = regress.check_artifact(_own_manifest(doc, t_man), path,
                                         history_dir=str(hist), smoke=smoke)
            want = r_regress.check_artifact(_own_manifest(doc, r_man), path,
                                            history_dir=str(hist),
                                            smoke=smoke)
            strip = [(f.bench, f.metric, f.kind, f.status) for f in got]
            assert strip == [(f.bench, f.metric, f.kind, f.status)
                             for f in want]
            # every metric's verdict and numbers; the manifest row names
            # each package's own fields
            assert [f.detail for f in got if f.metric != "manifest"] \
                == [f.detail for f in want if f.metric != "manifest"]
            ok = [f for f in got if f.metric == "manifest"]
            assert ok and ok[0].status == "ok" and "torch=" in ok[0].detail
        # a manifest of the other package fails this package's validator
        bad = regress.check_artifact(_own_manifest(doc, r_man), path,
                                     history_dir=str(hist))
        assert any(f.metric == "manifest" and f.status == "regress"
                   for f in bad)


def test_history_rows_carry_the_port_manifest(tmp_path):
    man = capture().to_dict()
    row = history.make_row("explore_pnr_batch", "full", {"grouped_s": 2.0},
                           manifest=man, ts=1.0)
    assert set(row["env"]) == {"python", "torch", "cuda", "driver",
                               "platform", "device_kind", "capability",
                               "power_limit", "cpu_count"}
    assert row["sha"] == man["git_sha"]
    d = str(tmp_path / "h")
    assert history.append(row, directory=d)
    assert not history.append(row, directory=d)     # idempotent per sha
    rows = history.load(d, "explore_pnr_batch")
    assert rows == r_history.load(d, "explore_pnr_batch") == [row]
    for metric in ("grouped_s", "nope"):
        assert history.rolling_stats(rows, metric) \
            == r_history.rolling_stats(rows, metric)


def test_port_defaults_stay_off_the_reference_artifacts(monkeypatch,
                                                        capsys):
    assert history.DEFAULT_DIR == os.path.join("results", "torch",
                                               "history")
    monkeypatch.chdir(ROOT)
    # results/BENCH_*.json are the JAX package's: the port's regression
    # check globs results/torch/ only, which holds no artifact yet
    assert regress.main([]) == 2
    assert "no BENCH_*.json artifacts" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# buildprof: kernel builds into the tracer and the registry
# ---------------------------------------------------------------------------
@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    """``build.build`` with the compiler replaced: it writes the library
    and reports, and counts its runs."""
    runs = []

    def run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        Path(out).write_bytes(b"\x7fELF")
        runs.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info: ok")

    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", run)
    yield runs
    buildprof.disable()


def test_buildprof_records_an_nvcc_run(fake_nvcc):
    reg = MetricsRegistry()
    buildprof.enable(registry=reg)
    assert buildprof.is_enabled()
    tracer = obs.enable_tracing()
    try:
        lib, log = build.build("mamba_scan.cu")
        build.build("mamba_scan.cu")          # on disk: loaded, no compile
    finally:
        obs.disable_tracing()
    assert lib.exists() and "ptxas" in log and len(fake_nvcc) == 1
    assert reg.counter("kernels.compile.events") == 1
    assert reg.counter("kernels.compile.mamba_scan") == 1
    assert reg.histogram("kernels.compile.secs").count == 1
    spans = [r for r in tracer.to_rows() if r.get("track")
             == "kernel-compile"]
    assert [(r["name"], r["attrs"]) for r in spans] \
        == [("mamba_scan", {"source": "mamba_scan.cu"})]
    assert 0.0 <= spans[0]["t0_s"] <= spans[0]["t0_s"] + spans[0]["dur_s"] \
        <= tracer.now()
    chrome = tracer.to_chrome()["traceEvents"]
    assert any(e.get("name") == "mamba_scan" for e in chrome)
    buildprof.disable()
    assert not buildprof.is_enabled()
    build.build("sim_step.cu")                 # compiled, not recorded
    assert len(fake_nvcc) == 2
    assert reg.counter("kernels.compile.events") == 1


def test_buildprof_defaults_to_the_global_registry(fake_nvcc):
    reg = obs.reset_global_registry()
    buildprof.enable()
    build.build("pnr_anneal.cu")
    buildprof.record("triton", 0.25, pattern="abc")
    assert reg.counter("kernels.compile.events") == 2
    assert reg.counter("kernels.compile.pnr_anneal") == 1
    assert reg.counter("kernels.compile.triton") == 1
    assert reg.histogram("kernels.compile.secs").vmax == 0.25


def test_triton_specialisation_key():
    # the launch Triton compiles for: pointer dtypes and 16-byte
    # alignment, n == 1 or divisible by 16, BLOCK
    kernel = object()
    x = torch.zeros(64)
    key = pe_fused._new_specialisation
    assert key(kernel, (x, x), 64, 1024)
    assert not key(kernel, (x, torch.zeros(64)), 64, 1024)
    assert key(kernel, (x, x.to(torch.bfloat16)), 64, 1024)
    assert key(kernel, (x, x[1:]), 63, 1024)
    assert key(kernel, (x, x), 64, 512)
    assert key(object(), (x, x), 64, 1024)


def test_cli_obs_hooks_enable_buildprof_on_the_explorers_registry():
    from repro_torch.explore.__main__ import _obs_begin, _obs_end

    class _Ex:
        metrics = MetricsRegistry()

    handle = _obs_begin(None, os.devnull, _Ex)
    try:
        assert buildprof.is_enabled()
        buildprof.record("triton", 0.5)
    finally:
        _obs_end(handle, _Ex)
    assert not buildprof.is_enabled()
    assert _Ex.metrics.counter("kernels.compile.triton") == 1
    assert _obs_begin(None, None, _Ex) is None and not buildprof.is_enabled()
