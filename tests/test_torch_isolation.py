"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU on their own."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def test_import_leaves_jax_and_repro_out():
    code = ("import json, sys\n"
            "import repro_torch, repro_torch.explore, repro_torch.fabric\n"
            "import repro_torch.kernels, repro_torch.explore.__main__\n"
            "import repro_torch.fabric.prng, repro_torch.obs\n"
            "import repro_torch.sim, repro_torch.kernels.sim_step\n"
            "import repro_torch.kernels.pe_fused, repro_torch.kernels.gemm\n"
            "import repro_torch.kernels.ops, repro_torch.kernels.ref\n"
            "import repro_torch.kernels.flash_attention\n"
            "import repro_torch.kernels.mamba_scan\n"
            "import repro_torch.fabric.cluster, repro_torch.explore.persist\n"
            "import repro_torch.serve, repro_torch.serve.__main__\n"
            "import repro_torch.obs.analyzer, repro_torch.obs.diff\n"
            "import repro_torch.obs.report, repro_torch.obs.history\n"
            "import repro_torch.obs.regress, repro_torch.obs.buildprof\n"
            "import repro_torch.configs, repro_torch.models\n"
            "import repro_torch.models.ssm, repro_torch.models.moe\n"
            "import repro_torch.serve.lm_engine, repro_torch.launch.serve\n"
            "import repro_torch.graphir.trace, repro_torch.apps.lm\n"
            "import repro_torch.data, repro_torch.data.pipeline\n"
            "import repro_torch.checkpoint, repro_torch.models.tree\n"
            "import repro_torch.train, repro_torch.train.trainer\n"
            "import repro_torch.launch.train\n"
            "import repro_torch.sharding, repro_torch.sharding.specs\n"
            "import repro_torch.sharding.compression\n"
            "import repro_torch.sharding.pipeline\n"
            "import repro_torch.launch.mesh\n"
            "import repro_torch.kernels.tiling, repro_torch.kernels.sharded\n"
            "import repro_torch.kernels.pnr_cost\n"
            "repro_torch.configs.get_config('llama3.2-1b')\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.') or m == 'triton' "
            "or m.startswith('triton.'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_import_neither_jax_nor_repro():
    bad = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_torch)|"
                     r"from repro\.|from repro import)", re.M)
    hits = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
            if bad.search(p.read_text())]
    assert hits == []


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_card_by_default(monkeypatch):
    from repro_torch.apps import ml_graphs
    from repro_torch.explore import ExploreConfig, Explorer
    from repro_torch.fabric import (FabricSpec, anneal_jax, anneal_jax_batch,
                                    lower, place, place_hierarchical,
                                    synthetic_netlist)
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import init_params, params_from_reference
    from repro_torch.serve.lm_engine import ServeEngine

    _no_card(monkeypatch)
    spec = FabricSpec(rows=4, cols=4)
    nl = synthetic_netlist(spec, seed=0)
    p = lower(nl, spec)
    cfg = get_config("llama3.2-1b").reduced(n_layers=1, d_model=16,
                                            d_ff=32, vocab=32)
    params = init_params(cfg, device="cpu")
    tree = {"embed": params.embed.numpy(),
            "final_norm": params.final_norm.numpy(),
            "layers": {k: params.layers[0][k][None].numpy()
                       for k in params.layers[0].keys()}}
    for call in (lambda: place(nl, spec, chains=2, sweeps=1),
                 lambda: anneal_jax(p, chains=2, sweeps=1),
                 lambda: anneal_jax_batch([p], chains=2, sweeps=1),
                 lambda: place_hierarchical(nl, spec, cluster_grid=2,
                                            chains=2, sweeps=1),
                 lambda: Explorer(ml_graphs(), ExploreConfig()),
                 lambda: init_params(cfg),
                 lambda: params_from_reference(cfg, tree),
                 lambda: ServeEngine(cfg, params)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert launch_serve.main(["--requests", "1"]) == 1
    # asking for the CPU explicitly runs the plain versions
    assert place(nl, spec, chains=2, sweeps=1, device="cpu").backend == "jax"
    assert ServeEngine(cfg, params, device="cpu").device.type == "cpu"
    assert params_from_reference(cfg, tree, device="cpu").embed.shape == \
        (32, 16)


def test_serving_needs_a_card_by_default(monkeypatch):
    from repro_torch.serve import ContinuousBatcher, ExploreService

    _no_card(monkeypatch)
    # the device is resolved when the service is built, not later in the
    # batch's worker thread
    for call in (ExploreService, ContinuousBatcher):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert ExploreService(device="cpu").batcher.device.type == "cpu"
    assert ContinuousBatcher(device="cpu").device.type == "cpu"


def test_serve_cli_needs_a_card_by_default():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "repro_torch.serve",
                          "--smoke"], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 1
    assert "no CUDA device" in out.stderr and "Traceback" not in out.stderr
    assert "serve smoke OK" not in out.stdout


def test_lm_serve_cli_needs_a_card_by_default():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 1
    assert "no CUDA device" in out.stderr and "Traceback" not in out.stderr
    assert "served" not in out.stdout


def test_fused_pe_entry_points_need_a_card_by_default(monkeypatch):
    import numpy as np
    from repro_torch.core.merge import baseline_datapath
    from repro_torch.graphir import pattern_from_spec
    from repro_torch.kernels import (attention, flash_attention,
                                     fused_pe_apply, gemm_pe,
                                     kernel_from_config, make_pe_kernel,
                                     mamba_scan, matmul_fused,
                                     selective_scan)

    _no_card(monkeypatch)
    pat = pattern_from_spec([("mul", (-1, -1)), ("add", (0, -1))])
    x = np.ones((4, 4), np.float32)
    dp = baseline_datapath({"add"})
    q = np.ones((1, 2, 3, 4), np.float32)        # (B, H, S, D)
    a = np.full((1, 2, 3, 2), 0.5, np.float32)  # (B, S, D, N)
    c = np.ones((1, 2, 2), np.float32)          # (B, S, N)
    for call in (lambda: fused_pe_apply(pat, x, x, x),
                 lambda: make_pe_kernel(pat),
                 lambda: kernel_from_config(dp, "op:add"),
                 lambda: matmul_fused(x, x),
                 lambda: gemm_pe(x, x),
                 lambda: attention(q, q, q),
                 lambda: flash_attention(q, q, q),
                 lambda: selective_scan(a, a, c),
                 lambda: mamba_scan(a, a, c)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asking for the CPU explicitly runs the plain versions
    assert fused_pe_apply(pat, x, x, x, device="cpu").tolist() == \
        [[2.0] * 4] * 4
    assert matmul_fused(x, x, device="cpu").tolist() == [[4.0] * 4] * 4
    assert attention(q, q, q, device="cpu").tolist() == q.tolist()
    assert selective_scan(a, a, c, device="cpu").tolist() == \
        [[[1.0] * 3, [1.5] * 3]]


def test_kernel_entry_points_need_a_card_by_default(monkeypatch):
    """The JAX package's kernel entry points in the port raise without a
    card unless asked for the CPU, and count no launch there."""
    import numpy as np
    from repro_torch.kernels import pnr_cost, sim_step

    _no_card(monkeypatch)
    pos = np.float32([[0, 0], [3, 1], [1, 4]])
    pins, mask = np.int32([[0, 1, 2]]), np.ones((1, 3), bool)
    x = np.float32([1.5, -2.0])
    ops = sim_step.op_table(["add"])
    calls = (lambda **kw: pnr_cost.hpwl_pallas(pos, pins, mask, **kw),
             lambda **kw: pnr_cost.hpwl_batched(pos[None], pins, mask, **kw),
             lambda **kw: pnr_cost.hpwl_delta_pallas(
                 pos, np.int32([0, 1, 2]), pins, mask, np.float32([7.0]),
                 np.int32([0, 1]), 0, 2, **kw),
             lambda **kw: sim_step.alu_step_jnp(np.int32([1, 1]), x, x, x,
                                                ops, **kw),
             lambda **kw: sim_step.alu_step_pallas(np.int32([1, 1]), x, x, x,
                                                   ops, **kw))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    counters = (pnr_cost.hpwl_pallas, pnr_cost.hpwl_batched,
                pnr_cost.hpwl_delta_pallas, sim_step.alu_step_pallas)
    before = [f.launches for f in counters]
    out = [call(device="cpu") for call in calls]
    assert [f.launches for f in counters] == before
    assert float(out[0]) == 7.0 and out[1].tolist() == [7.0]
    assert out[2][0].tolist() == [7.0, 0.0] and float(out[2][1]) == 0.0
    assert out[3].tolist() == out[4].tolist() == [3.0, -4.0]


def test_place_and_route_needs_a_card_by_default(monkeypatch):
    from repro_torch.apps import mlkernels
    from repro_torch.core.dse import app_ops
    from repro_torch.core.mapper import map_application
    from repro_torch.core.merge import baseline_datapath
    from repro_torch.fabric import FabricSpec, place_and_route

    _no_card(monkeypatch)
    name = sorted(mlkernels.ML_APPS)[0]
    app = mlkernels.build_graph(name)
    dp = baseline_datapath(app_ops(app))
    m = map_application(dp, app, name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        place_and_route(dp, m, app, FabricSpec(rows=4, cols=4), chains=2,
                        sweeps=1)


def test_cuda_wrappers_never_run_plain_on_cpu_tensors_silently():
    # a CPU tensor takes the plain version and counts no launch
    from repro_torch.kernels import pnr_cost
    before = pnr_cost.anneal_chains.launches
    i32 = dict(dtype=torch.int32)
    pnc0 = torch.zeros((1, 1))
    out = pnr_cost.anneal_chains(
        torch.zeros(1, **i32), torch.arange(8.0).view(1, 4, 2),
        torch.tensor([[[0, 3]]], **i32), torch.ones((1, 1, 2), dtype=bool),
        torch.tensor([[[0], [1], [1], [0]]], **i32), torch.zeros((1, 0)),
        torch.zeros((1, 0), dtype=bool), torch.zeros((1, 0), **i32),
        torch.zeros((1, 0), **i32), torch.zeros((1, 0)),
        torch.arange(4, **i32)[None], pnc0_out=pnc0)
    assert pnr_cost.anneal_chains.launches == before
    assert pnc0.tolist() == [[12.0]] and out[1].tolist() == [12.0]


def test_smoke_cli_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.explore",
                          "--smoke", "--smoke-device", "cpu"],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "explore smoke OK" in out.stdout
