"""The port's dry run (``repro_torch.launch.{roofline,hlo_cost,dryrun}``)
against the JAX package's on the CPU.

``repro.launch.dryrun`` is never imported here: it sets ``XLA_FLAGS`` to
512 host devices when imported.  ``repro.launch.roofline`` and
``repro.launch.hlo_cost`` do not, and are the references.

The JAX package counts a compiled step's HLO; the port runs its eager
step under a dispatch-mode counter.  Their product (dot) FLOPs agree
within 2% on the reduced train, prefill and decode steps once the JAX
package's ``jax.checkpoint`` around each layer body is switched off in
this process: with it, XLA recomputes every layer's forward in the
backward, which the port's eager step (activations kept) does not
(ROADMAP §3).
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_config as r_config
from repro.configs import list_archs as r_archs
from repro.launch import hlo_cost as r_hlo
from repro.launch import roofline as r_roofline
from repro.train.optimizer import AdamWConfig as RAdamW
from repro.train.optimizer import init_opt_state as r_init_opt
from repro.train.steps import build_decode_step as r_decode
from repro.train.steps import build_prefill_step as r_prefill
from repro.train.steps import build_train_step as r_train
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, hlo_cost, roofline
from repro_torch.models import params_from_reference
from repro_torch.models.model import cache_from_reference
from repro_torch.train import (build_decode_step, build_prefill_step,
                               build_train_step)
from repro_torch.train.optimizer import AdamWConfig, init_opt_state

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _shape_args(name):
    # the JAX package's dry-run shapes, read from its source (importing
    # it would set XLA_FLAGS in this process)
    info = dryrun.SHAPES[name]
    return info["batch"], info["seq"]


def test_shapes_and_skip_reason_equal_reference():
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    for name, info in dryrun.SHAPES.items():
        want = re.search(rf'"{name}": dict\(kind="(\w+)", seq=(\d+), '
                         rf'batch=(\d+)\)', src)
        assert want and (info["kind"], info["seq"], info["batch"]) == \
            (want.group(1), int(want.group(2)), int(want.group(3)))
    assert list(dryrun.SHAPES) == re.findall(r'^    "(\w+)": dict\(kind=',
                                             src, re.M)
    r = dryrun.lower_cell("llama3.2-1b", "long_500k", multi_pod=False)
    reason = " ".join(re.search(r'"reason": ((?:"[^"]*"\s*)+)', src)
                      .group(1).split())
    assert r == {"arch": "llama3.2-1b", "shape": "long_500k",
                 "mesh": "single", "status": "skipped",
                 "reason": "".join(re.findall(r'"([^"]*)"', reason))}


@pytest.mark.parametrize("arch", r_archs())
def test_param_counts_and_model_flops_equal_reference(arch):
    want, got = r_config(arch), get_config(arch)
    assert roofline.count_params(got) == r_roofline.count_params(want)
    assert roofline.count_active_params(got) == \
        r_roofline.count_active_params(want)
    for name in SHAPES:
        b, s = _shape_args(name)
        assert roofline.model_flops(got, name, b, s) == \
            r_roofline.model_flops(want, name, b, s)


def test_roofline_dict_has_reference_keys():
    kw = dict(arch="a", shape="train_4k", mesh="single", chips=256,
              flops_per_device=3e12, bytes_per_device=2e11,
              collective_bytes_per_device=1e10,
              collective_breakdown={"all-reduce": 1e10}, model_flops=5e14,
              peak_memory_bytes=1e9, collective_count=3)
    got = roofline.Roofline(**kw)
    want = r_roofline.Roofline(**kw)
    assert list(got.to_dict()) == list(want.to_dict())
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    # the H100's data-sheet peaks
    assert got.compute_s == 3e12 / 989e12
    assert got.memory_s == 2e11 / 3.35e12
    assert got.collective_s == 1e10 / 450e9
    assert got.useful_ratio == want.useful_ratio
    assert got.dominant == "memory" and got.bound_s == got.memory_s


def test_hlo_cost_fields_equal_reference():
    assert [f.name for f in dataclasses.fields(hlo_cost.HloCost)] == \
        [f.name for f in dataclasses.fields(r_hlo.HloCost)]


def test_hlo_cost_counts_every_step():
    """Twin of ``test_hlo_cost_trip_weighting``: the counter sees every
    layer of a loop and its backward (the JAX analyzer multiplies the scan
    body by its trip count; the port's loop runs each step)."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(16, 64, 64)).astype(np.float32)
                         ).requires_grad_()
    x = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))

    def grad(w, x):
        c = x
        for i in range(w.shape[0]):
            c = torch.tanh(c @ w[i])
        return torch.autograd.grad(c.sum(), w)
    cost = hlo_cost.analyze(grad, w, x)
    # fwd: 16 x 2*8*64*64 = 1.05e6; bwd adds ~2x -> ~3.1e6 dot flops
    assert 2.0e6 < cost.flops < 8.0e6, cost.flops
    # each layer's product forward, its weight gradient, and its input
    # gradient but the first layer's (x needs none)
    assert cost.flops_by_opcode["dot"] == (3 * 16 - 1) * 2 * 8 * 64 * 64
    assert cost.bytes > 0 and cost.collective_bytes == 0


def _dots_jax(fn, *args):
    return r_hlo.analyze(jax.jit(fn).lower(*args).compile().as_text()
                         ).flops_by_opcode.get("dot", 0.0)


def _dots_port(fn, *args):
    return hlo_cost.analyze(fn, *args).flops_by_opcode.get("dot", 0.0)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "falcon-mamba-7b",
                                  "qwen2-moe-a2.7b"])
def test_dot_flops_equal_reference(arch, kind, monkeypatch):
    """The counter's product FLOPs against the JAX analyzer's dot FLOPs
    of the same reduced float32 step (batch 2 x 16 tokens; decode against
    a cache of 32 filled to 16), within 2%.  Of the train step, with the
    JAX package's per-layer ``jax.checkpoint`` switched off: with it the
    JAX count is larger by the rematerialized forward."""
    rcfg, cfg = r_config(arch).reduced(), get_config(arch).reduced()
    rp = R.init_params(rcfg, jax.random.PRNGKey(0))
    tp = params_from_reference(cfg, jax.tree.map(np.asarray, rp),
                               device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)
                                             ).astype(np.int32)
    batch = {"inputs": toks, "targets": toks}
    jb = jax.tree.map(jnp.asarray, batch)
    f32 = jnp.float32
    if kind == "train":
        ro, to = RAdamW(), AdamWConfig()
        if arch == "llama3.2-1b":
            remat = _dots_jax(r_train(rcfg, ro, compute_dtype=f32), rp,
                              r_init_opt(rp, ro), jb)
        monkeypatch.setattr(jax, "checkpoint", lambda f, **kw: f)
        want = _dots_jax(r_train(rcfg, ro, compute_dtype=f32), rp,
                         r_init_opt(rp, ro), jb)
        got = _dots_port(build_train_step(cfg, to,
                                          compute_dtype=torch.float32),
                         tp, init_opt_state(tp, to), batch)
        if arch == "llama3.2-1b":
            assert remat > 1.1 * want
    elif kind == "prefill":
        want = _dots_jax(r_prefill(rcfg, smax=16, compute_dtype=f32), rp, jb)
        got = _dots_port(build_prefill_step(cfg, smax=16,
                                            compute_dtype=torch.float32),
                         tp, batch)
    else:
        _, jc = jax.jit(r_prefill(rcfg, smax=32, compute_dtype=f32))(rp, jb)
        want = _dots_jax(r_decode(rcfg, compute_dtype=f32), rp,
                         jnp.asarray(toks[:, 0]), jc)
        got = _dots_port(build_decode_step(cfg, compute_dtype=torch.float32),
                         tp, torch.from_numpy(toks[:, 0]),
                         cache_from_reference(jax.tree.map(np.asarray, jc),
                                              device="cpu"))
    assert want > 0
    assert abs(got - want) <= 0.02 * want, (got, want)


def test_kernels_on_meta_are_one_op_each():
    """K6 and K7 on meta tensors: one cost op each, charged the function's
    own work (4·D a pair inside the masks; 4 a state a step), not the
    plain version's loop; no launch counted."""
    from repro_torch.kernels import flash_attention, mamba_scan
    q = torch.empty((2, 8, 1000, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 2, 1000, 64), dtype=torch.bfloat16, device="meta")
    n6, n7 = flash_attention.launches, mamba_scan.launches
    cost = hlo_cost.analyze(flash_attention, q, k, k, causal=True,
                            window=100)
    pairs = 100 * 101 // 2 + 900 * 100
    assert cost.flops_by_opcode == {"flash_attention_cost":
                                    4 * 64 * 8 * 2 * pairs}
    assert cost.bytes == 2 * (2 * q.numel() + 2 * k.numel())
    a = torch.empty((1, 512, 256, 16), device="meta")
    c = torch.empty((1, 512, 16), device="meta")
    cost = hlo_cost.analyze(mamba_scan, a, a, c, return_state=True)
    assert cost.flops == 4 * a.numel()
    assert cost.bytes == 4 * (2 * a.numel() + c.numel() + 512 * 256
                              + 256 * 16)
    assert (flash_attention.launches, mamba_scan.launches) == (n6, n7)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_lower_cell_llama_single_pod(shape):
    """``lower_cell`` in this process on the fake 256-rank mesh: the step
    runs through under its shardings on meta tensors; per-device counts
    below the global work; the train step's collectives above 0."""
    import torch.distributed as dist
    r = dryrun.lower_cell("llama3.2-1b", shape, multi_pod=False,
                          verbose=False)
    assert not dist.is_initialized()          # the fake group is gone
    assert r["status"] == "ok" and r["chips"] == 256
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert 0 < r["useful_ratio"] <= 1.5
    assert r["peak_memory_bytes"] > 0
    assert set(r) >= set(r_roofline.Roofline(
        "a", "b", "c", 1, 1.0, 1.0, 1.0).to_dict())
    if shape == "train_4k":
        assert r["collective_bytes_per_device"] > 0
        assert r["model_flops"] == 6.0 * roofline.count_params(
            get_config("llama3.2-1b")) * 256 * 4096
