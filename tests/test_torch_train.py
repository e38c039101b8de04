"""The port's training path (``repro_torch.train``, ``.data``,
``.checkpoint``, ``.launch.train``) against the JAX package's on the CPU.

Parameters come from the JAX package's ``init_params`` and cross over
through ``params_from_reference`` (moments through
``opt_state_from_reference``).  Tolerances: rtol = atol = 1e-4 in
float32 and 2e-2 in bfloat16; the bfloat16 reference is compiled with
``xla_allow_excess_precision`` off (see ``test_torch_lm_model.py``).
K6 and K7's autograd Functions run here with their launch swapped for
the plain version (the CUDA kernels need a card); on the card,
``chip_smoke.py`` phase 15 and ``tests/test_torch_lm_gpu.py`` hold them.
Every Prefetcher and subprocess has a timeout."""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.checkpoint import latest_step as r_latest
from repro.checkpoint import restore_checkpoint as r_restore
from repro.checkpoint import save_checkpoint as r_save
from repro.configs import get_config as r_config
from repro.data import DataConfig as RDataConfig
from repro.data import SyntheticLM as RSyntheticLM
from repro.train import AdamWConfig as RAdamW
from repro.train import adamw_update as r_adamw
from repro.train import build_decode_step as r_build_decode
from repro.train import build_prefill_step as r_build_prefill
from repro.train import build_train_step as r_build
from repro.train import init_opt_state as r_init_opt
from repro.train import lm_loss as r_lm_loss
from repro.train import lr_schedule as r_lr
from repro.train import opt_state_shapes as r_opt_shapes
from repro.train.optimizer import OptState as ROptState
from repro.models.transformer import param_shapes as r_param_shapes
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config, list_archs
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM, make_source
from repro_torch.kernels.flash_attention import attention_plain
from repro_torch.kernels.mamba_scan import mamba_scan_plain
from repro_torch.launch import train as launch_train
from repro_torch.models import (cache_to_numpy, init_params, param_shapes,
                                params_from_reference)
from repro_torch.models.tree import leaves
from repro_torch.train import (AdamWConfig, Trainer, TrainerConfig,
                               adamw_update, build_decode_step,
                               build_prefill_step, build_train_step,
                               init_opt_state, lm_loss, lr_schedule,
                               opt_state_from_reference, opt_state_shapes,
                               on_resize)

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
STRICT = {"xla_allow_excess_precision": False}
#: the families the step is held on: dense, softcapped local/global,
#: Mamba, MoE
STEP_ARCHS = ["llama3.2-1b", "gemma2-27b", "falcon-mamba-7b",
              "qwen2-moe-a2.7b"]
TINY = dict(n_layers=1, d_model=32, d_ff=64, vocab=64)
DATA_TIMEOUT_S = 120.0


def _key(p):
    for attr in ("key", "idx", "name"):
        if hasattr(p, attr):
            return str(getattr(p, attr))
    return str(p)


def _ref_np(tree):
    """``{leaf name: float32 array}`` of a JAX tree (names as the
    checkpointer joins them)."""
    return {"__".join(_key(p) for p in path): np.asarray(a, np.float32)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_np(tree):
    """The same of a port tree, layers stacked."""
    groups = {}
    for leaf in leaves(tree):
        groups.setdefault(leaf.name, []).append(
            (leaf.index, leaf.value.detach().float().cpu().numpy()))
    return {k: np.stack([a for _, a in v]) if v[0][0] is not None
            else v[0][1] for k, v in groups.items()}


def _close_trees(got, want, tol, what):
    got, want = _port_np(got), _ref_np(want)
    assert sorted(got) == sorted(want), what
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=tol,
                                   atol=tol, err_msg=f"{what}: {name}")


def _rel_errors(got, want):
    """``{leaf name: ||got - want|| / ||want||}`` over two ``{name:
    array}`` dicts (where ``want`` is all zero: ``||got||``)."""
    out = {}
    for name, w in want.items():
        d = np.linalg.norm((got[name] - w).astype(np.float64))
        r = np.linalg.norm(w.astype(np.float64))
        out[name] = d / r if r else d
    return out


def _close_by_norm(got, want, tol, what):
    """Each leaf of ``got`` within ``tol`` of ``want``'s by relative error
    norm (``{name: array}`` dicts)."""
    assert sorted(got) == sorted(want), what
    for name, r in _rel_errors(got, want).items():
        assert r <= tol, f"{what}: {name} relative error norm {r:.3e}"


def _strict(fn, dtype):
    return jax.jit(fn, compiler_options=STRICT) if dtype == "bfloat16" \
        else jax.jit(fn)


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        inputs = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    batch = {"inputs": inputs,
             "targets": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.n_cross_layers:
        batch["enc"] = rng.normal(size=(b, cfg.encoder_len, cfg.d_model)
                                  ).astype(np.float32)
    return batch


def _reference(arch, **reduce):
    rcfg = r_config(arch).reduced(**reduce)
    params = R.init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    cfg = get_config(arch).reduced(**reduce)
    return rcfg, params, cfg, params_from_reference(cfg, tree, device="cpu")


# ---------------------------------------------------------------------------
# twins of tests/test_train_substrate.py, held to the JAX package
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr_peak=0.1, warmup_steps=5, total_steps=200,
                      weight_decay=0.0, moment_dtype=torch.float32)
    rcfg = RAdamW(lr_peak=0.1, warmup_steps=5, total_steps=200,
                  weight_decay=0.0, moment_dtype=jnp.float32)
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    rparams = {"w": jnp.asarray([3.0, -2.0, 1.5])}
    opt, ropt = init_opt_state(params, cfg), r_init_opt(rparams, rcfg)
    target = torch.tensor([1.0, 1.0, 1.0])
    for i in range(200):
        params, opt, _ = adamw_update(
            params, {"w": 2 * (params["w"] - target)}, opt, cfg)
        rparams, ropt, _ = r_adamw(
            rparams, {"w": 2 * (rparams["w"] - 1.0)}, ropt, rcfg)
        if i % 50 == 0:
            np.testing.assert_allclose(params["w"].numpy(),
                                       np.asarray(rparams["w"]), rtol=1e-5,
                                       atol=1e-6)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(rparams["w"]),
                               rtol=1e-4, atol=1e-5)


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    rcfg = RAdamW(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(cfg, torch.tensor(s))) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9
    assert abs(lrs[10] - 1e-3) < 1e-9
    assert lrs[-1] < lrs[50] < lrs[11]
    assert lrs[-1] >= cfg.lr_peak * cfg.lr_min_ratio - 1e-9
    want = [float(r_lr(rcfg, jnp.asarray(s))) for s in range(100)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6, atol=0)


def test_grad_clip_applies():
    cfg = AdamWConfig(grad_clip=1.0, weight_decay=0.0)
    rcfg = RAdamW(grad_clip=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(3)}
    opt = init_opt_state(params, cfg)
    new, _, metrics = adamw_update(
        params, {"w": torch.tensor([100., 0., 0.])}, opt, cfg)
    assert float(metrics["grad_norm"]) > 99.0
    rnew, _, rmetrics = r_adamw({"w": jnp.zeros(3)},
                                {"w": jnp.asarray([100., 0., 0.])},
                                r_init_opt({"w": jnp.zeros(3)}, rcfg), rcfg)
    assert float(metrics["grad_norm"]) == float(rmetrics["grad_norm"])
    np.testing.assert_allclose(new["w"].numpy(), np.asarray(rnew["w"]),
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_accumulation_equivalence(dtype):
    """microbatches=2 matches microbatches=1 on the same global batch (the
    reference's bounds), and matches the JAX package's microbatches=2."""
    rcfg, rparams, cfg, params = _reference("llama3.2-1b", **TINY)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10,
                          moment_dtype=torch.float32)
    batch = _batch(cfg, b=4)
    p1, _, m1 = build_train_step(cfg, opt_cfg, compute_dtype=tdt)(
        params, init_opt_state(params, opt_cfg), batch)
    p2, o2, m2 = build_train_step(cfg, opt_cfg, microbatches=2,
                                  compute_dtype=tdt)(
        params, init_opt_state(params, opt_cfg), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-3)
    d = [float((a.value - b.value).abs().max())
         for a, b in zip(leaves(p1), leaves(p2))]
    assert max(d) < 5e-3
    ropt_cfg = RAdamW(lr_peak=1e-3, warmup_steps=1, total_steps=10,
                      moment_dtype=jnp.float32)
    rp2, ro2, rm2 = _strict(r_build(rcfg, ropt_cfg, microbatches=2,
                                    compute_dtype=jdt), dtype)(
        rparams, r_init_opt(rparams, ropt_cfg),
        jax.tree.map(jnp.asarray, batch))
    tol = TOL[dtype]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m2[k]), float(rm2[k]), rtol=tol,
                                   atol=tol, err_msg=k)
    _close_trees(p2, rp2, tol, "params")
    _close_trees(o2.m, ro2.m, tol, "m")


def test_data_determinism_and_sharding():
    cfg = DataConfig(vocab=100, seq_len=32, global_batch=8, n_hosts=2,
                     host_id=0, seed=3)
    a = SyntheticLM(cfg).batch_at(7)
    b = SyntheticLM(cfg).batch_at(7)
    np.testing.assert_array_equal(a["inputs"], b["inputs"])
    assert a["inputs"].shape == (4, 32)
    other = SyntheticLM(DataConfig(vocab=100, seq_len=32, global_batch=8,
                                   n_hosts=2, host_id=1, seed=3)).batch_at(7)
    assert not np.array_equal(a["inputs"], other["inputs"])
    for host in (0, 1):
        for step in (0, 7, 1000):
            kw = dict(vocab=100, seq_len=32, global_batch=8, n_hosts=2,
                      host_id=host, seed=3)
            got = SyntheticLM(DataConfig(**kw)).batch_at(step)
            want = RSyntheticLM(RDataConfig(**kw)).batch_at(step)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes()


def test_memmap_source_and_prefetcher_equal_reference(tmp_path):
    from repro.data import MemmapLM as RMemmapLM
    path = str(tmp_path / "toks.bin")
    np.random.default_rng(0).integers(0, 500, 4096).astype(
        np.uint16).tofile(path)
    kw = dict(vocab=500, seq_len=16, global_batch=4, seed=2, path=path)
    src = make_source(DataConfig(**kw))
    want = RMemmapLM(RDataConfig(**kw))
    pf = Prefetcher(src, start_step=5, timeout=DATA_TIMEOUT_S)
    try:
        for step in range(5, 9):
            got_step, got = next(pf)
            assert got_step == step
            assert got["inputs"].tobytes() == \
                want.batch_at(step)["inputs"].tobytes()
    finally:
        pf.stop()


def test_prefetcher_times_out():
    class Stuck:
        def batch_at(self, step):
            import time
            time.sleep(5)
            return {}
    pf = Prefetcher(Stuck(), timeout=0.2)
    try:
        with pytest.raises(TimeoutError):
            next(pf)
    finally:
        pf.stop()


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}
    d = str(tmp_path)
    save_checkpoint(d, 42, tree)
    assert latest_step(d) == 42
    got = restore_checkpoint(d, 42, tree)
    for k in ("a", "step"):
        assert torch.equal(got[k], tree[k])
    assert got["b"]["c"].dtype == torch.bfloat16
    # the JAX package reads the same files
    rtree = {"a": jnp.zeros((2, 3)), "b": {"c": jnp.zeros(4, jnp.bfloat16)},
             "step": jnp.asarray(0, jnp.int32)}
    back = r_restore(d, 42, rtree)
    np.testing.assert_array_equal(np.asarray(back["a"]), tree["a"].numpy())
    assert int(back["step"]) == 7 and back["b"]["c"].dtype == jnp.bfloat16


def test_checkpoint_retention_and_tmp_ignored(tmp_path):
    d = str(tmp_path)
    tree = {"x": torch.zeros(2)}
    for s in (10, 20, 30, 40):
        save_checkpoint(d, s, tree, keep=2)
    assert latest_step(d) == 40 == r_latest(d)
    kept = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert len(kept) == 2
    # a crashed partial write must be ignored
    os.makedirs(os.path.join(d, "step_00000099.tmp0"))
    assert latest_step(d) == 40


def _fault_run(tmp, device="cpu"):
    cfg = get_config("llama3.2-1b").reduced(**TINY)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device=device)
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=20)
    opt = init_opt_state(params, opt_cfg)
    step = build_train_step(cfg, opt_cfg)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)
    tr = Trainer(TrainerConfig(total_steps=20, ckpt_every=5, ckpt_dir=tmp,
                               log_every=5, data_timeout_s=DATA_TIMEOUT_S),
                 step, params, opt, data_cfg, device=device)
    return tr, tr.run(fail_at=12)


def test_trainer_fault_injection_resumes(tmp_path):
    """A step that raises resumes from the last checkpoint and completes;
    the checkpoint it leaves restores in the JAX package."""
    tr, state = _fault_run(str(tmp_path))
    assert state.restarts == 1
    assert state.step == 20
    assert latest_step(str(tmp_path)) == 20
    assert [h["step"] for h in tr.history] == [1, 5, 10, 15, 20]
    rcfg = r_config("llama3.2-1b").reduced(**TINY)
    rparams = R.init_params(rcfg, jax.random.PRNGKey(1))
    ropt_cfg = RAdamW(lr_peak=1e-3, warmup_steps=2, total_steps=20)
    back = r_restore(str(tmp_path), 20,
                     {"params": rparams, "opt": r_init_opt(rparams,
                                                           ropt_cfg)})
    assert int(back["opt"].step) == 20
    _close_trees(tr.params, back["params"], 0.0, "restored params")
    again = on_resize(str(tmp_path), {"params": tr.params,
                                      "opt": tr.opt_state})
    assert all(torch.equal(a.value, b.value) for a, b in
               zip(leaves(again), leaves({"params": tr.params,
                                          "opt": tr.opt_state})))


# ---------------------------------------------------------------------------
# the loss, its gradients and one step against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_reference(arch, dtype):
    rcfg, rparams, cfg, params = _reference(arch)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = TOL[dtype]
    batch = _batch(cfg)
    jbatch = jax.tree.map(jnp.asarray, batch)

    (rloss, raux), rgrads = _strict(jax.value_and_grad(
        lambda p, b: r_lm_loss(p, rcfg, b, compute_dtype=jdt),
        has_aux=True), dtype)(rparams, jbatch)
    loss, aux = lm_loss(params, cfg, batch, compute_dtype=tdt)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(aux["loss"]), float(raux["loss"]),
                               rtol=tol, atol=tol)

    mdt = (torch.float32, jnp.float32) if dtype == "float32" else \
        (torch.bfloat16, jnp.bfloat16)
    opt_cfg = AdamWConfig(lr_peak=1e-4, warmup_steps=2, total_steps=10,
                          moment_dtype=mdt[0])
    ropt_cfg = RAdamW(lr_peak=1e-4, warmup_steps=2, total_steps=10,
                      moment_dtype=mdt[1])
    seen = {}

    def capture(g):
        seen["grads"] = g
        return g
    new, opt, metrics = build_train_step(
        cfg, opt_cfg, compute_dtype=tdt, grad_transform=capture)(
        params, init_opt_state(params, opt_cfg), batch)
    _close_trees(seen["grads"], rgrads, tol, "grads")
    rnew, ropt, rmetrics = _strict(r_build(rcfg, ropt_cfg,
                                           compute_dtype=jdt), dtype)(
        rparams, r_init_opt(rparams, ropt_cfg), jbatch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), float(rmetrics[k]),
                                   rtol=tol, atol=tol, err_msg=k)
    assert int(opt.step) == int(ropt.step) == 1
    _close_trees(new, rnew, tol, "params")
    _close_trees(opt.m, ropt.m, tol, "m")
    _close_trees(opt.v, ropt.v, tol, "v")
    # the moments relative to their own scale (m about (1 - b1) g, v about
    # (1 - b2) g^2, both below the tolerance above)
    _close_by_norm(_port_np(opt.m), _ref_np(ropt.m), tol, "m")
    _close_by_norm(_port_np(opt.v), _ref_np(ropt.v), tol, "v")
    # the update itself: the first step at eps 1e-8 moves a leaf by about
    # lr sign(g), far below the tolerance and not smooth in g; at eps 1e-2
    # and a large lr it is about lr g / eps, so bias correction, decay
    # and the clip scale each show in it (each package's optimizer on its
    # own gradients)
    kw = dict(lr_peak=0.1, warmup_steps=2, total_steps=10, eps=1e-2)
    ocfg, rocfg = AdamWConfig(moment_dtype=mdt[0], **kw), \
        RAdamW(moment_dtype=mdt[1], **kw)
    new, opt, _ = adamw_update(params, seen["grads"],
                               init_opt_state(params, ocfg), ocfg)
    rnew, ropt, _ = jax.jit(r_adamw, static_argnums=3)(
        rparams, rgrads, r_init_opt(rparams, rocfg), rocfg)
    before, rbefore = _port_np(params), _ref_np(rparams)
    _close_by_norm({k: v - before[k] for k, v in _port_np(new).items()},
                   {k: v - rbefore[k] for k, v in _ref_np(rnew).items()},
                   tol, "update")
    _close_by_norm(_port_np(opt.v), _ref_np(ropt.v), tol, "v at eps 1e-2")
    # the arguments are left as they were
    _close_trees(params, rparams, 0.0, "params before")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-27b",
                                  "falcon-mamba-7b", "qwen2-moe-a2.7b"])
def test_prefill_and_decode_steps_match_reference(arch):
    """``build_prefill_step`` and ``build_decode_step`` against the JAX
    package's in float32: the prefill's logits and every cache leaf, then
    3 greedy decode steps, each package from its own cache: the tokens
    equal, the logits and the cache within the tolerance."""
    rcfg, rparams, cfg, params = _reference(arch)
    tol = TOL["float32"]
    batch = {"inputs": _batch(cfg, s=12)["inputs"]}
    prefill_step = build_prefill_step(cfg, smax=16,
                                      compute_dtype=torch.float32)
    rprefill = jax.jit(r_build_prefill(rcfg, smax=16,
                                       compute_dtype=jnp.float32))
    logits, cache = prefill_step(params, batch)
    rlogits, rcache = rprefill(rparams, jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(logits.float().numpy(), np.asarray(rlogits),
                               rtol=tol, atol=tol, err_msg="prefill")

    def same_cache(what):
        got = cache_to_numpy(cache)
        assert sorted(got) == sorted(rcache), what
        for k in rcache:
            np.testing.assert_allclose(
                np.asarray(got[k], np.float32),
                np.asarray(rcache[k], np.float32), rtol=tol, atol=tol,
                err_msg=f"{what} cache {k}")
    same_cache("prefill")
    decode_step = build_decode_step(cfg, compute_dtype=torch.float32)
    rdecode = jax.jit(r_build_decode(rcfg, compute_dtype=jnp.float32))
    tok = torch.argmax(logits.reshape(logits.shape[0], -1, cfg.vocab)[:, -1],
                       dim=-1).to(torch.int32)
    rtok = jnp.asarray(tok.numpy())
    for i in range(3):
        tok, logits, cache = decode_step(params, tok, cache)
        rtok, rlogits, rcache = rdecode(rparams, rtok, rcache)
        assert tok.dtype == torch.int32
        np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))
        np.testing.assert_allclose(logits.float().numpy(),
                                   np.asarray(rlogits), rtol=tol, atol=tol,
                                   err_msg=f"decode {i}")
    same_cache("decoded")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "llama-3.2-vision-90b",
                                  "qwen2-moe-a2.7b"])
def test_opt_state_shapes_equal_reference(arch):
    """``opt_state_shapes`` over ``param_shapes`` names the JAX package's
    leaves with its shapes and the moment dtype, and sizes what
    ``init_opt_state`` makes (layers stacked)."""
    rcfg, rparams, cfg, params = _reference(arch)
    got = opt_state_shapes(param_shapes(cfg), AdamWConfig())
    want = r_opt_shapes(r_param_shapes(rcfg), RAdamW())
    assert got.step == ((), torch.int32)
    assert want.step.shape == () and want.step.dtype == jnp.int32
    made = init_opt_state(params, AdamWConfig())
    for what in ("m", "v"):
        flat = {"__".join(_key(p) for p in path): x for path, x in
                jax.tree_util.tree_flatten_with_path(
                    getattr(want, what))[0]}
        mine = {"__".join(_key(p) for p in path): x for path, x in
                jax.tree_util.tree_flatten_with_path(
                    getattr(got, what),
                    is_leaf=lambda x: isinstance(x, tuple))[0]}
        assert sorted(mine) == sorted(flat), what
        for k, (shape, dtype) in mine.items():
            assert shape == flat[k].shape and dtype == torch.bfloat16, k
            assert flat[k].dtype == jnp.bfloat16, k
        sized = _port_np(getattr(made, what))
        assert {k: v.shape for k, v in sized.items()} == \
            {k: shape for k, (shape, _) in mine.items()}, what


def test_weight_decay_follows_stacked_rank():
    """With zero gradients the update is the decay alone: every leaf the
    JAX package holds at rank >= 2 decays (each layer's norm weights
    included, stacked (L, d)), the top-level ``final_norm`` and a cross
    layer's stacked scalar gates (L,) do not."""
    rcfg, rparams, cfg, params = _reference("llama-3.2-vision-90b")
    rparams = jax.tree.map(lambda a: a + 1.0, rparams)
    params = params_from_reference(
        cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    opt_cfg = AdamWConfig(lr_peak=0.1, warmup_steps=1, total_steps=10)
    ropt_cfg = RAdamW(lr_peak=0.1, warmup_steps=1, total_steps=10)
    grads = jax.tree.map(jnp.zeros_like, rparams)
    new, _, _ = adamw_update(
        params, params_from_reference(cfg, jax.tree.map(np.asarray, grads),
                                      device="cpu"),
        init_opt_state(params, opt_cfg), opt_cfg)
    rnew, _, _ = jax.jit(r_adamw, static_argnums=3)(
        rparams, grads, r_init_opt(rparams, ropt_cfg), ropt_cfg)
    got, want = _port_np(new), _ref_np(rnew)
    before = _ref_np(rparams)
    decayed = {k for k in want if not np.array_equal(want[k], before[k])}
    assert {k for k in got if not np.array_equal(got[k], before[k])} == \
        decayed
    assert "layers__ln1" in decayed and "cross_layers__ln1" in decayed
    assert "final_norm" not in decayed
    assert not {"cross_layers__gate_attn", "cross_layers__gate_mlp"} & \
        decayed
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "llama-3.2-vision-90b",
                                  "qwen2-moe-a2.7b"])
def test_checkpoint_crosses_between_packages(arch, tmp_path):
    rcfg, rparams, cfg, params = _reference(arch)
    ropt_cfg = RAdamW()
    ropt = r_init_opt(rparams, ropt_cfg)
    ropt = ROptState(jnp.asarray(3, jnp.int32),
                     jax.tree.map(lambda a: (a * 0.5).astype(jnp.bfloat16),
                                  rparams),
                     jax.tree.map(lambda a: (a * a).astype(jnp.bfloat16),
                                  rparams))
    opt = opt_state_from_reference(cfg, jax.tree.map(np.asarray, ropt),
                                   device="cpu")
    like = {"params": init_params(cfg, torch.Generator().manual_seed(5),
                                  device="cpu"),
            "opt": init_opt_state(params, AdamWConfig())}
    # JAX writes, the port reads
    r_save(str(tmp_path / "r"), 3, {"params": rparams, "opt": ropt})
    got = restore_checkpoint(str(tmp_path / "r"), 3, like)
    _close_trees(got["params"], rparams, 0.0, "params")
    _close_trees(got["opt"].m, ropt.m, 0.0, "m")
    assert int(got["opt"].step) == 3
    assert [leaf.value.dtype for leaf in leaves(got)] == \
        [leaf.value.dtype for leaf in leaves(like)]
    # the port writes, JAX reads; the manifests name the same leaves
    save_checkpoint(str(tmp_path / "t"), 3, {"params": params, "opt": opt})
    rlike = {"params": jax.tree.map(jnp.zeros_like, rparams),
             "opt": r_init_opt(rparams, ropt_cfg)}
    back = r_restore(str(tmp_path / "t"), 3, rlike)
    _close_trees(params, back["params"], 0.0, "params")
    _close_trees(opt.v, back["opt"].v, 0.0, "v")
    assert back["opt"].v["embed"].dtype == jnp.bfloat16
    man = [json.load(open(tmp_path / d / "step_00000003" / "manifest.json"))
           for d in ("r", "t")]
    assert [sorted((m["name"], tuple(m["shape"]), m["dtype"])
                   for m in x["leaves"]) for x in man][0] == \
        sorted((m["name"], tuple(m["shape"]), m["dtype"])
               for m in man[1]["leaves"])


@pytest.mark.parametrize("arch", list_archs())
def test_train_step_runs_and_updates(arch):
    """Twin of ``test_arch_smoke.py::test_train_step_runs_and_updates``
    for all ten configurations at ``.reduced()``."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    opt = init_opt_state(params, opt_cfg)
    new, new_opt, metrics = build_train_step(cfg, opt_cfg)(
        params, opt, _batch(cfg))
    assert bool(torch.isfinite(metrics["loss"]))
    assert int(new_opt.step) == 1
    diffs = [float((a.value.float() - b.value.float()).abs().max())
             for a, b in zip(leaves(params), leaves(new))]
    assert max(diffs) > 0.0


# ---------------------------------------------------------------------------
# K6 and K7 under autograd, with the launch swapped for the plain version
# ---------------------------------------------------------------------------

def _fake_launch(monkeypatch, module, plain):
    calls = []

    def launch(*args, **kw):
        calls.append(torch.is_grad_enabled())
        with torch.no_grad():
            return plain(*args, **kw)
    monkeypatch.setattr(module, "_launch", launch)
    return calls


def test_k6_function_backward_is_plain_gradient(monkeypatch):
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    calls = _fake_launch(monkeypatch, fa, attention_plain)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, h, 37, 16, generator=g, dtype=torch.float64)
               for h in (4, 2, 2))
    kw = dict(causal=True, window=9, softcap=20.0, scale=0.3)
    want = [t.clone().requires_grad_() for t in (q, k, v)]
    attention_plain(*want, **kw).pow(2).sum().backward()
    got = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa._FlashAttention.apply(*got, kw)
    out.pow(2).sum().backward()
    assert calls == [False]                  # one launch, in the forward
    for a, b in zip(got, want):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-12, atol=1e-12)


def test_k7_function_backward_is_plain_gradient(monkeypatch):
    ms = importlib.import_module("repro_torch.kernels.mamba_scan")

    def plain(a, bx, c, h0, return_state):
        return mamba_scan_plain(a, bx, c, h0=h0, return_state=return_state)
    calls = _fake_launch(monkeypatch, ms, plain)
    g = torch.Generator().manual_seed(0)
    a = torch.rand(2, 13, 3, 4, generator=g, dtype=torch.float64)
    bx = torch.randn(2, 13, 3, 4, generator=g, dtype=torch.float64)
    c = torch.randn(2, 13, 4, generator=g, dtype=torch.float64)
    h0 = torch.randn(2, 3, 4, generator=g, dtype=torch.float64)
    for with_h0 in (False, True):
        for state in (False, True):
            ins = [a, bx, c] + ([h0] if with_h0 else [])
            want = [t.clone().requires_grad_() for t in ins]
            got = [t.clone().requires_grad_() for t in ins]
            ow = mamba_scan_plain(*want[:3], h0=want[3] if with_h0 else None,
                                  return_state=state)
            og = ms._MambaScan.apply(*got[:3], got[3] if with_h0 else None,
                                     state)
            loss = lambda o: (o[0].sum() + o[1].pow(2).sum()) if state \
                else o.pow(2).sum()
            loss(ow).backward()
            loss(og).backward()
            for x, y in zip(got, want):
                torch.testing.assert_close(x.grad, y.grad, rtol=1e-12,
                                           atol=1e-12)
    assert calls == [False] * 4


def test_serving_launch_skips_the_autograd_function(monkeypatch):
    """With no operand requiring a gradient, or under ``no_grad``, the
    wrappers launch the bare kernel: what serving launched before."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    ms = importlib.import_module("repro_torch.kernels.mamba_scan")
    for mod, fn in ((fa, fa._FlashAttention), (ms, ms._MambaScan)):
        monkeypatch.setattr(mod, "_launch", lambda *a, **k: "bare")
        monkeypatch.setattr(fn, "apply", lambda *a: "function")
    q = torch.randn(1, 2, 8, 8)
    kw = dict(causal=True, window=0, softcap=0.0, scale=0.5)
    a = torch.rand(1, 4, 2, 3)
    c = torch.rand(1, 4, 3)
    assert fa._dispatch(q, q, q, kw) == "bare"
    assert ms._dispatch(a, a, c, None, False) == "bare"
    with torch.no_grad():
        assert fa._dispatch(q, q, q.clone().requires_grad_(), kw) == "bare"
        assert ms._dispatch(a, a, c.clone().requires_grad_(), None,
                            True) == "bare"
    assert fa._dispatch(q, q.clone().requires_grad_(), q, kw) == "function"
    assert ms._dispatch(a, a, c, torch.zeros(1, 2, 3, requires_grad=True),
                        False) == "function"


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_runs_on_the_cpu(tmp_path):
    ck = str(tmp_path / "ck")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
           "--n-layers", "1", "--d-model", "32", "--d-ff", "64", "--vocab",
           "64", "--steps", "6", "--batch", "2", "--seq", "16",
           "--ckpt-every", "4", "--fail-at", "5", "--ckpt-dir", ck,
           "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("arch=llama3.2-1b params=")
    summary = json.loads(out.stdout[out.stdout.index("{"):])
    assert summary["steps"] == 6 and summary["restarts"] == 1
    assert [h["step"] for h in summary["history"]] == [1]
    assert sorted(summary) == ["history", "restarts", "steps", "stragglers",
                               "wall_s"]
    assert latest_step(ck) == 6


def test_launcher_needs_a_card_by_default(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert launch_train.main(["--reduced", "--steps", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    args = launch_train.parser().parse_args([])
    assert (args.arch, args.d_model, args.n_layers, args.d_ff, args.vocab,
            args.steps, args.batch, args.seq, args.lr, args.microbatches,
            args.ckpt_every, args.fail_at, args.seed) == \
        ("llama3.2-1b", 256, 4, 512, 512, 100, 8, 128, 1e-3, 1, 50, None, 0)
