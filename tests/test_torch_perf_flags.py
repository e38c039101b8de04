"""The port's perf flags (``repro_torch.models.perf_flags``) and the
variants they select, against the JAX package's under the same flags, on
the CPU, on inputs made from a seed with numpy; and the ``shard``
callback (``sharding.specs.activation_shard_fn``) on a 4-rank gloo mesh.

Tolerances: rtol = atol = 1e-4 in float32 and 2e-2 in bfloat16, the
bfloat16 reference compiled with ``xla_allow_excess_precision`` off
(``tests/test_torch_lm_model.py`` says why).  Every flag is set through
the ``flags`` fixture, which resets both packages' flags when the test
ends, so none leaks into a later test on the same worker.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm_model as lm
import test_torch_ssm as ssm_tests
from torch_ranks import dtensor_forward_rank, run_ranks

from repro.models import layers as rl
from repro.models import perf_flags as rpf
from repro.models.ssm import mamba_mixer as r_mixer
from repro.train.steps import lm_loss as r_lm_loss
from repro_torch.configs import get_config
from repro_torch.kernels import mamba_scan
from repro_torch.models import forward, init_params
from repro_torch.models import layers as tl
from repro_torch.models import perf_flags as tpf
from repro_torch.models.ssm import mamba_mixer
from repro_torch.train import build_train_step, lm_loss
from repro_torch.train.optimizer import AdamWConfig, init_opt_state

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
STRICT = {"xla_allow_excess_precision": False}


@pytest.fixture
def flags():
    """Sets perf flags in both packages; resets both when the test ends."""
    def set_both(**kw):
        rpf.set_flags(**kw)
        tpf.set_flags(**kw)
    try:
        yield set_both
    finally:
        rpf.reset_flags()
        tpf.reset_flags()
        tpf.set_mesh(None, ())


def _strict(fn, dtype):
    return jax.jit(fn, compiler_options=STRICT) if dtype == "bfloat16" \
        else jax.jit(fn)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _np(t):
    return t.detach().float().numpy()


def test_perf_flags_equal_reference(flags):
    want, got = rpf.PerfFlags(), tpf.PerfFlags()
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tpf.get_flags() == got and tpf.get_mesh() is None
    flags(ssm_impl="streamed", ce_chunk=7)
    assert tpf.get_flags().ssm_impl == "streamed"
    assert dataclasses.asdict(tpf.get_flags()) == \
        dataclasses.asdict(rpf.get_flags())
    assert tpf.reset_flags() == tpf.PerfFlags()
    tpf.set_mesh("mesh", ["data"])
    assert tpf.get_mesh() == ("mesh", ("data",))


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_bf16(flags, plus_one):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 64)).astype(np.float32)
    w = (0.1 * rng.normal(size=(64,))).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    default = tl.rms_norm(tx, torch.from_numpy(w), 1e-6, plus_one=plus_one)
    flags(norm_dtype="bf16")
    want = _strict(lambda a, b: rl.rms_norm(a, b, 1e-6, plus_one=plus_one),
                   "bfloat16")(xb, jnp.asarray(w))
    got = tl.rms_norm(tx, torch.from_numpy(w), 1e-6, plus_one=plus_one)
    assert got.dtype == torch.bfloat16
    _close(_np(got), want, TOL["bfloat16"])
    # the flag chose the other arithmetic: its bits differ from the default
    assert not torch.equal(got, default)
    # float32 inputs take the float32 path under the flag too
    x32 = torch.from_numpy(x)
    assert torch.equal(tl.rms_norm(x32, torch.from_numpy(w)),
                       _reset_then(lambda: tl.rms_norm(
                           x32, torch.from_numpy(w))))


def _reset_then(fn):
    saved = tpf.get_flags()
    tpf.reset_flags()
    try:
        return fn()
    finally:
        tpf.set_flags(**dataclasses.asdict(saved))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8),
                                           (False, None), (False, 6)])
def test_blockwise_attention_qouter(causal, window):
    """37 queries in tiles of 16: the last tile ragged (5 queries, 11 pad
    rows at position 2**30), kv chunks of 8 (the last ragged too)."""
    rng = np.random.default_rng(1)
    b, s, hq, hkv, d = 2, 37, 4, 2, 16
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    kw = dict(causal=causal, window=window, q_chunk=16, kv_chunk=8)
    want = rl.blockwise_attention_qouter(
        *map(jnp.asarray, (q, k, v)), q_pos=jnp.asarray(pos),
        kv_pos=jnp.asarray(pos), **kw)
    tq, tk, tv, tp = map(torch.from_numpy, (q, k, v, pos))
    got = tl.blockwise_attention_qouter(tq, tk, tv, q_pos=tp, kv_pos=tp,
                                        **kw)
    assert got.shape == (b, s, hq, d)
    _close(_np(got), want, TOL["float32"])
    # the same function as the kv-outer loop
    _close(_np(got), _np(tl.blockwise_attention(
        tq, tk, tv, q_pos=tp, kv_pos=tp, causal=causal, window=window,
        chunk=8)), 1e-5)


def _mixer_case(dtype, s=13, b=2):
    p = ssm_tests._mixer_params()
    x = np.random.default_rng(2).normal(
        size=(b, s, ssm_tests.D_MODEL)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    if dtype == "bfloat16":
        jp = {k: v if k in ("A_log", "D") else v.astype(jdt)
              for k, v in jp.items()}
        tp = {k: v if k in ("A_log", "D") else v.to(tdt)
              for k, v in tp.items()}
    return jnp.asarray(x, jdt), jp, torch.from_numpy(x).to(tdt), tp


@pytest.mark.parametrize("state", [None, "carried"])
@pytest.mark.parametrize("impl,state_dtype,dtype", [
    ("streamed", "f32", "float32"), ("streamed", "f32", "bfloat16"),
    ("streamed", "bf16", "float32"), ("streamed", "bf16", "bfloat16"),
    ("sequential", "f32", "float32"), ("sequential", "f32", "bfloat16")])
def test_scan_variants(flags, impl, state_dtype, dtype, state):
    """``mamba_mixer``'s prefill under ``ssm_impl``: 13 steps in chunks
    of 5 (the last ragged), from no state or a carried one; the output
    and the last state against the JAX package's same variant."""
    flags(ssm_impl=impl, ssm_chunk=5, ssm_state_dtype=state_dtype)
    jx, jp, tx, tp = _mixer_case(dtype)
    st = ssm_tests._state(2) if state else None
    jst = None if st is None else {k: jnp.asarray(v, jx.dtype if k ==
                                                  "conv" else jnp.float32)
                                   for k, v in st.items()}
    tst = None if st is None else {k: torch.from_numpy(v).to(
        tx.dtype if k == "conv" else torch.float32) for k, v in st.items()}
    want, wst = _strict(lambda x, p, s0: r_mixer(
        x, p, ssm_tests.SSM, state=s0, return_state=True), dtype)(
        jx, jp, jst)
    mamba_scan.launches = 0
    got, gst = mamba_mixer(tx, tp, ssm_tests.SSM, state=tst,
                           return_state=True)
    # a bfloat16 state is a bfloat16 computation, whatever the activations'
    # dtype: the JAX package combines it in a bfloat16 associative scan,
    # the port rounds da/dbx to bfloat16 and scans them in float32 on K7
    tol = TOL["bfloat16" if "bf16" in (state_dtype,) else dtype]
    _close(_np(got), want, tol, "out")
    _close(_np(gst["h"]), wst["h"], tol, "h")


def test_streamed_runs_k7_a_chunk(flags, monkeypatch):
    """The streamed variant calls the selective-scan wrapper once a
    chunk, on (B, chunk, D, N) operands, the state carried from one
    chunk's last state to the next one's first; the materialized one
    once, on (B, S, D, N)."""
    from repro_torch.models import ssm as tssm
    calls = []
    real = tssm.mamba_scan

    def spy(a, bx, c, **kw):
        calls.append((tuple(a.shape), kw.get("h0") is not None))
        return real(a, bx, c, **kw)
    monkeypatch.setattr(tssm, "mamba_scan", spy)
    _, _, tx, tp = _mixer_case("float32")
    want = mamba_mixer(tx, tp, ssm_tests.SSM)
    assert calls == [((2, 13, 64, 8), False)]
    calls.clear()
    flags(ssm_impl="streamed", ssm_chunk=5)
    got = mamba_mixer(tx, tp, ssm_tests.SSM)
    assert calls == [((2, 5, 64, 8), False), ((2, 5, 64, 8), True),
                     ((2, 3, 64, 8), True)]
    _close(_np(got), _np(want), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-27b"])
def test_lm_loss_chunked(flags, arch, dtype):
    """``ce_impl="chunked"`` with ce_chunk 4 over 11 predicted positions
    (the last chunk has 1 pad row): the loss, the cross entropy and every
    gradient against the JAX package's chunked loss; and the same values
    as the port's full loss."""
    import test_torch_train as tt
    rcfg, rparams, cfg, params = tt._reference(arch)
    batch = tt._batch(cfg, s=12)
    jbatch = jax.tree.map(jnp.asarray, batch)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = TOL[dtype]
    full = lm_loss(params, cfg, batch, compute_dtype=tdt)
    flags(ce_impl="chunked", ce_chunk=4)
    (rloss, raux), rgrads = _strict(jax.value_and_grad(
        lambda p, b: r_lm_loss(p, rcfg, b, compute_dtype=jdt),
        has_aux=True), dtype)(rparams, jbatch)
    loss, aux = lm_loss(params, cfg, batch, compute_dtype=tdt)
    _close(float(loss), float(rloss), tol, "loss")
    _close(float(aux["loss"]), float(raux["loss"]), tol, "ce")
    _close(float(loss), float(full[0]), 1e-5 if dtype == "float32" else tol,
           "chunked against full")
    seen = {}

    def capture(g):
        seen["g"] = g
        return g
    opt_cfg = AdamWConfig()
    build_train_step(cfg, opt_cfg, compute_dtype=tdt, grad_transform=capture)(
        params, init_opt_state(params, opt_cfg), batch)
    tt._close_trees(seen["g"], rgrads, tol, "grads")


# ---------------------------------------------------------------------------
# the model entry points under non-default flags
# ---------------------------------------------------------------------------

NON_DEFAULT = dict(attention_impl="q_outer", attn_q_chunk=4, attn_kv_chunk=4,
                   ssm_impl="streamed", ssm_chunk=3, norm_dtype="bf16",
                   moe_combine="sharded", ce_impl="chunked", ce_chunk=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-27b",
                                  "falcon-mamba-7b", "hymba-1.5b",
                                  "qwen2-moe-a2.7b",
                                  "llama-3.2-vision-90b"])
def test_entry_points_under_flags(flags, arch, dtype):
    """``forward``, ``prefill`` (logits and every cache leaf) and 4
    teacher-forced ``decode_step``s of the attn, mamba and hymba mixers,
    the MoE MLP and cross-attention, with every flag off its default
    (``test_torch_lm_model.test_matches_reference`` under them): q-outer
    attention in tiles of 4 (the JAX package's prefill over its cache and
    the port's cross-attention take it; the port's prefill stays on K6),
    the streamed scan in chunks of 3, the bfloat16 norm."""
    flags(**NON_DEFAULT)
    lm.test_matches_reference(arch, dtype)


def test_moe_shard_map_flag(flags, tmp_path):
    """``moe_impl="shard_map"`` with a registered one-rank mesh: an MoE
    layer's MLP is ``moe_mlp_shardmap`` (its capacity over the flattened
    batch), equal to ``moe_mlp`` where neither drops (capacity factor 8);
    without a mesh the flag changes nothing."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import transformer as tt
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    params = init_params(cfg, torch.Generator().manual_seed(3),
                         device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 8))
    want = forward(params, cfg, toks, compute_dtype=torch.float32)
    flags(moe_impl="shard_map")
    assert torch.equal(forward(params, cfg, toks,
                               compute_dtype=torch.float32), want)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        tpf.set_mesh(mesh, ("data",))
        calls = []
        real = tt.moe_mlp_shardmap

        def spy(*a, **kw):
            calls.append(a[3:])
            return real(*a, **kw)
        tt.moe_mlp_shardmap = spy
        try:
            got = forward(params, cfg, toks, compute_dtype=torch.float32)
        finally:
            tt.moe_mlp_shardmap = real
    finally:
        dist.destroy_process_group()
    assert calls == [(mesh, ("data",))] * cfg.n_layers
    _close(_np(got), _np(want), 1e-5)


# ---------------------------------------------------------------------------
# the shard callback on DTensors over 4 gloo ranks
# ---------------------------------------------------------------------------

def test_shard_callback_placements(flags):
    """``activation_shard_fn``'s table on a fake (2, 2) mesh: the
    residual stream batch over ``data`` (its sequence over ``model`` with
    ``seq_shard``, unless it does not divide, as a decode step's one
    position), the logits' vocab over ``model``, the port's (E, B*C, d)
    MoE buffers; plain tensors and unknown names returned as they are."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.sharding import activation_shard_fn
    cfg = get_config("llama3.2-1b").reduced(vocab=64)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))

        def placed(shard, shape, name):
            x = distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                  [Replicate(), Replicate()])
            return tuple(shard(x, name).placements)
        shard = activation_shard_fn(mesh, cfg, multi_pod=False)
        plain = torch.zeros(2)
        assert shard(plain, "hidden") is plain
        assert placed(shard, (4, 8, 16), "hidden") == (Shard(0), Replicate())
        assert placed(shard, (4, 8, 64), "logits") == (Shard(0), Shard(2))
        assert placed(shard, (8, 12, 16), "moe_buf") == (Shard(1),
                                                         Replicate())
        assert placed(shard, (8, 12, 32), "moe_h") == (Shard(1), Shard(0))
        assert placed(shard, (4, 8, 16), "other") == (Replicate(),) * 2
        flags(seq_shard=True)
        shard = activation_shard_fn(mesh, cfg, multi_pod=False)
        assert placed(shard, (4, 8, 16), "hidden") == (Shard(0), Shard(1))
        assert placed(shard, (4, 1, 16), "hidden") == (Shard(0), Replicate())
    finally:
        dist.destroy_process_group()


DIST_WIDTHS = {"llama3.2-1b": dict(n_layers=2, d_model=32, d_ff=64,
                                   vocab=64),
               "qwen2-moe-a2.7b": dict(n_layers=2, d_model=32, vocab=64),
               "falcon-mamba-7b": dict(n_layers=2, d_model=32, vocab=64)}


@pytest.mark.parametrize("arch", sorted(DIST_WIDTHS))
def test_shard_callback_dtensor_forward(arch, tmp_path):
    """A reduced Llama's (an MoE model's: the dispatch and combine a batch
    shard a rank, the experts' products on the placed buffers; a Mamba
    model's: the scan a channel shard a rank) forward with DTensor params
    on a (2, 2) mesh and the ``shard`` callback, ``seq_shard`` off and
    on, on each of 4 gloo ranks, against the one-rank forward within
    1e-5; the residual stream placed as the callback's spec says (batch
    over ``data``; with ``seq_shard`` its sequence over ``model``); the
    loss and every gradient of the one-rank step within 1e-5 too (the
    callback constrains the cotangents as it constrains the values)."""
    from repro_torch.train.steps import _grad_leaves
    cfg = get_config(arch).reduced(**DIST_WIDTHS[arch])
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (4, 8)
                                             ).astype(np.int64)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    want = forward(params, cfg, toks, compute_dtype=torch.float32)
    leafy, inputs = _grad_leaves(params)
    with torch.enable_grad():
        loss, _ = lm_loss(leafy, cfg, {"inputs": toks, "targets": toks},
                          compute_dtype=torch.float32)
        grads = torch.autograd.grad(loss, inputs)
    seq_shards = (False, True)
    got = run_ranks(dtensor_forward_rank, 4, tmp_path, arch,
                    DIST_WIDTHS[arch], toks, (2, 2), seq_shards)
    for ranks in got:
        assert len(ranks) == len(seq_shards)
        for seq_shard, r in zip(seq_shards, ranks):
            hidden = [("Shard", 0), ("Shard", 1) if seq_shard else
                      ("Replicate", None)]
            _close(_np(r["logits"]), _np(want), 1e-5, "logits")
            assert r["hidden"] == [hidden] * (1 + 2 * cfg.n_layers)
            _close(float(r["loss"]), float(loss.detach()), 1e-5, "loss")
            assert len(r["grads"]) == len(grads)
            for g, w in zip(r["grads"], grads):
                _close(_np(g), _np(w), 1e-5, "grad")


# ---------------------------------------------------------------------------
# rehearsals of chip_smoke.py's new checks on the CPU
# ---------------------------------------------------------------------------

#: reduced widths for the rehearsals (the configurations' names kept)
SMOKE_WIDTHS = {"llama3.2-1b": dict(n_layers=2, d_model=64, d_ff=128,
                                    vocab=256),
                "qwen2-moe-a2.7b": dict(n_layers=2, d_model=64, vocab=256)}


def _smoke(monkeypatch):
    from pathlib import Path
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    import repro_torch.configs as configs
    from repro_torch.models import transformer
    from repro_torch.kernels import flash_attention
    real_config, real_attention = configs.get_config, transformer.attention
    monkeypatch.setattr(configs, "get_config", lambda a: real_config(
        a).reduced(**SMOKE_WIDTHS[a]) if a in SMOKE_WIDTHS else
        real_config(a))
    monkeypatch.setattr(cs, "TR_SEQ", 64)

    def counted(*a, **kw):
        flash_attention.launches += 1
        return real_attention(*a, **kw)
    monkeypatch.setattr(transformer, "attention", counted)
    return cs


def test_chip_smoke_shard_flags_check_on_the_cpu(monkeypatch):
    """``chip_smoke.shard_flags_check`` (phase 16 (f), (g)) on the CPU at
    reduced widths over a one-rank gloo group: the shard_map flag
    bit-equal to the direct call, the forward with DTensor params and the
    callback bit-equal to the plain one, K6's plain version counted once
    a layer."""
    import torch.distributed as dist
    cs = _smoke(monkeypatch)
    assert cs.shard_flags_check(torch.device("cpu"), "cpu") == {
        "dist_shard_launches": 2}
    assert not dist.is_initialized()
    assert tpf.get_flags() == tpf.PerfFlags() and tpf.get_mesh() is None


def test_chip_smoke_roofline_phase_on_the_cpu(monkeypatch):
    """``chip_smoke.roofline_phase`` (phase 17) on the CPU: phase 15's
    step counted on meta tensors (reduced here, 8 x 64 tokens), the
    dry-run cell and a Mamba cell through ``mamba_cells_check`` (its
    conv a shard a rank); the MFU from a made-up step time."""
    cs = _smoke(monkeypatch)
    monkeypatch.setattr(cs, "RF_CELL", ("llama3.2-1b", "decode_32k"))
    monkeypatch.setattr(cs, "RF_MAMBA_CELLS",
                        (("falcon-mamba-7b", "decode_32k"),))
    out = cs.roofline_phase("cpu", 100.0)
    assert list(out["mamba_cells_s"]) == ["falcon-mamba-7b/decode_32k"]
    assert out["roofline_flops"] > out["model_flops"] > 0
    assert out["mfu"] == out["model_flops"] / (0.1 * 989e12)
