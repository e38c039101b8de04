"""The port's LM substrate (``repro_torch.configs``, ``repro_torch.models``)
against the JAX package's on the CPU, on the same parameters and inputs.

Parameters come from the JAX package's ``init_params`` and cross over
through ``params_from_reference``; caches through ``cache_from_reference``
and ``cache_to_numpy``.  Tolerances: rtol = atol = 1e-4 in float32 and
2e-2 in bfloat16 (the JAX package's ``test_decode_matches_teacher_forcing``
tolerance).

In bfloat16 the reference is the JAX function compiled with XLA's
``xla_allow_excess_precision`` off.  By default XLA's CPU compiler drops
every float32 -> bfloat16 -> float32 round trip (``SimplifyFPConversions``),
so a "bfloat16" program keeps most of its intermediates, and even the
weights cast to bfloat16, in float32; that default differs from the same
program compiled strictly by up to 1.65 times the tolerance
(``test_reference_bf16_depends_on_excess_precision``).  The port rounds
where the program says bfloat16, as the card does.

Self-attention in ``forward`` and ``prefill`` runs through the
flash-attention wrapper (K6's plain version on CPU tensors); the JAX
package computes it with ``blockwise_attention`` over the ``smax`` cache.
``test_prefill_k6_equals_blockwise_over_cache`` holds each such call to
the port's ``blockwise_attention`` over the cache with the JAX package's
masks, layer by layer.  The Mamba mixer's prefill scan runs through the
selective-scan wrapper (K7's plain version on CPU tensors), once a mixer
layer (``test_k7_once_a_mixer_layer_outside_decode``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_config as r_config
from repro.configs import list_archs as r_archs
from repro.models.model import cache_shapes as r_cache_shapes
from repro.models.transformer import param_shapes as r_param_shapes
from repro_torch import models as T
from repro_torch.configs import get_config, list_archs
from repro_torch.models import transformer as tt
from repro_torch.models.layers import FAR, blockwise_attention

#: the architectures the port runs: all ten (attn-only, MoE, mamba and
#: hymba)
ARCHS = ["llama3.2-1b", "deepseek-coder-33b", "gemma2-27b", "gemma3-27b",
         "musicgen-large", "llama-3.2-vision-90b", "falcon-mamba-7b",
         "hymba-1.5b", "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: prompt, teacher-forced decode steps, cache length
S, STEPS, SMAX = 8, 4, 16
STRICT = {"xla_allow_excess_precision": False}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    cfg = r_config(arch).reduced()
    params = R.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, jax.tree.map(np.asarray, params)


def _inputs(cfg, b=2, s=S + STEPS, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        toks = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    else:
        toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    enc = (rng.normal(size=(b, cfg.encoder_len, cfg.d_model))
           .astype(np.float32) if cfg.n_cross_layers else None)
    return toks, enc


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _np(t):
    return t.detach().float().numpy()


def _dtypes(cache):
    """``{leaf: dtype name}`` of a port's (torch) or the JAX package's
    (numpy or jax) cache."""
    return {k: str(v.dtype).replace("torch.", "") for k, v in cache.items()}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", r_archs())
def test_config_equals_reference(arch, reduced):
    assert list_archs() == r_archs()
    want, got = r_config(arch), get_config(arch)
    if reduced:
        want, got = want.reduced(), got.reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.layer_kinds() == want.layer_kinds()
    assert (got.head_dim_of, got.n_self_layers, got.n_cross_layers,
            got.supports_long_context) == \
        (want.head_dim_of, want.n_self_layers, want.n_cross_layers,
         want.supports_long_context)


@pytest.mark.parametrize("arch", r_archs())
def test_shapes_equal_reference(arch):
    for cfg_r, cfg_t in ((r_config(arch), get_config(arch)),
                         (r_config(arch).reduced(),
                          get_config(arch).reduced())):
        want = jax.tree.map(lambda s: tuple(s.shape), r_param_shapes(cfg_r))
        assert T.param_shapes(cfg_t) == want
        for dt_r, dt_t in ((jnp.bfloat16, torch.bfloat16),
                           (jnp.float32, torch.float32)):
            want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
                    r_cache_shapes(cfg_r, 2, 24, dt_r).items()}
            got = {k: (s, str(d).replace("torch.", "")) for k, (s, d) in
                   T.cache_shapes(cfg_t, 2, 24, dt_t).items()}
            assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_round_trips(arch):
    _, _, tree = _reference(arch)
    cfg = get_config(arch).reduced()
    for src in (tree, jax.tree.map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)):
        p = T.params_from_reference(cfg, src, device="cpu")
        back = {"embed": p.embed, "final_norm": p.final_norm,
                "layers": {k: torch.stack([lp[k] for lp in p.layers])
                           for k in p.layers[0].keys()}}
        if len(p.cross_layers):
            back["cross_layers"] = {
                k: torch.stack([lp[k] for lp in p.cross_layers])
                for k in p.cross_layers[0].keys()}
        if p.lm_head is not None:
            back["lm_head"] = p.lm_head
        flat_w = jax.tree_util.tree_flatten_with_path(src)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_g) == len(flat_w)
        for path, a in flat_w:
            t = flat_g[path]
            assert str(t.dtype).replace("torch.", "") == str(a.dtype)
            assert np.array_equal(t.float().numpy(),
                                  np.asarray(a, np.float32)), path


def _strict(fn, dtype):
    return jax.jit(fn, compiler_options=STRICT) if dtype == "bfloat16" \
        else jax.jit(fn)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_matches_reference(arch, dtype):
    """forward, prefill (logits and every cache leaf, its dtype included)
    and 4 teacher-forced decode steps from the JAX package's own cache
    (the cache's leaves and dtypes after them too)."""
    rcfg, params, tree = _reference(arch)
    cfg = get_config(arch).reduced()
    tol = TOL[dtype]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tp = T.params_from_reference(cfg, tree, device="cpu")
    toks, enc = _inputs(cfg)
    je = None if enc is None else jnp.asarray(enc)

    want = _strict(lambda p, t, e: R.forward(p, rcfg, t, enc=e,
                                             compute_dtype=jdt), dtype)(
        params, jnp.asarray(toks), je)
    got = T.forward(tp, cfg, toks, enc=enc, compute_dtype=tdt)
    assert got.dtype == (torch.float32 if cfg.final_softcap else tdt)
    _close(_np(got), want, tol, "forward")

    jl, jc = _strict(lambda p, t, e: R.prefill(
        p, rcfg, t, smax=SMAX, enc=e, compute_dtype=jdt), dtype)(
        params, jnp.asarray(toks[:, :S]), je)
    tl, tc = T.prefill(tp, cfg, toks[:, :S], smax=SMAX, enc=enc,
                       compute_dtype=tdt)
    _close(_np(tl), jl, tol, "prefill logits")
    assert _dtypes(tc) == _dtypes(jc)
    tcn = T.cache_to_numpy(tc)
    assert sorted(tcn) == sorted(jc)
    for key in jc:
        _close(tcn[key], jc[key], tol, f"prefill cache {key}")

    step = _strict(lambda p, t, c: R.decode_step(p, rcfg, t, c,
                                                 compute_dtype=jdt), dtype)
    tc = T.cache_from_reference(jax.tree.map(np.asarray, jc), device="cpu")
    for t in range(S, S + STEPS):
        jl, jc = step(params, jnp.asarray(toks[:, t]), jc)
        tl, tc = T.decode_step(tp, cfg, toks[:, t], tc, compute_dtype=tdt)
        _close(_np(tl), jl, tol, f"decode step {t}")
    assert _dtypes(tc) == _dtypes(jc)
    tcn = T.cache_to_numpy(tc)
    for key in jc:
        _close(tcn[key], jc[key], tol, f"decoded cache {key}")
    assert int(tc["len"]) == S + STEPS


def test_reference_bf16_depends_on_excess_precision():
    """Why the bfloat16 reference is compiled strictly: XLA's default CPU
    compile of the same program leaves the tolerance."""
    rcfg, params, _ = _reference("deepseek-coder-33b")
    toks, _ = _inputs(rcfg)
    fn = functools.partial(R.forward, cfg=rcfg, compute_dtype=jnp.bfloat16)
    strict = np.asarray(jax.jit(lambda p, t: fn(p, tokens=t),
                                compiler_options=STRICT)(params, toks),
                        np.float32)
    loose = np.asarray(jax.jit(lambda p, t: fn(p, tokens=t))(params, toks),
                       np.float32)
    tol = TOL["bfloat16"]
    assert np.max(np.abs(loose - strict) / (tol * (1 + np.abs(strict)))) > 1


class _Spy:
    """Records every call of the flash-attention wrapper the model makes."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = tt.attention

        def spy(q, k, v, **kw):
            out = real(q, k, v, **kw)
            self.calls.append((q, k, v, kw, out))
            return out
        monkeypatch.setattr(tt, "attention", spy)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-27b",
                                  "gemma3-27b"])
def test_prefill_k6_equals_blockwise_over_cache(arch, monkeypatch):
    """Each self-attention layer of prefill calls the flash-attention
    wrapper once, with the layer's window (gemma2 "LG", gemma3 "LLLLLG"),
    and its result equals the JAX package's computation: blockwise
    attention over the whole smax cache, keys past the prompt at position
    2**30, a global layer's window 2**30."""
    cfg = get_config(arch).reduced(n_layers=6)
    s, smax = 24, 32                     # longer than the window (16)
    tp = T.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks, _ = _inputs(cfg, s=s)
    spy = _Spy(monkeypatch)
    _, cache = T.prefill(tp, cfg, toks, smax=smax,
                         compute_dtype=torch.float32)
    kinds = cfg.layer_kinds()
    assert len(spy.calls) == len(kinds) == cfg.n_self_layers
    pos = torch.arange(smax, dtype=torch.int32)
    kv_pos = torch.where(pos < s, pos, FAR)[None].expand(2, smax)
    q_pos = pos[:s][None].expand(2, s)
    for i, ((q, k, v, kw, out), is_global) in enumerate(zip(spy.calls,
                                                            kinds)):
        assert kw["causal"] is True
        assert kw["window"] == (0 if is_global else cfg.window), i
        assert (kw["softcap"], kw["scale"]) == (cfg.attn_softcap,
                                                cfg.attn_scale)
        assert q.shape[2] == k.shape[2] == s
        # the cache holds exactly the keys and values the kernel was given
        assert torch.equal(cache["k"][i][:, :s], k.transpose(1, 2))
        assert torch.equal(cache["v"][i][:, :s], v.transpose(1, 2))
        want = blockwise_attention(
            q.transpose(1, 2), cache["k"][i], cache["v"][i], q_pos=q_pos,
            kv_pos=kv_pos, causal=True,
            window=FAR if (cfg.window and is_global) else cfg.window or None,
            softcap=cfg.attn_softcap, scale=cfg.attn_scale, chunk=8)
        _close(_np(out.transpose(1, 2)), _np(want), 1e-5, f"layer {i}")
    if cfg.window:
        assert 0 < sum(kinds) < len(kinds)       # both kinds were checked


def test_k6_only_on_fresh_self_attention(monkeypatch):
    """forward and prefill: one wrapper call a self-attention layer;
    decode_step and cross-attention: none."""
    cfg = get_config("llama-3.2-vision-90b").reduced()
    tp = T.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    toks, enc = _inputs(cfg)
    spy = _Spy(monkeypatch)
    T.forward(tp, cfg, toks, enc=enc)
    assert len(spy.calls) == cfg.n_self_layers
    lp, cache = T.prefill(tp, cfg, toks[:, :S], smax=SMAX, enc=enc)
    assert len(spy.calls) == 2 * cfg.n_self_layers
    for t in range(S, S + STEPS):
        lp, cache = T.decode_step(tp, cfg, toks[:, t], cache)
    assert len(spy.calls) == 2 * cfg.n_self_layers


class _ScanSpy:
    """Counts the selective-scan wrapper's calls the Mamba mixer makes."""

    def __init__(self, monkeypatch):
        from repro_torch.models import ssm
        self.calls = []
        real = ssm.mamba_scan

        def spy(a, bx, c, **kw):
            self.calls.append((a.shape, kw.get("h0") is not None,
                               kw.get("return_state")))
            return real(a, bx, c, **kw)
        monkeypatch.setattr(ssm, "mamba_scan", spy)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_k7_once_a_mixer_layer_outside_decode(arch, monkeypatch):
    """forward and prefill call the selective-scan wrapper once a Mamba
    mixer layer (prefill from no state, its last state returned; forward
    without it); decode_step never (the one-step recurrence).  K6 is
    called once a hymba layer in forward and prefill, never in decode."""
    cfg = get_config(arch).reduced()
    tp = T.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    toks, _ = _inputs(cfg)
    scans, attn = _ScanSpy(monkeypatch), _Spy(monkeypatch)
    L = cfg.n_layers
    T.forward(tp, cfg, toks)
    assert scans.calls == [((2, S + STEPS, 2 * cfg.d_model,
                             cfg.ssm.d_state), False, False)] * L
    _, cache = T.prefill(tp, cfg, toks[:, :S], smax=SMAX)
    assert scans.calls[L:] == [((2, S, 2 * cfg.d_model, cfg.ssm.d_state),
                                False, True)] * L
    for t in range(S, S + STEPS):
        _, cache = T.decode_step(tp, cfg, toks[:, t], cache)
    assert len(scans.calls) == 2 * L
    assert len(attn.calls) == (2 * L if cfg.mixer == "hymba" else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_and_finite(arch):
    """Twin of tests/test_arch_smoke.py's forward test."""
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks, enc = _inputs(cfg, s=16)
    logits = T.forward(params, cfg, toks, enc=enc)
    assert logits.shape == (2, 16, cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """Twin of tests/test_arch_smoke.py's prefill/decode test."""
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks, enc = _inputs(cfg, s=16)
    logits = T.forward(params, cfg, toks, enc=enc)
    lp, cache = T.prefill(params, cfg, toks, smax=24, enc=enc)
    _close(_np(lp), _np(logits[:, -1]), 1e-3, "prefill vs forward")
    tok = (torch.randn((2, cfg.d_model), generator=torch.Generator()
                       .manual_seed(0))
           if cfg.input_mode == "embeddings" else torch.argmax(lp, -1))
    l2, cache2 = T.decode_step(params, cfg, tok, cache)
    assert l2.shape == (2, cfg.vocab)
    assert bool(torch.isfinite(l2.float()).all())
    assert int(cache2["len"]) == int(cache["len"]) + 1


def test_archs_cover_reference():
    """Every architecture the JAX package carries is in :data:`ARCHS`."""
    assert sorted(ARCHS) == sorted(r_archs())


class _MoESpy:
    """Records every call of the MoE MLP the model makes."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = tt.moe_mlp

        def spy(x, params, moe):
            self.calls.append((tuple(x.shape), sorted(params)))
            return real(x, params, moe)
        monkeypatch.setattr(tt, "moe_mlp", spy)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_moe_mlp_once_a_layer(arch, monkeypatch):
    """forward, prefill and decode_step call the MoE MLP once a layer,
    with every leaf of the layer's ``_moe_shapes`` and the layer's tokens
    (one a row in decode); K6 runs once a layer in forward and prefill."""
    cfg = get_config(arch).reduced()
    tp = T.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    toks, _ = _inputs(cfg)
    moe, attn = _MoESpy(monkeypatch), _Spy(monkeypatch)
    keys = sorted(tt._moe_shapes(cfg))
    L, d = cfg.n_layers, cfg.d_model
    T.forward(tp, cfg, toks)
    _, cache = T.prefill(tp, cfg, toks[:, :S], smax=SMAX)
    for t in range(S, S + STEPS):
        _, cache = T.decode_step(tp, cfg, toks[:, t], cache)
    assert moe.calls == ([((2, S + STEPS, d), keys)] * L
                         + [((2, S, d), keys)] * L
                         + [((2, 1, d), keys)] * (L * STEPS))
    assert len(attn.calls) == 2 * L


def _layer_cases():
    from repro.models import layers as rl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=(64,))).astype(np.float32)
    m1, m2 = (rng.normal(size=(64, 96)).astype(np.float32) / 8
              for _ in range(2))
    m3 = rng.normal(size=(96, 64)).astype(np.float32) / 8
    q = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    kv = rng.normal(size=(2, 20, 2, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    kpos = np.broadcast_to(np.arange(20) - 4, (2, 20)).astype(np.int32)
    attn = dict(q_pos=pos + 4, kv_pos=kpos)
    # decode: one query against a 20-key cache filled to 13 keys
    q1 = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    cpos = np.where(np.arange(20) < 13, np.arange(20), 2 ** 30)
    dec = dict(q_pos=np.full((2, 1), 12, np.int32),
               kv_pos=np.broadcast_to(cpos, (2, 20)).astype(np.int32))
    return {
        "rms_norm": (rl.rms_norm, tl.rms_norm, (x, w), {}),
        "rms_norm_plus_one": (rl.rms_norm, tl.rms_norm, (x, w),
                              dict(plus_one=True)),
        "soft_cap": (rl.soft_cap, tl.soft_cap, (x * 40,), dict(cap=30.0)),
        "rope_tables": (rl.rope_tables, tl.rope_tables, (pos + 1000,),
                        dict(head_dim=16, theta=500000.0)),
        "apply_rope": (rl.apply_rope, tl.apply_rope,
                       (q,) + tuple(np.asarray(t) for t in
                                    rl.rope_tables(pos, 16)), {}),
        "mlp_swiglu": (rl.mlp_swiglu, tl.mlp_swiglu, (x, m1, m2, m3), {}),
        "mlp_gelu": (rl.mlp_gelu, tl.mlp_gelu, (x, m1, m3), {}),
        "mlp_geglu": (rl.mlp_geglu, tl.mlp_geglu, (x, m1, m2, m3), {}),
        "blockwise": (rl.blockwise_attention, tl.blockwise_attention,
                      (q, kv, kv * 0.5), dict(attn, window=6, softcap=20.0,
                                              chunk=8)),
        "blockwise_cross": (rl.blockwise_attention, tl.blockwise_attention,
                            (q, kv, kv * 0.5), dict(attn, causal=False,
                                                    chunk=8)),
        "blockwise_decode": (rl.blockwise_attention, tl.blockwise_attention,
                             (q1, kv, kv * 0.5), dict(dec, window=6,
                                                      chunk=8)),
        "blockwise_scaled": (rl.blockwise_attention, tl.blockwise_attention,
                             (q, kv, kv * 0.5), dict(attn, softcap=20.0,
                                                     scale=0.125)),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(_layer_cases()))
def test_layers_match_reference(name, dtype):
    """Each building block on the same inputs, eager (op by op, as the JAX
    package runs them outside a jit): float32 at 1e-5, bfloat16 at 2e-2.
    The blockwise attention in the calls the model makes of it: windowed
    and softcapped, cross (not causal, a ragged last chunk), decode (one
    query, keys past the cache's fill at ``2**30``), an explicit scale."""
    rfn, tfn, args, kw = _layer_cases()[name]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def j(a):
        return jnp.asarray(a) if a.dtype.kind == "i" else jnp.asarray(a, jdt)

    def t(a):
        return torch.as_tensor(a) if a.dtype.kind == "i" else \
            torch.as_tensor(np.array(a)).to(tdt)
    jkw = {k: (j(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = rfn(*[j(a) for a in args], **jkw)
    got = tfn(*[t(a) for a in args], **tkw)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        _close(_np(g), w, tol, name)
