"""The port's MoE MLP (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the CPU, on inputs made from a seed with
numpy, and the MoE leaves' init and cast rules.

Tolerances: rtol = atol = 1e-4 in float32 and 2e-2 in bfloat16, where the
reference is the JAX function compiled with ``xla_allow_excess_precision``
off (``tests/test_torch_lm_model.py`` says why).  Expert ids, positions
and drops are held exactly: a different choice changes a whole token's
output.
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
from repro.models import moe as rmoe
from repro.models.config import MoEConfig as RMoEConfig
from repro_torch import models as T
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe
from repro_torch.models.config import MoEConfig

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
STRICT = {"xla_allow_excess_precision": False}
D_MODEL = 32

#: name -> (MoEConfig fields, B, S, zero router): padded experts (6 pad to
#: 8, the mask reached), drops (capacity factor 0.5), a capacity that
#: Python's round takes half to even (18*2/8 = 4.5 -> 4, not 5), all-zero
#: router weights (exact ties: the order decides), no shared experts, a
#: decode step (S = 1), top-1 without renormalizing
CASES = {
    "padded": (dict(n_experts=6, top_k=2, n_shared=2, d_shared=24), 2, 16,
               False),
    "drops": (dict(n_experts=8, top_k=2, n_shared=2, d_shared=24,
                   capacity_factor=0.5), 2, 64, False),
    "round_half_even": (dict(n_experts=8, top_k=2, capacity_factor=1.0),
                        2, 18, False),
    "zero_router": (dict(n_experts=6, top_k=3, n_shared=2, d_shared=24),
                    2, 12, True),
    "no_shared": (dict(n_experts=8, top_k=2), 2, 24, False),
    "decode": (dict(n_experts=6, top_k=2, n_shared=2, d_shared=24), 4, 1,
               False),
    "top1": (dict(n_experts=8, top_k=1, router_norm_topk=False), 1, 20,
             False),
}


def _case(name, seed=0):
    fields, b, s, zero = CASES[name]
    fields = dict(dict(d_expert=16), **fields)
    moe_r, moe_t = RMoEConfig(**fields), MoEConfig(**fields)
    assert moe_r.n_experts_padded == moe_t.n_experts_padded
    e, d, f = moe_t.n_experts_padded, D_MODEL, moe_t.d_expert
    rng = np.random.default_rng(seed)

    def w(*shape, fan_in):
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
    params = {"w_router": (np.zeros((d, e), np.float32) if zero
                           else w(d, e, fan_in=d)),
              "wg": w(e, d, f, fan_in=d), "wu": w(e, d, f, fan_in=d),
              "wd": w(e, f, d, fan_in=f)}
    if moe_t.n_shared:
        ds = moe_t.d_shared
        params.update(sg=w(d, ds, fan_in=d), su=w(d, ds, fan_in=d),
                      sd=w(ds, d, fan_in=ds), shared_gate=w(d, fan_in=2))
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    return moe_r, moe_t, x, params


def _pair(a, dtype):
    """``a`` as the JAX package's and the port's array in ``dtype``."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.as_tensor(a).to(getattr(torch, dtype)))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _jit(fn, dtype):
    return jax.jit(fn, compiler_options=STRICT) if dtype == "bfloat16" \
        else jax.jit(fn)


def _r_dispatch(experts, e_pad, capacity):
    """The JAX package's position and keep, as ``moe_mlp`` computes them."""
    b = experts.shape[0]
    flat_e = experts.reshape(b, -1)
    onehot = jax.nn.one_hot(flat_e, e_pad, dtype=jnp.int32)
    pos_all = jnp.cumsum(onehot, axis=1) - onehot
    pos = jnp.take_along_axis(pos_all, flat_e[..., None], axis=-1)[..., 0]
    return np.asarray(pos), np.asarray(pos < capacity)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_router_and_dispatch_match_reference(name, dtype):
    """``router_topk``: the same expert ids in the same order, weights
    within the tolerance; ``capacity_of`` the JAX expression; positions
    and drops equal."""
    moe_r, moe_t, x, params = _case(name)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(params["w_router"], dtype)
    want_w, want_i = _jit(lambda a, b: rmoe.router_topk(a, b, moe_r),
                          dtype)(jx, jw)
    got_w, got_i = tmoe.router_topk(tx, tw, moe_t)
    assert got_w.dtype == torch.float32
    assert np.array_equal(got_i.numpy(), np.asarray(want_i)), name
    _close(got_w, want_w, TOL[dtype], "router weights")
    b, s, k = got_i.shape
    cap = tmoe.capacity_of(s, moe_t)
    assert cap == int(max(k, round(s * k / moe_r.n_experts
                                   * moe_r.capacity_factor)))
    e_pad = params["w_router"].shape[1]
    pos, keep = tmoe.dispatch(got_i, e_pad, cap)
    want_pos, want_keep = _r_dispatch(want_i, e_pad, cap)
    assert np.array_equal(pos.numpy(), want_pos)
    assert np.array_equal(keep.numpy(), want_keep)
    if name == "zero_router":
        # exact ties: the lowest ids, in order
        assert np.array_equal(got_i.numpy(),
                              np.broadcast_to(np.arange(k), (b, s, k)))
    if name in ("drops", "round_half_even", "zero_router"):
        assert not keep.all()
    if name == "round_half_even":
        assert cap == 4 and s * k / moe_t.n_experts == 4.5
        assert ((pos == 4).sum() > 0).item()     # what ceil's 5 would keep
    if name == "padded":
        assert int(got_i.max()) < moe_t.n_experts < e_pad
    if name == "decode":
        assert keep.all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_mlp_matches_reference(name, dtype):
    """``moe_mlp`` on the same inputs and weights: the output's dtype and
    values."""
    moe_r, moe_t, x, params = _case(name)
    jx, tx = _pair(x, dtype)
    jp, tp = {}, {}
    for key, v in params.items():
        jp[key], tp[key] = _pair(v, dtype)
    want = _jit(lambda a, p: rmoe.moe_mlp(a, p, moe_r), dtype)(jx, jp)
    got = tmoe.moe_mlp(tx, tp, moe_t)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert got.shape == tuple(want.shape)
    _close(got, want, TOL[dtype], name)


def test_combine_adds_the_choices_in_order():
    """The combine is deterministic: a token's k choices are added in
    order, ``((0 + e0) + e1) + e2``, and a rerun gives the same bits."""
    _, moe_t, x, params = _case("padded")
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    tx = torch.as_tensor(x)
    first = tmoe.moe_mlp(tx, tp, moe_t)
    assert torch.equal(first, tmoe.moe_mlp(tx, tp, moe_t))
    no_shared = dataclasses.replace(moe_t, n_shared=0)
    y = tmoe.moe_mlp(tx, tp, no_shared)
    w, ids = tmoe.router_topk(tx, tp["w_router"], moe_t)
    b, s, k = ids.shape
    pos, keep = tmoe.dispatch(ids, tp["w_router"].shape[1],
                              tmoe.capacity_of(s, moe_t))
    keep = keep.reshape(b, s, k)
    want = torch.zeros_like(y)
    for bi in range(b):
        for t in range(s):
            acc = torch.zeros(x.shape[-1])
            for j in range(k):
                xe = tx[bi, t] if keep[bi, t, j] else torch.zeros_like(tx[0, 0])
                e = int(ids[bi, t, j])
                g, u = xe @ tp["wg"][e], xe @ tp["wu"][e]
                h = g * (1 / (1 + torch.exp(-g))) * u
                acc = acc + (h @ tp["wd"][e]) * (w[bi, t, j] * keep[bi, t, j])
            want[bi, t] = acc
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _r_params(arch):
    cfg = r_config(arch).reduced(d_model=128)
    return jax.tree.map(np.asarray, R.init_params(cfg, jax.random.PRNGKey(3)))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_init_params_follow_reference_rules(arch):
    """The port's ``init_params`` against the JAX package's on every leaf
    of the reduced MoE configurations: the same constant leaves, and the
    normal ones at the same scale (both within 20% of
    ``1/sqrt(fan_in)``): the router's fan-in d, the experts' ``wg``/``wu``
    d and ``wd`` d_expert, and ``shared_gate``'s the layer count (its name
    is not ``gate*``: drawn, not zero)."""
    ref = _r_params(arch)
    cfg = get_config(arch).reduced(d_model=128)
    tp = T.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    stacked = {k: torch.stack([lp[k] for lp in tp.layers]).numpy()
               for k in tp.layers[0].keys()}
    leaves = {k: (v, stacked[k]) for k, v in ref["layers"].items()}
    leaves["embed"] = (ref["embed"], tp.embed.numpy())
    leaves["lm_head"] = (ref["lm_head"], tp.lm_head.numpy())
    assert sorted(ref) == ["embed", "final_norm", "layers", "lm_head"]
    moe = cfg.moe
    fan_ins = {"w_router": cfg.d_model, "wg": cfg.d_model,
               "wu": cfg.d_model, "wd": moe.d_expert}
    if moe.n_shared:
        fan_ins.update(sg=cfg.d_model, su=cfg.d_model, sd=moe.d_shared,
                       shared_gate=cfg.n_layers)
    assert set(fan_ins) <= set(leaves)
    for name, (want, got) in sorted(leaves.items()):
        assert want.shape == got.shape and got.dtype == np.float32, name
        if np.all(want == want.flat[0]):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
            continue
        fan_in = want.shape[-2]
        assert fan_in == fan_ins.get(name, fan_in), name
        scale = 1 / np.sqrt(fan_in)
        for who, arr in (("jax", want), ("port", got)):
            assert abs(arr.std() / scale - 1) < 0.2, (name, who, arr.std())
            assert abs(arr.mean()) < 0.2 * scale, (name, who)


@pytest.mark.parametrize("arch,cast", [
    ("qwen2-moe-a2.7b", {"wq", "wk", "wv", "wo", "wg", "wu", "wd",
                         "w_router", "sg", "su", "sd", "shared_gate"}),
    ("qwen3-moe-235b-a22b", {"wq", "wk", "wv", "wo", "wg", "wu", "wd",
                             "w_router"})])
def test_cast_for_compute_moe(arch, cast):
    """``cast_for_compute`` copies to bfloat16 every leaf of the JAX
    package's ``_moe_shapes`` (the router and shared gate included) and
    the attention matrices, and nothing else (qwen3's q/k norms stay); the
    model on those copies equals the model on the float32 weights bit for
    bit; a model made in bfloat16 is shared, not copied."""
    cfg = get_config(arch).reduced()
    tp = T.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    got = T.cast_for_compute(tp, cfg, torch.bfloat16)
    for lp in got.layers:
        assert {k for k, v in lp.items() if v.dtype == torch.bfloat16} == cast
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 9))
    assert torch.equal(T.forward(got, cfg, toks), T.forward(tp, cfg, toks))
    lg, cg = T.prefill(got, cfg, toks, smax=12)
    lt, ct = T.prefill(tp, cfg, toks, smax=12)
    assert torch.equal(lg, lt)
    assert all(torch.equal(cg[k], ct[k]) for k in ct if k != "len")
    b16 = T.init_params(cfg, torch.Generator().manual_seed(4),
                        dtype=torch.bfloat16, device="cpu")
    again = T.cast_for_compute(b16, cfg, torch.bfloat16)
    assert again.embed.data_ptr() == b16.embed.data_ptr()
    assert again.lm_head.data_ptr() == b16.lm_head.data_ptr()
    for lp, lq in zip(again.layers, b16.layers):
        assert all(lp[k].data_ptr() == lq[k].data_ptr() for k in lq.keys())


def test_mlp_takes_the_moe_branch_before_d_ff():
    """qwen2-moe's ``d_ff`` is 0 at full width: the layer's MLP is the MoE
    one, not the zeros a dense MLP of width 0 gives."""
    from repro_torch.models import transformer as tt
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                              d_ff=0)
    assert cfg.moe is not None and not cfg.d_ff
    tp = T.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    x = torch.randn((1, 6, cfg.d_model), generator=torch.Generator()
                    .manual_seed(6))
    out = tt._mlp(x, tp.layers[0], cfg, torch.float32)
    want = tmoe.moe_mlp(x, {k: v for k, v in tp.layers[0].items()
                            if k in tt._moe_shapes(cfg)}, cfg.moe)
    assert torch.equal(out, want) and out.abs().sum() > 0
