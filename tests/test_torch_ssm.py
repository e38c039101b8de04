"""The port's Mamba-1 mixer (``repro_torch.models.ssm``), the selective
scan's state (K7's plain version with ``h0`` and ``h_last``), ``softplus``
and the Mamba leaves' init and cast rules, against the JAX package on the
CPU, on inputs made from a seed with numpy.

Tolerances: rtol = atol = 1e-4 in float32 (sums over states and the scan
taken in another order: the JAX package scans associatively in chunks)
and 2e-2 in bfloat16, where the reference is the JAX function compiled
with ``xla_allow_excess_precision`` off (``tests/test_torch_lm_model.py``
says why).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_config as r_config
from repro.models.config import SSMConfig
from repro.models.ssm import _ssm_scan_chunked
from repro.models.ssm import mamba_mixer as r_mixer
from repro_torch import models as T
from repro_torch.configs import get_config
from repro_torch.kernels import mamba_scan
from repro_torch.kernels.mamba_scan import mamba_scan_plain
from repro_torch.models.layers import softplus
from repro_torch.models.ssm import mamba_mixer

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
STRICT = {"xla_allow_excess_precision": False}
SSM = SSMConfig(d_state=8, d_conv=4, expand=2)
D_MODEL = 32


def _mixer_params(seed=0):
    """The mixer's leaves at d_model 32 (d_inner 64, dt_rank 2, N 8, K 4),
    scaled as the JAX package's init scales them; A_log = log(1..N)."""
    rng = np.random.default_rng(seed)
    d, di, n, k = D_MODEL, SSM.expand * D_MODEL, SSM.d_state, SSM.d_conv
    r = SSM.dt_rank_of(d)

    def w(*shape, fan_in):
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
    return {
        "in_proj": w(d, 2 * di, fan_in=d),
        "conv_w": w(k, di, fan_in=k),
        "conv_b": w(di, fan_in=2),
        "x_proj": w(di, r + 2 * n, fan_in=di),
        "dt_proj": w(r, di, fan_in=r),
        "dt_bias": w(di, fan_in=2),
        "A_log": np.log(np.broadcast_to(np.arange(1, n + 1, dtype=np.float32),
                                        (di, n))).astype(np.float32),
        "D": w(di, fan_in=2),
        "out_proj": w(di, d, fan_in=di),
    }


def _state(b, seed=1):
    rng = np.random.default_rng(seed)
    di = SSM.expand * D_MODEL
    return {"conv": rng.normal(size=(b, SSM.d_conv - 1, di))
            .astype(np.float32),
            "h": (0.5 * rng.normal(size=(b, di, SSM.d_state)))
            .astype(np.float32)}


def _np(t):
    return np.asarray(t.detach().float().numpy() if torch.is_tensor(t) else
                      np.asarray(t, np.float32), np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


#: (mode, S): from no state; from a nonzero state with the state returned;
#: one decode step (S == 1 from a state)
CASES = [("fresh", 1), ("fresh", 13), ("fresh", 64), ("state", 13),
         ("state", 64), ("decode", 1)]


@pytest.mark.parametrize("dtype,weights", [("float32", "float32"),
                                           ("bfloat16", "mamba"),
                                           ("bfloat16", "hymba")])
@pytest.mark.parametrize("mode,s", CASES)
def test_mixer_matches_reference(mode, s, dtype, weights):
    """``mamba_mixer`` against the JAX package's on the same weights and
    inputs.  In bfloat16, "mamba" casts the float32 leaves but ``A_log``
    and ``D`` to bfloat16 (the ``mamba`` layer's cast), "hymba" keeps
    them float32 (so products promote to float32, as in a ``hymba``
    layer); the state's conv window is in the activations' dtype."""
    p = _mixer_params()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cast = weights == "mamba"
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, s, D_MODEL)).astype(np.float32)
    st = _state(2) if mode != "fresh" else None

    def jax_fn(p, x, st):
        jp = {k: (v.astype(jdt) if cast and k not in ("A_log", "D") else v)
              for k, v in p.items()}
        if st is not None:
            st = {"conv": st["conv"].astype(jdt), "h": st["h"]}
        return r_mixer(x.astype(jdt), jp, SSM, state=st,
                       return_state=st is not None)
    fn = jax.jit(jax_fn, compiler_options=STRICT) if dtype == "bfloat16" \
        else jax.jit(jax_fn)
    want = fn(p, jnp.asarray(x), st)

    tp = {k: torch.as_tensor(v).to(tdt if cast and k not in ("A_log", "D")
                                   else torch.float32)
          for k, v in p.items()}
    tst = None if st is None else {
        "conv": torch.as_tensor(st["conv"]).to(tdt),
        "h": torch.as_tensor(st["h"])}
    got = mamba_mixer(torch.as_tensor(x).to(tdt), tp, SSM, state=tst,
                      return_state=tst is not None)
    if st is None:
        got, want = (got,), (want,)
    else:
        got = (got[0], got[1]["conv"], got[1]["h"])
        want = (want[0], want[1]["conv"], want[1]["h"])
    for name, g, w in zip(("out", "conv", "h"), got, want):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), name
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, w, TOL[dtype], f"{mode} S={s} {dtype}/{weights}: {name}")


@pytest.mark.parametrize("b,s,d,n,chunk", [(2, 13, 24, 5, 4),
                                           (1, 64, 16, 4, 16),
                                           (2, 509, 8, 16, 256)])
def test_scan_state_matches_reference(b, s, d, n, chunk):
    """K7's plain version from a nonzero ``h0``, returning ``h_last``,
    against the JAX package's chunked scan (a padded last chunk where
    ``chunk`` does not divide S) and its einsum for y."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.6, 0.999, (b, s, d, n)).astype(np.float32)
    bx = (0.1 * rng.normal(size=(b, s, d, n))).astype(np.float32)
    c = rng.normal(size=(b, s, n)).astype(np.float32)
    h0 = rng.normal(size=(b, d, n)).astype(np.float32)
    h_all, h_last = _ssm_scan_chunked(jnp.asarray(a), jnp.asarray(bx),
                                      jnp.asarray(h0), chunk=chunk)
    y = jnp.einsum("bsdn,bsn->bsd", h_all, jnp.asarray(c))
    ta, tbx, tc, th0 = (torch.as_tensor(t) for t in (a, bx, c, h0))
    got_y, got_h = mamba_scan_plain(ta, tbx, tc, h0=th0, return_state=True)
    _close(got_y, y, 1e-4, "y")
    _close(got_h, h_last, 1e-4, "h_last")
    assert got_h.dtype == torch.float32 and got_h.shape == (b, d, n)
    # the wrapper on CPU tensors: the plain version, no launch counted
    launches = mamba_scan.launches
    y2, h2 = mamba_scan(ta, tbx, tc, h0=th0, return_state=True,
                        device="cpu")
    assert torch.equal(y2, got_y) and torch.equal(h2, got_h)
    assert mamba_scan.launches == launches
    # from no state: y equal to the scan without one
    y3, _ = mamba_scan_plain(ta, tbx, tc, return_state=True)
    assert torch.equal(y3, mamba_scan_plain(ta, tbx, tc))


def test_scan_checks_state_shape():
    a = torch.ones((1, 4, 3, 2))
    c = torch.ones((1, 4, 2))
    with pytest.raises(ValueError, match="h0 must be"):
        mamba_scan(a, a, c, h0=torch.zeros((1, 2, 3)), device="cpu")
    y, h = mamba_scan(a[:, :0], a[:, :0], c[:, :0], h0=torch.ones((1, 3, 2)),
                      return_state=True, device="cpu")
    assert y.shape == (1, 0, 3) and torch.equal(h, torch.ones((1, 3, 2)))


def _softplus_inputs():
    rng = np.random.default_rng(5)
    return np.concatenate([rng.normal(size=20000) * 4,
                           rng.normal(size=20000) * 40,
                           [np.nan, np.inf, -np.inf, 0.0, -0.0, 20.0, 21.0,
                            88.0, 100.0, -100.0]]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_softplus_matches_jax(dtype):
    """``softplus`` against a strict ``jax.nn.softplus``: bfloat16 bit for
    bit (where the result is not subnormal: XLA flushes subnormals to
    zero), float32 within 4 ulps (XLA's ``exp``/``log1p`` are its own
    polynomials; 3 ulps at most on these inputs).  Torch's ``F.softplus`` misses bfloat16 parity."""
    x = _softplus_inputs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax.jit(jax.nn.softplus, compiler_options=STRICT)(
        jnp.asarray(x, jdt)).astype(jnp.float32))
    got = softplus(torch.as_tensor(x).to(tdt))
    assert got.dtype == tdt
    got = got.float().numpy()
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    normal = ~nan & ~((np.abs(got) < np.finfo(np.float32).tiny) & (got != 0))
    if dtype == "bfloat16":
        assert np.array_equal(got[normal], want[normal])
        fused = torch.nn.functional.softplus(torch.as_tensor(x).to(tdt))
        assert (fused.float().numpy()[normal] != want[normal]).sum() > 100
    else:
        np.testing.assert_array_max_ulp(got[normal], want[normal], maxulp=4)


@functools.lru_cache(maxsize=None)
def _r_params(arch):
    cfg = r_config(arch).reduced(d_model=128)
    return jax.tree.map(np.asarray, R.init_params(cfg, jax.random.PRNGKey(3)))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_init_params_follow_reference_rules(arch):
    """The port's ``init_params`` against the JAX package's on every leaf:
    the same constant leaves (ones, zeros, ``A_log = log(1..N)``), and
    the normal ones at the same scale (the JAX package's draws and the
    port's both within 20% of ``1/sqrt(fan_in)``, ``fan_in`` the stacked
    leaf's second-to-last dim: the layer count for ``ssm_D``,
    ``ssm_conv_b``, ``ssm_dt_bias``, the kernel width for ``ssm_conv_w``).
    """
    ref = _r_params(arch)
    cfg = get_config(arch).reduced(d_model=128)
    tp = T.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    stacked = {k: torch.stack([lp[k] for lp in tp.layers]).numpy()
               for k in tp.layers[0].keys()}
    leaves = {k: (v, stacked[k]) for k, v in ref["layers"].items()}
    leaves["embed"] = (ref["embed"], tp.embed.numpy())
    leaves["final_norm"] = (ref["final_norm"], tp.final_norm.numpy())
    assert sorted(ref) == ["embed", "final_norm", "layers"]    # tied
    n_layers = cfg.n_layers
    for name, (want, got) in sorted(leaves.items()):
        assert want.shape == got.shape and got.dtype == np.float32, name
        if np.all(want == want.flat[0]) or name.endswith("A_log"):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
            continue
        fan_in = want.shape[-2]
        if name in ("ssm_D", "ssm_conv_b", "ssm_dt_bias"):
            assert fan_in == n_layers
        scale = 1 / np.sqrt(fan_in)
        for who, arr in (("jax", want), ("port", got)):
            assert abs(arr.std() / scale - 1) < 0.2, (name, who, arr.std())
            assert abs(arr.mean()) < 0.2 * scale, (name, who)
    a_log = stacked["ssm_A_log"]
    assert np.allclose(a_log, np.log(np.arange(1, cfg.ssm.d_state + 1)))


@pytest.mark.parametrize("arch,cast", [
    ("falcon-mamba-7b", {"ssm_in_proj", "ssm_conv_w", "ssm_conv_b",
                         "ssm_x_proj", "ssm_dt_proj", "ssm_dt_bias",
                         "ssm_out_proj", "wg", "wu", "wd"}),
    ("hymba-1.5b", {"wq", "wk", "wv", "wo", "wg", "wu", "wd"}),
    ("llama3.2-1b", {"wq", "wk", "wv", "wo", "wg", "wu", "wd"})])
def test_cast_for_compute_per_mixer(arch, cast):
    """``cast_for_compute`` copies to bfloat16 exactly the leaves the JAX
    package's layer casts at every use (a ``mamba`` layer its float32
    ``ssm_*`` leaves but ``A_log`` and ``D``; a ``hymba`` layer none of
    them), and the model on those copies equals the model on the float32
    weights bit for bit."""
    cfg = get_config(arch).reduced()
    tp = T.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    got = T.cast_for_compute(tp, cfg, torch.bfloat16)
    assert got.embed.dtype == torch.bfloat16
    for lp in got.layers:
        assert {k for k, v in lp.items() if v.dtype == torch.bfloat16} == cast
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 9))
    assert torch.equal(T.forward(got, cfg, toks), T.forward(tp, cfg, toks))
    lg, cg = T.prefill(got, cfg, toks, smax=12)
    lt, ct = T.prefill(tp, cfg, toks, smax=12)
    assert torch.equal(lg, lt)
    assert all(torch.equal(cg[k], ct[k]) for k in ct)
