"""The port's attention boundary (K6's plain version, ``device="cpu"``)
against the JAX package on the same seeded numpy inputs.

The Pallas wrapper ``repro.kernels.ops.attention`` does not run on the
installed JAX (its kernel calls ``pl.load``), so the references are the
JAX package's oracle ``repro.kernels.ref.ref_attention`` and its jnp
flash-style loop ``repro.models.layers.blockwise_attention`` (transposed
to its (B, S, H, D) layout, ``q_pos = kv_pos = arange(S)``).  The cases
and tolerances are ``tests/test_kernels.py``'s: rtol = atol = 2e-5 in
float32 (float32 sums in another order) and 5e-2 in bfloat16.

The port departs from the reference wrapper on purpose: that one pads
k/v with zero rows its kernel does not mask, so with ``causal=False`` and
S not a multiple of the block the padded keys enter the softmax; the port
masks keys at ``k_pos >= S`` and equals ``ref_attention`` on the unpadded
inputs.  ``test_reference_wrapper_padding_departs`` shows the difference
with the padded-input math.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ref_attention as r_ref
from repro.models.layers import blockwise_attention
from repro_torch.kernels import attention, flash_attention
from repro_torch.kernels.flash_attention import attention_plain
from repro_torch.kernels.ref import ref_attention as t_ref

TOL, BF16_TOL = 2e-5, 5e-2


def _qkv(seed, b, hq, hkv, s, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, d)).astype(dtype)
            for h in (hq, hkv, hkv)]


def _jax_ref(q, k, v, dtype=jnp.float32, **kw):
    return np.asarray(r_ref(*[jnp.asarray(x, dtype) for x in (q, k, v)],
                            **kw), np.float32)


def _blockwise(q, k, v, *, causal=True, window=0, softcap=0.0, scale=0.0):
    b, _, s, _ = q.shape
    pos = jnp.broadcast_to(jnp.arange(s), (b, s))
    out = blockwise_attention(
        *[jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v)],
        q_pos=pos, kv_pos=pos, causal=causal, window=window,
        softcap=softcap, scale=scale, chunk=64)
    return np.asarray(jnp.swapaxes(out, 1, 2), np.float32)


def _port(q, k, v, dtype=torch.float32, **kw):
    got = attention(*[torch.as_tensor(x).to(dtype) for x in (q, k, v)],
                    bq=64, bk=64, device="cpu", **kw)
    assert got.dtype == dtype and got.device.type == "cpu"
    return got.float().numpy()


@pytest.mark.parametrize("s,hq,hkv,d", [(128, 4, 4, 32), (256, 4, 2, 32),
                                        (192, 8, 2, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_reference(s, hq, hkv, d, causal):
    q, k, v = _qkv(s + hq + d, 2, hq, hkv, s, d)
    got = _port(q, k, v, causal=causal)
    np.testing.assert_allclose(got, _jax_ref(q, k, v, causal=causal),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _blockwise(q, k, v, causal=causal),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (48, 0.0), (0, 30.0),
                                            (64, 20.0)])
def test_window_softcap_matches_reference(window, softcap):
    q, k, v = _qkv(window + int(softcap), 1, 4, 2, 256, 32)
    kw = dict(causal=True, window=window, softcap=softcap)
    got = _port(q, k, v, **kw)
    np.testing.assert_allclose(got, _jax_ref(q, k, v, **kw), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got, _blockwise(q, k, v, **kw), rtol=TOL,
                               atol=TOL)


def test_bfloat16_matches_reference():
    q, k, v = _qkv(3, 1, 4, 2, 128, 32)
    qb, kb, vb = [np.asarray(torch.as_tensor(x).bfloat16().float())
                  for x in (q, k, v)]
    got = _port(qb, kb, vb, dtype=torch.bfloat16, causal=True)
    want = _jax_ref(qb, kb, vb, dtype=jnp.bfloat16, causal=True)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("s", [100, 130, 257])
@pytest.mark.parametrize("causal", [False, True])
def test_ragged_length_equals_unpadded_reference(s, causal):
    # S not a multiple of the 64-row tile: no padding, keys past S masked
    q, k, v = _qkv(s, 1, 4, 2, s, 32)
    got = _port(q, k, v, causal=causal)
    np.testing.assert_allclose(got, _jax_ref(q, k, v, causal=causal),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _blockwise(q, k, v, causal=causal),
                               rtol=TOL, atol=TOL)


def test_reference_wrapper_padding_departs():
    # the reference wrapper's math at S = 100, padded to its 128-row block
    # with zero keys and values that its kernel's mask lets through
    s, blk = 100, 128
    q, k, v = _qkv(11, 1, 4, 2, s, 32)
    pad = [np.concatenate([x, np.zeros(x.shape[:2] + (blk - s, 32),
                                       np.float32)], axis=2)
           for x in (q, k, v)]
    unpadded = _jax_ref(q, k, v, causal=False)
    padded = _jax_ref(*pad, causal=False)[:, :, :s]
    assert np.abs(padded - unpadded).max() > 1e-2
    np.testing.assert_allclose(_port(q, k, v, causal=False), unpadded,
                               rtol=TOL, atol=TOL)
    # causal: the padded keys lie past every query and are masked anyway
    np.testing.assert_allclose(_jax_ref(*pad, causal=True)[:, :, :s],
                               _jax_ref(q, k, v, causal=True), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("s,window,softcap", [(256, 16, 0.0), (256, 64, 10.0),
                                              (150, 40, 0.0)])
def test_window_without_causal_matches_reference(s, window, softcap):
    q, k, v = _qkv(window + s, 1, 4, 2, s, 32)
    kw = dict(causal=False, window=window, softcap=softcap)
    got = _port(q, k, v, **kw)
    np.testing.assert_allclose(got, _jax_ref(q, k, v, **kw), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got, _blockwise(q, k, v, **kw), rtol=TOL,
                               atol=TOL)


def test_gemma_scale_matches_reference():
    # gemma2-27b pre-scales queries by 1/12 (configs/gemma2_27b.py)
    q, k, v = _qkv(12, 1, 4, 2, 192, 48)
    kw = dict(causal=True, window=64, softcap=50.0, scale=1.0 / 12)
    np.testing.assert_allclose(_port(q, k, v, **kw), _jax_ref(q, k, v, **kw),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("causal,window,softcap", [(True, 0, 0.0),
                                                   (False, 0, 0.0),
                                                   (True, 48, 30.0),
                                                   (False, 32, 0.0)])
def test_torch_oracle_matches_reference_oracle(dtype, causal, window,
                                               softcap):
    q, k, v = _qkv(5, 2, 4, 2, 96, 16, getattr(np, dtype))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = t_ref(*[torch.as_tensor(x) for x in (q, k, v)], **kw)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), _jax_ref(q, k, v, **kw),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bk", [1, 16, 64, 100, 512])
def test_plain_block_size_changes_no_result(bk):
    q, k, v = _qkv(8, 1, 4, 2, 200, 16)
    ts = [torch.as_tensor(x) for x in (q, k, v)]
    kw = dict(causal=True, window=50, softcap=20.0)
    np.testing.assert_allclose(attention_plain(*ts, bk=bk, **kw).numpy(),
                               _jax_ref(q, k, v, **kw), rtol=TOL, atol=TOL)


def test_flash_attention_checks_shapes():
    q, k, v = [torch.zeros((1, h, 8, 4)) for h in (3, 2, 2)]
    with pytest.raises(ValueError, match="not a multiple"):
        flash_attention(q, k, v, device="cpu")
    q = torch.zeros((1, 2, 8, 4))
    with pytest.raises(ValueError, match="must be"):
        flash_attention(q, k[:, :, :4], v, device="cpu")
    with pytest.raises(ValueError, match="4-D"):
        flash_attention(q[0], k, v, device="cpu")
    launches = flash_attention.launches
    flash_attention(q, k, v, device="cpu")
    assert flash_attention.launches == launches
