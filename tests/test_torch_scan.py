"""The port's selective scan (K7's plain version, ``device="cpu"``)
against the JAX package on the same seeded numpy inputs: the Pallas
wrapper ``repro.kernels.ops.selective_scan`` in interpret mode and the
oracle ``repro.kernels.ref.ref_mamba_scan``, at ``tests/test_kernels.py``'s
cases, inputs (a ~ U(0.6, 0.999), bx ~ N(0, 0.1^2), c ~ N(0, 1)) and
tolerance (rtol = atol = 1e-4: the sum over states taken in another
order), plus a ragged (S, D) that the reference wrapper pads and the port
does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import selective_scan as r_scan
from repro.kernels.ref import ref_mamba_scan as r_ref
from repro_torch.kernels import mamba_scan, selective_scan
from repro_torch.kernels.ref import ref_mamba_scan as t_ref

TOL = 1e-4


def _inputs(seed, b, s, d, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.6, 0.999, (b, s, d, n)).astype(dtype)
    bx = (rng.normal(size=(b, s, d, n)) * 0.1).astype(dtype)
    c = rng.normal(size=(b, s, n)).astype(dtype)
    return a, bx, c


def _jax(fn, xs, dtype=jnp.float32, **kw):
    return np.asarray(fn(*[jnp.asarray(x, dtype) for x in xs], **kw))


@pytest.mark.parametrize("s,d,n", [(64, 32, 4), (96, 64, 8), (128, 128, 16),
                                   (100, 50, 8)])
def test_scan_matches_reference(s, d, n):
    xs = _inputs(s + d + n, 2, s, d, n)
    got = selective_scan(*xs, bs=32, bd=32, device="cpu")
    assert got.shape == (2, s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), _jax(r_scan, xs, bs=32, bd=32, interpret=True),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), _jax(r_ref, xs), rtol=TOL,
                               atol=TOL)


def test_bfloat16_inputs_match_reference():
    xs = [np.asarray(torch.as_tensor(x).bfloat16().float())
          for x in _inputs(4, 1, 64, 32, 4)]
    got = selective_scan(*[torch.as_tensor(x).bfloat16() for x in xs],
                         device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), _jax(r_scan, xs, jnp.bfloat16, bs=32, bd=32,
                          interpret=True), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("s,d,n", [(40, 24, 4), (33, 17, 5)])
def test_torch_oracle_matches_reference_oracle(dtype, s, d, n):
    xs = _inputs(n, 2, s, d, n, getattr(np, dtype))
    got = t_ref(*[torch.as_tensor(x) for x in xs])
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), _jax(r_ref, xs),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bs,bd", [(1, 1), (7, 13), (128, 128)])
def test_block_sizes_change_no_result(bs, bd):
    xs = _inputs(9, 1, 30, 20, 3)
    want = selective_scan(*xs, device="cpu")
    got = selective_scan(*xs, bs=bs, bd=bd, device="cpu")
    assert torch.equal(got, want)


def test_scan_checks_shapes():
    a = torch.ones((1, 4, 3, 2))
    with pytest.raises(ValueError, match="c must be"):
        mamba_scan(a, a, torch.ones((1, 3, 2)), device="cpu")
    with pytest.raises(ValueError, match="one shape"):
        mamba_scan(a, a[:, :2], torch.ones((1, 4, 2)), device="cpu")
    launches = mamba_scan.launches
    mamba_scan(a, a, torch.ones((1, 4, 2)), device="cpu")
    assert mamba_scan.launches == launches
