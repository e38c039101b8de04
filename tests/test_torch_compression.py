"""The port's int8 gradient compression (``repro_torch.sharding.
compression``) against the JAX package's on the CPU, bit for bit.

``_quantize``/``_dequantize`` run in this process.  ``compressed_psum``
runs on 8 gloo ranks (spawned processes, ``tests/torch_ranks.py``); the
JAX package's runs on one CPU device under ``jax.vmap`` with the axis
named, which gives its collectives the same meaning as ``shard_map`` over
8 devices.  The grad transform runs inside ``build_train_step`` on 2
ranks on a reduced hymba whose d_inner (192) is no multiple of 256, so
blocks straddle the stacked layers: a per-layer blocking gives other
bits, and the test checks that it would."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.sharding import compression as rc
from repro_torch.configs import get_config
from repro_torch.sharding import param_pspecs
from repro_torch.sharding import compression as tc
from torch_ranks import grad_transform_rank, psum_rank, run_ranks


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _ties(n: int) -> np.ndarray:
    """Blocks whose maximum is 127, so the scale is 1 and every x.5 is a
    tie that rounds half to even."""
    x = (np.arange(n) % 9 - 4.5).astype(np.float32)
    x[::BLOCK_] = 127.0
    return x


BLOCK_ = 256

QUANT_CASES = {
    "random_1000": lambda r: r.normal(size=1000).astype(np.float32) * 3,
    "random_2d": lambda r: r.normal(size=(3, 100)).astype(np.float32),
    "exact_256": lambda r: r.normal(size=256).astype(np.float32),
    "short_7": lambda r: r.normal(size=7).astype(np.float32),
    "zero_block": lambda r: np.concatenate(
        [np.zeros(256, np.float32), r.normal(size=300).astype(np.float32)]),
    "ties": lambda r: _ties(600),
    "tiny": lambda r: r.normal(size=500).astype(np.float32) * 1e-14,
}


def test_block_is_the_reference():
    assert tc.BLOCK == rc.BLOCK == BLOCK_


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantize_equals_reference(case):
    x = QUANT_CASES[case](np.random.default_rng(0))
    qj, sj = rc._quantize(jnp.asarray(x))
    qt, st_ = tc._quantize(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st_.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(st_.numpy()), _bits(sj))
    dj = rc._dequantize(qj, sj, x.shape, x.size)
    dt = tc._dequantize(qt, st_, x.shape, x.size)
    assert tuple(dt.shape) == x.shape
    np.testing.assert_array_equal(_bits(dt.numpy()), _bits(dj))


@settings(max_examples=30, deadline=None)
@given(st.lists(st.floats(-1e4, 1e4, allow_nan=False, width=32),
                min_size=1, max_size=700))
def test_int8_compression_error_bound(vals):
    """Quantization error <= half an LSB of the block scale (the twin of
    tests/test_property.py's)."""
    x = torch.tensor(np.asarray(vals, np.float32))
    q, scale = tc._quantize(x)
    n = x.shape[0]
    deq = (q.float() * scale).reshape(-1)[:n]
    err = (deq - x).abs().numpy()
    scales = np.repeat(scale[:, 0].numpy(), tc.BLOCK)[:n]
    assert np.all(err <= scales * 0.5 + 1e-6)


def _jax_psum(x: np.ndarray, axes) -> np.ndarray:
    """The JAX package's ``compressed_psum`` on every shard of ``x``
    (leading dims: one per axis), the axes named by nested ``vmap``."""
    fn = lambda v: rc.compressed_psum(v, axes)
    for a in reversed(axes):
        fn = jax.vmap(fn, axis_name=a)
    return np.asarray(fn(jnp.asarray(x)))


#: name -> (the 8 shards, mesh axes or None for the WORLD group)
PSUM_CASES = {
    # tests/test_distributed_subprocess.py's input
    "normal_8x512": (lambda r: r.normal(size=(8, 512)), None),
    # a length that is no multiple of 256, a zero block, ties
    "ragged_ties": (lambda r: np.stack(
        [np.concatenate([np.zeros(256), _ties(44) * (i % 3 - 1),
                         r.normal(size=100)]) for i in range(8)]), None),
    # two data-parallel axes: MAX and SUM over each group in turn
    "two_axes": (lambda r: r.normal(size=(2, 4, 3, 200)) * 10,
                 ("pod", "data")),
}


@pytest.mark.parametrize("case", sorted(PSUM_CASES))
def test_compressed_psum_equals_reference(case, tmp_path):
    make, axes = PSUM_CASES[case]
    x = make(np.random.default_rng(0)).astype(np.float32)
    got = run_ranks(psum_rank, 8, tmp_path, x, axes)
    want = _jax_psum(x, axes or ("data",))
    flat_want = want.reshape((8,) + want.shape[len(axes or "d"):])
    for r in range(8):
        np.testing.assert_array_equal(_bits(got[r].numpy()),
                                      _bits(flat_want[r]))
    # every rank holds the same quantized mean, within 1.5 block scales
    # of the float mean (the JAX test's bound)
    mean = x.reshape(flat_want.shape).mean(axis=0)
    scale = np.abs(x).max() / 127.0
    assert np.abs(flat_want[0] - mean).max() <= scale * 1.5


HYMBA = dict(n_layers=2, d_model=96, vocab=64)


def test_grad_transform_in_train_step_equals_stacked_reference(tmp_path):
    got = run_ranks(grad_transform_rank, 2, tmp_path, "hymba-1.5b", HYMBA,
                    2, 16)
    raw = [g["raw"] for g in got]
    assert raw[0].keys() == got[0]["reduced"].keys()
    straddle = []
    for name in raw[0]:
        shards = np.stack([r[name] for r in raw])
        # the ranks' own batches give them different gradients
        assert not np.array_equal(shards[0], shards[1]), name
        want = _jax_psum(shards, ("data",))
        for r in range(2):
            np.testing.assert_array_equal(
                _bits(got[r]["reduced"][name]), _bits(want[r]),
                err_msg=name)
        if name.startswith("layers__") and shards[0, 0].size % BLOCK_:
            per_layer = np.stack([_jax_psum(shards[:, i], ("data",))
                                  for i in range(shards.shape[1])], axis=1)
            if not np.array_equal(_bits(per_layer), _bits(want)):
                straddle.append(name)
    # a per-layer blocking would fail the comparison above on these
    assert {"layers__ssm_D", "layers__ssm_conv_b",
            "layers__ssm_dt_bias"} <= set(straddle)


def test_grad_transform_refuses_sharded_leaves():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    cfg = get_config("hymba-1.5b").reduced(**HYMBA)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        with pytest.raises(ValueError, match="sharded over 'model'"):
            tc.make_compressed_grad_transform(
                mesh, ("data",), param_pspecs(cfg, axis_size=4))
        tc.make_compressed_grad_transform(mesh, ("data",), None)
    finally:
        dist.destroy_process_group()
