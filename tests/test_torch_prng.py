"""The port's threefry PRNG and move streams against ``jax.random``.

Tolerance: exact equality everywhere.  The key, bit, uniform and randint
outputs are integer or bit-pattern results; ``log_u`` and ``temps`` go
through float32 ``log``/``pow``, which the port reproduces as XLA's CPU
backend computes them (Eigen's log polynomial with x86 FMA contraction,
and the C library's ``powf``), so they too match bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.fabric import prng

SEEDS = [0, 1, 7, 12345, 2 ** 31 - 1]


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in(seed):
    k = jax.random.PRNGKey(seed)
    assert (_np(k) == prng.prng_key(seed).numpy()).all()
    for num in (1, 2, 6, 33):
        assert (_np(jax.random.split(k, num))
                == prng.split(prng.prng_key(seed), num).numpy()).all()
    for data in (0, 5, 0x7FFFFFFF, 123456789):
        assert (_np(jax.random.fold_in(k, data))
                == prng.fold_in(prng.prng_key(seed), data).numpy()).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 7, 1000])
def test_uniform_randint_bits(seed, n):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 99)
    kt = prng.fold_in(prng.prng_key(seed), 99)
    for minval in (0.0, 1e-12):
        # jitted with a constant minval, as the reference chains run it
        uj = np.asarray(jax.jit(lambda k: jax.random.uniform(
            k, (n,), minval=minval))(kj))
        ut = prng.uniform(kt, n, minval).numpy()
        assert (uj.view(np.int32) == ut.view(np.int32)).all()
    for lo, hi in ((0, 1), (0, 5), (3, 100), (0, 289), (0, 70000)):
        rj = np.asarray(jax.random.randint(kj, (n,), lo, hi))
        assert (rj == prng.randint(kt, n, lo, hi).numpy()).all()


def test_batched_keys_equal_vmap():
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    uj = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (64,)))(keys))
    ut = prng.uniform(torch.from_numpy(_np(keys)), 64).numpy()
    assert (uj == ut).all()


def test_log_bit_exact():
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(11), (1 << 18,),
                                      minval=1e-12))
    u = np.concatenate([u, np.float32([1e-12, 1.0, 0.5, 3e-38])])
    lj = np.asarray(jnp.log(u))
    lt = prng.xla_log(torch.from_numpy(u.copy())).numpy()
    assert (lj.view(np.int32) == lt.view(np.int32)).all()


# -- the reference's stream code (fabric/place.py:463-481 and 269-285),
# jitted and vmapped as the reference runs it ----------------------------
def _ref_grouped(key, dims, t0, t1, s_pad):
    n_pe_c, n_io_c, n_pe_s, n_io_s, n_steps = (dims[0], dims[1], dims[2],
                                               dims[3], dims[4])
    n_real = jnp.maximum(n_pe_c + n_io_c, 1)
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    pick_pe = (jax.random.uniform(k1, (s_pad,))
               < n_pe_c.astype(jnp.float32) / n_real.astype(jnp.float32))

    def scaled(k, count, lo):
        u = jax.random.uniform(k, (s_pad,))
        idx = jnp.minimum((u * count).astype(jnp.int32),
                          jnp.maximum(count - 1, 0))
        return lo + idx

    a = jnp.where(pick_pe, scaled(k2, n_pe_c, 0), scaled(k3, n_io_c, n_pe_s))
    t = jnp.where(pick_pe, scaled(k4, n_pe_s, 0), scaled(k5, n_io_s, n_pe_s))
    log_u = jnp.log(jax.random.uniform(k6, (s_pad,), minval=1e-12))
    frac = (jnp.arange(s_pad, dtype=jnp.float32)
            / jnp.maximum(n_steps.astype(jnp.float32), 1.0))
    temps = t0 * (t1 / t0) ** frac
    active = jnp.arange(s_pad) < n_steps
    return a, t, log_u, temps, active, pick_pe


def _ref_flat_temps(steps, t0, t1):
    # eager, at build time, as _build_annealer computes it
    return t0 * (t1 / t0) ** (jnp.arange(steps, dtype=jnp.float32) / steps)


def _ref_flat(key, steps, n_pe_c, n_io_c, n_pe_s, n_io_s):
    p_pe = n_pe_c / (n_pe_c + n_io_c)
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    pick_pe = jax.random.uniform(k1, (steps,)) < p_pe
    a = jnp.where(pick_pe,
                  jax.random.randint(k2, (steps,), 0, max(1, n_pe_c)),
                  n_pe_s + jax.random.randint(k3, (steps,), 0,
                                              max(1, n_io_c)))
    t = jnp.where(pick_pe, jax.random.randint(k4, (steps,), 0, n_pe_s),
                  n_pe_s + jax.random.randint(k5, (steps,), 0, n_io_s))
    log_u = jnp.log(jax.random.uniform(k6, (steps,), minval=1e-12))
    return a, t, log_u, pick_pe


def _eq(x, y):
    x, y = np.asarray(x), np.asarray(y)
    if x.dtype == np.float32:
        return (x.view(np.int32) == y.view(np.int32)).all()
    return (x == y).all()


@pytest.mark.parametrize("s_pad,dims", [
    (512, [(10, 6, 16, 32, 320), (7, 0, 16, 32, 448)]),
    (16384, [(307, 69, 306, 70, 12032), (40, 30, 64, 64, 2240)]),
])
def test_grouped_streams(s_pad, dims):
    chains, nonces, t1 = 3, [17, 0x9ABCDEF1], 0.02
    base = jax.random.PRNGKey(5)
    keys = np.concatenate([np.asarray(jax.random.split(
        jax.random.fold_in(base, n & 0x7FFFFFFF), chains)) for n in nonces])
    d = np.repeat(np.asarray(dims, np.int32), chains, axis=0)
    t0s = np.repeat(np.asarray([0.5 * (r + c) for r, c in ((4, 4), (18, 17))],
                               np.float32), chains)
    ref = jax.jit(jax.vmap(lambda k, dd, t0: _ref_grouped(k, dd, t0, t1,
                                                          s_pad)))(keys, d, t0s)
    tk = prng.chain_keys(5, chains, nonces)
    assert (tk.numpy() == _np(keys)).all()
    got = prng.move_streams(tk, torch.from_numpy(d), torch.from_numpy(t0s),
                            t1, s_pad)
    for name, r, g in zip(("a", "t", "log_u", "temps", "active", "pick_pe"),
                          ref, got):
        assert _eq(r, g.numpy()), name


@pytest.mark.parametrize("counts", [(10, 6, 16, 32), (3, 0, 16, 32),
                                    (30, 12, 64, 32)])
def test_flat_streams(counts):
    n_pe_c, n_io_c, n_pe_s, n_io_s = counts
    chains, steps = 4, 8 * (n_pe_c + n_io_c)
    t0, t1 = 4.0, 0.02
    keys = jax.random.split(jax.random.PRNGKey(2), chains)
    ref = jax.jit(jax.vmap(lambda k: _ref_flat(
        k, steps, n_pe_c, n_io_c, n_pe_s, n_io_s)))(keys)
    ref_temps = _ref_flat_temps(steps, t0, t1)
    got = prng.flat_move_streams(prng.chain_keys(2, chains), steps, n_pe_c,
                                 n_io_c, n_pe_s, n_io_s, t0, t1)
    a, t, log_u, temps, active, pick = got
    assert _eq(ref[0], a.numpy()) and _eq(ref[1], t.numpy())
    assert _eq(ref[2], log_u.numpy())
    assert _eq(np.broadcast_to(ref_temps, temps.shape), temps.numpy())
    assert _eq(ref[3], pick.numpy()) and bool(active.all())
