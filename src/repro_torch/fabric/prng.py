"""Threefry-2x32 counter-based PRNG, bit-for-bit equal to ``jax.random``.

The reference placer draws its move schedules with ``jax.random`` (the
threefry2x32 generator in its *partitionable* form, the default of the
JAX releases this package is held against).  Reproducing those bits lets
the port's placements equal the reference's at equal seeds and nonces,
not only under injected streams.  This module ports exactly the calls the
reference makes:

* :func:`prng_key` — ``jax.random.PRNGKey(seed)``;
* :func:`split` — ``jax.random.split(key, num)``;
* :func:`fold_in` — ``jax.random.fold_in(key, data)``;
* :func:`uniform` — ``jax.random.uniform(key, shape, minval=...)``
  (float32, ``maxval=1``);
* :func:`randint` — ``jax.random.randint(key, shape, lo, hi)`` (int32).

The streams also pass through two float32 functions whose results the
reference takes from XLA's CPU backend, and which PyTorch's own ``log``
and ``pow`` miss by an ulp on a few percent of inputs:

* :func:`xla_log` — XLA's float32 ``log``: Eigen's ``plog`` polynomial,
  with the fused multiply-adds that XLA's x86 code generator contracts
  (emulated exactly through float64 with round-to-odd);
* :func:`powf` — XLA lowers float32 ``pow`` to a call of the C library's
  ``powf``, which this module calls through ``ctypes``.

A key is an int64 tensor ``(..., 2)`` holding two uint32 words; keys
carry leading batch dimensions (``split`` of a batch of keys splits each
one), which replaces the reference's ``vmap``.  The bit generation is
integer arithmetic (int64 masked to 32 bits); the port builds every
stream on the host, so a chain sees the same stream whichever device
anneals it.  :func:`move_streams` and
:func:`flat_move_streams` build the annealer's per-step move streams the
way the grouped and flat reference chains do.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Sequence, Tuple

import torch

__all__ = ["prng_key", "split", "fold_in", "random_bits", "uniform",
           "randint", "xla_log", "powf", "move_streams", "flat_move_streams",
           "chain_keys"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 block function on uint32 words held in
    int64 tensors (broadcasting); returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & _M32], dtype=torch.int64)


def _counter_bits(key: torch.Tensor, n: int):
    """Both output words of threefry over counters 0..n-1 for every key
    in ``key`` (..., 2) -> two (..., n) tensors (partitionable layout:
    high counter word 0, low word the flat index)."""
    k0 = key[..., 0:1]
    k1 = key[..., 1:2]
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(k0, k1, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) -> (..., num, 2)."""
    b0, b1 = _counter_bits(key, num)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a 32-bit unsigned ``data``."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    d = torch.full((), data & _M32, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], zero, d)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element: (..., 2) -> (..., n) int64."""
    b0, b1 = _counter_bits(key, n)
    return b0 ^ b1


def uniform(key: torch.Tensor, n: int, minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), minval=minval)`` in float32, as XLA
    computes it inside a jitted function with a constant ``minval``.

    ``jax.random`` computes ``max(lo, (bits - 1) * (1 - lo) + lo)``; with
    ``lo`` a constant below half an ulp of 1, XLA folds ``1 - lo`` to 1
    and reassociates ``(bits - 1) + lo`` to ``bits + (-1 + lo)``, which
    rounds to ``bits - 1``.  So the value is ``max(lo, bits - 1)``.
    """
    lo = _f32(minval)
    if float(_f32(1.0) - lo) != 1.0 or float(_f32(-1.0) + lo) != -1.0:
        raise ValueError(f"minval={minval} is not below half an ulp of 1")
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.maximum(lo, floats)


def randint(key: torch.Tensor, n: int, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, (n,), minval, maxval)`` (int32 range)."""
    k = split(key, 2)
    hi = random_bits(k[..., 0, :], n)
    lo = random_bits(k[..., 1, :], n)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (1 << 16) % span
    mult = (mult * mult & _M32) % span
    off = ((hi % span) * mult + lo % span) & _M32
    return (minval + off % span).to(torch.int32)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a*b + c`` rounded once: the float64 product is exact, the
    float64 sum is rounded to odd, and rounding that to float32 is then
    correct (no double rounding)."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)            # p + c == s + err exactly
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even, torch.nextafter(s, s + err), s)
    return s.to(torch.float32)


#: Eigen plog_float polynomial coefficients (Cephes logf)
_LOG_P = [float(_f32(v)) for v in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1)]
_MIN_NORM = 1.17549435e-38


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log, bit-equal to XLA's CPU ``log`` on x86 with
    FMA (denormal inputs flush to zero, as XLA runs them)."""
    f32 = torch.float32
    x = x.to(f32)
    x = torch.where(x.abs() < _MIN_NORM, torch.zeros_like(x), x)
    bits = torch.maximum(x, _f32(_MIN_NORM)).view(torch.int32)
    e = ((bits >> 23) - 127).to(f32) + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(f32)       # [0.5, 1)
    small = m < _f32(float.fromhex("0x1.6a09e6p-1"))        # sqrt(1/2)
    xm = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.to(f32)
    x2 = xm * xm
    x3 = x2 * xm
    p = _LOG_P
    y0 = _fma(_fma(xm, p[0], p[1]), xm, p[2])
    y1 = _fma(_fma(xm, p[3], p[4]), xm, p[5])
    y2 = _fma(_fma(xm, p[6], p[7]), xm, p[8])
    y = _fma(_fma(y0, x3, y1), x3, y2)
    y = _fma(y, x3, e * float(_f32(-2.12194440e-4)))
    r = _fma(e, 0.693359375, _fma(x2, -0.5, xm) + y)
    r = torch.where(x < 0, torch.full_like(r, float("nan")), r)
    r = torch.where(x == 0, torch.full_like(r, float("-inf")), r)
    return torch.where(x == float("inf"), x, r)


@functools.lru_cache(maxsize=1)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    lib.powf.restype = ctypes.c_float
    return lib


def powf(base: float, exps: torch.Tensor) -> torch.Tensor:
    """``base ** exps`` in float32 through the C library's ``powf`` (the
    call XLA's CPU backend emits for float32 ``pow``)."""
    fn = _libm().powf
    b = float(_f32(base))
    return torch.tensor([fn(b, e) for e in exps.to(torch.float32).tolist()],
                        dtype=torch.float32)


@functools.lru_cache(maxsize=256)
def _temps(t0: float, t1_over_t0: float, s_pad: int, n_steps: int
           ) -> torch.Tensor:
    frac = (torch.arange(s_pad, dtype=torch.float32)
            / _f32(max(float(n_steps), 1.0)))
    return _f32(t0) * powf(t1_over_t0, frac)


def move_streams(keys: torch.Tensor, dims: torch.Tensor, t0s: torch.Tensor,
                 t1: float, s_pad: int):
    """Move streams of the grouped chain (``_build_batch_annealer``).

    keys: (R, 2) one key per chain; dims: (R, 5) int per-chain problem
    dims ``(n_pe_c, n_io_c, n_pe_s, n_io_s, n_steps)``; t0s: (R,) float32.
    Returns ``(a, t, log_u, temps, active, pick_pe)``, each (R, s_pad):
    the swapped entity, its target slot, the Metropolis log-uniform, the
    temperature, the in-budget step mask, and the PE/IO class draw.
    """
    ks = split(keys, 6)                                  # (R, 6, 2)
    d = dims.to(torch.int64)
    n_pe_c, n_io_c, n_pe_s, n_io_s, n_steps = (d[:, j:j + 1]
                                                for j in range(5))
    n_real = torch.clamp(n_pe_c + n_io_c, min=1)
    pick_pe = uniform(ks[:, 0], s_pad) < (n_pe_c.to(torch.float32)
                                          / n_real.to(torch.float32))

    def scaled(k, count, lo):
        u = uniform(k, s_pad)
        idx = torch.minimum((u * count.to(torch.float32)).to(torch.int32),
                            torch.clamp(count - 1, min=0).to(torch.int32))
        return lo + idx

    a = torch.where(pick_pe, scaled(ks[:, 1], n_pe_c, 0),
                    scaled(ks[:, 2], n_io_c, n_pe_s))
    t = torch.where(pick_pe, scaled(ks[:, 3], n_pe_s, 0),
                    scaled(ks[:, 4], n_io_s, n_pe_s))
    log_u = xla_log(uniform(ks[:, 5], s_pad, minval=1e-12))
    temps = torch.stack([
        _temps(float(t0), float(_f32(t1) / _f32(t0)), s_pad, int(n))
        for t0, n in zip(t0s.tolist(), n_steps[:, 0].tolist())])
    active = torch.arange(s_pad) < n_steps
    return (a.to(torch.int32), t.to(torch.int32), log_u, temps, active,
            pick_pe)


def flat_move_streams(keys: torch.Tensor, steps: int, n_pe_c: int,
                      n_io_c: int, n_pe_s: int, n_io_s: int, t0: float,
                      t1: float):
    """Move streams of the flat chain (``_build_annealer``): the same
    outputs as :func:`move_streams` for (R, 2) keys over static counts."""
    ks = split(keys, 6)
    p_pe = n_pe_c / (n_pe_c + n_io_c)
    pick_pe = uniform(ks[:, 0], steps) < _f32(p_pe)
    a = torch.where(pick_pe, randint(ks[:, 1], steps, 0, max(1, n_pe_c)),
                    n_pe_s + randint(ks[:, 2], steps, 0, max(1, n_io_c)))
    t = torch.where(pick_pe, randint(ks[:, 3], steps, 0, n_pe_s),
                    n_pe_s + randint(ks[:, 4], steps, 0, n_io_s))
    log_u = xla_log(uniform(ks[:, 5], steps, minval=1e-12))
    temps = _temps(float(t0), t1 / t0, steps, steps).expand(keys.shape[0],
                                                             steps)
    active = torch.ones((keys.shape[0], steps), dtype=torch.bool)
    return (a.to(torch.int32), t.to(torch.int32), log_u, temps, active,
            pick_pe)


def chain_keys(seed: int, chains: int, nonces: Sequence[int] = None
               ) -> torch.Tensor:
    """Per-chain keys: ``split(PRNGKey(seed), chains)`` (flat path) or,
    with ``nonces``, ``split(fold_in(PRNGKey(seed), nonce & 0x7FFFFFFF),
    chains)`` per problem (grouped path) -> (P*chains, 2) / (chains, 2)."""
    base = prng_key(seed)
    if nonces is None:
        return split(base, chains)
    return torch.cat([split(fold_in(base, n & 0x7FFFFFFF), chains)
                      for n in nonces])
