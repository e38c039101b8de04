"""Bucket padding shared by the batched annealer, and the reference's TPU
tile helpers (``SUBLANE``, ``LANE``, :func:`round_up`, :func:`pad2d`),
kept for callers of the reference's API: no Hopper kernel pads to them."""

from __future__ import annotations

import torch

#: float32 VMEM tile shape (sublane x lane) of the reference's kernels
SUBLANE = 8
LANE = 128


def round_up(n: int, k: int) -> int:
    """Smallest multiple of k that is >= max(n, k)."""
    return max(k, (n + k - 1) // k * k)


def pow2_bucket(n: int) -> int:
    """Next power of two >= max(n, 1) — the padding granule shared by every
    cross-problem batching scheme in this repo (batched annealing, batched
    cycle simulation).

    Padding each problem to bucket sizes (instead of group-max) makes a
    problem's batched result independent of which other problems share its
    dispatch, so batched artifacts are reproducible and cacheable per
    problem, and the compiled program is reused across explorations."""
    return 1 << max(0, (n - 1)).bit_length()


def pad2d(x, fill=0):
    """A 2-D tensor (or array) padded to the float32 VMEM tile grid: rows
    to a SUBLANE multiple, columns to a LANE multiple, each at least one
    tile.  Returns ``x`` itself when it is already on the grid; else a new
    tensor of its dtype and device, ``fill`` in the padding."""
    x = torch.as_tensor(x)
    r, c = x.shape
    rp, cp = round_up(r, SUBLANE), round_up(c, LANE)
    if (rp, cp) == (r, c):
        return x
    out = torch.full((rp, cp), fill, dtype=x.dtype, device=x.device)
    out[:r, :c] = x
    return out
