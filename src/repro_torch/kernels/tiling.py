"""Bucket padding shared by the batched annealer (the reference's TPU
tile helpers ``SUBLANE``/``LANE``/``pad2d`` have no Hopper counterpart)."""

from __future__ import annotations


def pow2_bucket(n: int) -> int:
    """Next power of two >= max(n, 1) — the padding granule shared by every
    cross-problem batching scheme in this repo (batched annealing, batched
    cycle simulation).

    Padding each problem to bucket sizes (instead of group-max) makes a
    problem's batched result independent of which other problems share its
    dispatch, so batched artifacts are reproducible and cacheable per
    problem, and the compiled program is reused across explorations."""
    return 1 << max(0, (n - 1)).bit_length()
