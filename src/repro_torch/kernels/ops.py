"""Public wrappers of the ML kernels, with the signatures of the JAX
package's ``kernels/ops.py``: ``fused_pe_apply`` (K4), ``attention``
(K6), ``selective_scan`` (K7) and ``matmul_fused`` (K5).  Each runs on
the card unless ``device="cpu"`` asks for the plain versions
(``device`` stands in for the reference's ``interpret``).  The
reference's tile sizes are accepted as hints that change no result: the
kernels mask ragged edges themselves, so nothing is padded."""

from __future__ import annotations

from ..graphir.graph import Graph
from .flash_attention import flash_attention
from .gemm import gemm_pe
from .mamba_scan import mamba_scan
from .pe_fused import DEFAULT_BLOCK, make_pe_kernel

__all__ = ["attention", "fused_pe_apply", "matmul_fused", "selective_scan"]


def fused_pe_apply(pattern: Graph, *inputs, block=DEFAULT_BLOCK,
                   device="cuda"):
    """Apply a mined/merged PE pattern elementwise over the inputs.
    ``block``: K4's elements per program, or the reference's ``(bm, bn)``
    tile."""
    return make_pe_kernel(pattern, block=block, device=device)(*inputs)


def attention(q, k, v, *, causal=True, window=0, softcap=0.0, scale=0.0,
              bq=128, bk=128, device="cuda"):
    """Flash attention; q (B,Hq,S,D), k/v (B,Hkv,S,D), any S.

    Departs from the reference wrapper on purpose: that one pads k/v with
    zero rows its kernel does not mask, so with ``causal=False`` and S not
    a multiple of the block the padded keys enter the softmax.  K6 masks
    keys at ``k_pos >= S`` and equals ``ref_attention``, the reference's
    oracle."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale, bq=bq, bk=bk,
                           device=device)


def selective_scan(a, bx, c, *, bs=128, bd=128, device="cuda"):
    """Mamba selective scan; a/bx (B,S,D,N), c (B,S,N) -> y (B,S,D)
    float32, any S and D."""
    return mamba_scan(a, bx, c, bs=bs, bd=bd, device=device)


def matmul_fused(x, w, *extras, epilogue=None, extra_kinds=(),
                 bm=128, bn=128, bk=128, out_dtype=None, device="cuda"):
    """Matmul with a fused PE epilogue, for any M, N, K.

    The reference pads M, N and K to its block sizes ``bm``, ``bn``,
    ``bk`` and crops the result back; K5 masks the ragged edges itself, so
    the block sizes are accepted and ignored, nothing is padded and the
    result is the same (M, N) in ``out_dtype or x.dtype``.
    """
    return gemm_pe(x, w, *extras, epilogue=epilogue,
                   extra_kinds=extra_kinds, out_dtype=out_dtype,
                   device=device)
