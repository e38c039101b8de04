"""Public wrappers of the fused-PE kernels, with the semantics of the
JAX package's ``kernels/ops.py``: ``fused_pe_apply`` (K4) and
``matmul_fused`` (K5).  Both run on the card unless ``device="cpu"``
asks for the plain versions.  The attention and selective-scan wrappers
wait for their kernels."""

from __future__ import annotations

from ..graphir.graph import Graph
from .gemm import gemm_pe
from .pe_fused import make_pe_kernel

__all__ = ["fused_pe_apply", "matmul_fused"]


def fused_pe_apply(pattern: Graph, *inputs, block: int = 1024,
                   device="cuda"):
    """Apply a mined/merged PE pattern elementwise over the inputs."""
    return make_pe_kernel(pattern, block=block, device=device)(*inputs)


def matmul_fused(x, w, *extras, epilogue=None, extra_kinds=(),
                 out_dtype=None, device="cuda"):
    """Matmul with a fused PE epilogue, for any M, N, K.

    The reference pads M, N and K to its block sizes and crops the result
    back; K5 masks the ragged edges itself, so nothing is padded and the
    result is the same (M, N) in ``out_dtype or x.dtype``.
    """
    return gemm_pe(x, w, *extras, epilogue=epilogue,
                   extra_kinds=extra_kinds, out_dtype=out_dtype,
                   device=device)
