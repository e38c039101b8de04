"""Oracles for the fused-PE kernels: graph interpretation in float64
numpy (copies of the JAX package's ``kernels/ref.py`` over this package's
own interpreter).  The attention and selective-scan oracles wait for
their kernels."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..graphir.graph import Graph, free_in_ports, sink_nodes
from ..graphir.interp import interpret_pattern

__all__ = ["ref_pe", "ref_gemm_pe"]


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().to(torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def ref_pe(pattern: Graph, *inputs) -> Tuple:
    """Oracle for pe_fused.make_pe_kernel: numpy graph interpretation."""
    free = free_in_ports(pattern)
    port_values = {fp: _f64(x) for fp, x in zip(free, inputs)}
    vals = interpret_pattern(pattern, port_values)
    outs = tuple(vals[s] for s in sink_nodes(pattern))
    return outs if len(outs) > 1 else outs[0]


def ref_gemm_pe(x, w, *extras, epilogue=None, extra_kinds=(),
                out_dtype=None) -> torch.Tensor:
    """Oracle for gemm.gemm_pe: a float32 product, then the epilogue
    interpreted in float64 numpy on it; cast to ``out_dtype or x.dtype``."""
    x, w = torch.as_tensor(x), torch.as_tensor(w)
    acc = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    if epilogue is not None:
        free = free_in_ports(epilogue)
        port_values = {free[0]: _f64(acc)}
        for fp, e, kind in zip(free[1:], extras, extra_kinds):
            v = _f64(e)
            if kind == "vec":
                v = v[None, :]
            port_values[fp] = v
        vals = interpret_pattern(epilogue, port_values)
        acc = torch.as_tensor(np.broadcast_to(
            vals[sink_nodes(epilogue)[0]], tuple(acc.shape)).copy())
    return acc.to(out_dtype or x.dtype)
