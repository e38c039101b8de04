"""Oracles for the ML kernels, copies of the JAX package's
``kernels/ref.py``: graph interpretation in float64 numpy over this
package's own interpreter (fused PE, GEMM epilogue), the direct softmax
over the full score matrix (attention) and the plain sequential
recurrence (selective scan).  The last two compute in float64 when given
float64 and in float32 otherwise."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..graphir.graph import Graph, free_in_ports, sink_nodes
from ..graphir.interp import interpret_pattern

__all__ = ["ref_pe", "ref_gemm_pe", "ref_attention", "ref_mamba_scan"]


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


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def ref_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                  scale=0.0) -> torch.Tensor:
    """Oracle for flash_attention: direct softmax over the full score
    matrix.  q (B,Hq,S,D); k/v (B,Hkv,S,D); returns (B,Hq,S,D) in q's
    dtype."""
    q, k, v = (torch.as_tensor(t) for t in (q, k, v))
    ct = _compute_dtype(q)
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    scale = scale or 1.0 / math.sqrt(d)
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    sarr = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct)) * scale
    if softcap:
        sarr = softcap * torch.tanh(sarr / softcap)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    sarr = torch.where(mask[None, None], sarr,
                       torch.tensor(-1e30, dtype=ct, device=q.device))
    p = torch.softmax(sarr, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(ct)).to(q.dtype)


def ref_mamba_scan(a, bx, c) -> torch.Tensor:
    """Oracle for mamba_scan: the plain sequential recurrence
    ``h_t = a_t * h_{t-1} + bx_t``, ``y_t = sum_n h_t * c_t``.  a/bx
    (B,S,D,N), c (B,S,N); returns y (B,S,D)."""
    a, bx, c = (torch.as_tensor(t) for t in (a, bx, c))
    ct = _compute_dtype(a)
    b, s, d, n = a.shape
    h = torch.zeros((b, d, n), dtype=ct, device=a.device)
    ys = []
    for t in range(s):
        h = a[:, t].to(ct) * h + bx[:, t].to(ct)
        ys.append(torch.sum(h * c[:, t].to(ct)[:, None, :], dim=-1))
    return torch.stack(ys, dim=1)
