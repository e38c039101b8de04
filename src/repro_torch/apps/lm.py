"""LM-architecture idiom graphs: the assigned archs as DSE applications.

Torch twins of the JAX package's ``repro.apps.lm``.  Each function is the
elementwise/compute structure of one transformer-layer family at tiny
dims, traced into a Graph by :func:`repro_torch.graphir.trace.trace_fn`;
the DSE pipeline mines them exactly like the paper's image apps.
Matmuls stay macro nodes; the mined patterns are the *elementwise
idioms* (RMSNorm cores, SwiGLU gates, softcaps, router chains, SSM
updates), the chains the generated fused-PE kernel K4
(``kernels/pe_fused.py``) keeps out of device memory.

The twins are written with PyTorch's own ops (``torch.mean``,
``F.silu``, ``F.gelu``, ``torch.softmax``, ``F.softplus``,
``torch.topk``); the tracer decomposes the ones ATen keeps whole into
the jaxpr's sequences, so each graph equals its JAX twin's.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..graphir.graph import Graph
from ..graphir.trace import trace_fn

__all__ = ["dense_layer", "gemma_layer", "lm_idiom_graphs", "moe_router",
           "ssm_update"]

_D, _F, _H, _N = 8, 16, 2, 4


def _rms(x, w):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-6) * w


def dense_layer(x, wq, wk, wo, wg, wu, wd, ln1, ln2):
    """llama-family: rmsnorm -> qk rope-ish mix -> swiglu."""
    h = _rms(x, ln1)
    q = h @ wq
    k = h @ wk
    mix = torch.tanh(q * 0.5) * k        # stand-in for the attention mix
    x = x + mix @ wo
    h2 = _rms(x, ln2)
    return x + (F.silu(h2 @ wg) * (h2 @ wu)) @ wd


def gemma_layer(x, wq, wk, wo, wg, wu, wd, ln1, ln2):
    """gemma-family: softcap + geglu."""
    h = _rms(x, ln1)
    s = (h @ wq) * (h @ wk).sum(-1, keepdim=True)
    s = 50.0 * torch.tanh(s / 50.0)      # attn logit softcap
    x = x + (s * h) @ wo
    h2 = _rms(x, ln2)
    return x + (F.gelu(h2 @ wg, approximate="tanh") * (h2 @ wu)) @ wd


def moe_router(x, wr):
    """qwen-family router: softmax -> top-k -> renormalize."""
    logits = x @ wr
    p = torch.softmax(logits, dim=-1)
    v, _ = torch.topk(p, 2)
    return v / (v.sum(-1, keepdim=True) + 1e-9)


def ssm_update(dt, a, b, x, h, c):
    """mamba-family state update: the per-step chain the scan kernel
    fuses."""
    da = torch.exp(F.softplus(dt)[..., None] * a)
    h2 = da * h + (dt * x)[..., None] * b[..., None, :]
    return (h2 * c[..., None, :]).sum(-1) * F.silu(x)


def lm_idiom_graphs(device="cuda") -> Dict[str, Graph]:
    """The four idiom graphs, traced on ones on ``device``."""
    dev = resolve_device(device)

    def w(*s):
        return torch.ones(s, dtype=torch.float32, device=dev)
    return {
        "lm_dense": trace_fn(dense_layer, w(2, _D), w(_D, _D), w(_D, _D),
                             w(_D, _D), w(_D, _F), w(_D, _F), w(_F, _D),
                             w(_D), w(_D)),
        "lm_gemma": trace_fn(gemma_layer, w(2, _D), w(_D, _D), w(_D, _D),
                             w(_D, _D), w(_D, _F), w(_D, _F), w(_F, _D),
                             w(_D), w(_D)),
        "lm_router": trace_fn(moe_router, w(2, _D), w(_D, 8)),
        "lm_ssm": trace_fn(ssm_update, w(2, _D), w(_D, _N), w(2, _N),
                           w(2, _D), w(2, _D, _N), w(2, _N)),
    }
