"""Mamba-1 selective state-space mixer (falcon-mamba / hymba SSM heads).

The port of the JAX package's ``repro.models.ssm.mamba_mixer``, op for op
and dtype for dtype: products promote mixed operands as JAX does (hymba
feeds bfloat16 activations into float32 weights), the depthwise causal
convolution is the same sum over taps in the operands' dtype, and
``dt`` goes through ``layers.softplus`` (JAX's op sequence).

Prefill (S > 1) discretizes in float32 (``da = exp(dt * a)``, ``dbx = (dt
* x) * B``, each (B, S, d_inner, N)) and runs the selective scan on K7
(``repro_torch.kernels.mamba_scan.mamba_scan``, imported by name here so
that a check can swap it; its plain version for tensors on the CPU), from
the carried state and returning the last one when asked.  Decode (S == 1)
is the one-step recurrence in plain PyTorch, as the JAX package has no
kernel for it either.  The JAX package's perf-flag variants of the scan
(``_ssm_scan_sequential``, ``_ssm_scan_streamed``) are not ported: they
come with the flags and the launcher that sets them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan import mamba_scan
from .config import SSMConfig
from .layers import _silu, softplus

__all__ = ["discretize", "mamba_mixer"]


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.einsum``."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def discretize(dt: torch.Tensor, xi: torch.Tensor, bmat: torch.Tensor,
               a: torch.Tensor):
    """The scan's inputs in float32: ``da = exp(dt * a)`` and ``dbx = (dt
    * xi) * B`` (``dt * xi`` in the operands' dtype), each (B, S, di, N),
    from dt, xi (B, S, di), B (B, S, N) and a (di, N)."""
    f32 = torch.float32
    da = torch.exp(dt.to(f32)[..., None] * a[None, None])
    dbx = (dt * xi).to(f32)[..., None] * bmat.to(f32)[:, :, None, :]
    return da, dbx


def mamba_mixer(x: torch.Tensor, params: Dict[str, torch.Tensor],
                ssm: SSMConfig, *,
                state: Optional[Dict[str, torch.Tensor]] = None,
                return_state: bool = False):
    """Mamba-1 block.  x: (B, S, d_model).

    params: in_proj (d, 2*di), conv_w (K, di), conv_b (di), x_proj
    (di, dt_rank+2N), dt_proj (dt_rank, di), dt_bias (di), A_log (di, N),
    D (di), out_proj (di, d).
    state (decode): {"conv": (B, K-1, di), "h": (B, di, N) float32}.
    Returns out (B, S, d), and with ``return_state`` also the new state,
    its ``conv`` in the dtype of the window it was cut from.
    """
    b, s, d = x.shape
    di = params["conv_w"].shape[1]
    n = ssm.d_state
    kw = params["conv_w"].shape[0]

    xi, z = _matmul(x, params["in_proj"]).chunk(2, dim=-1)   # (B,S,di) each

    # depthwise causal conv over time ------------------------------------
    if state is not None:
        prev = state["conv"]                                 # (B, K-1, di)
        xi_pad = torch.cat([prev, xi], dim=1)                # promotes
        new_conv = xi_pad[:, -(kw - 1):] if kw > 1 else prev
    else:
        xi_pad = F.pad(xi, (0, 0, kw - 1, 0))
        new_conv = xi_pad[:, -(kw - 1):] if kw > 1 else None
    conv = sum(xi_pad[:, i:i + s] * params["conv_w"][i][None, None]
               for i in range(kw))
    xi = _silu(conv + params["conv_b"][None, None])

    # input-dependent SSM parameters ------------------------------------------
    proj = _matmul(xi, params["x_proj"])
    dt_rank = ssm.dt_rank_of(d)
    dt, bmat, cmat = proj.split([dt_rank, n, n], dim=-1)
    dt = softplus(_matmul(dt, params["dt_proj"])
                  + params["dt_bias"][None, None])            # (B,S,di)
    a = -torch.exp(params["A_log"].float())                   # (di, N)

    f32 = torch.float32
    h0 = state["h"] if state is not None else None
    da, dbx = discretize(dt, xi, bmat, a)                     # (B,S,di,N)
    if s == 1:                                     # decode: one step
        if h0 is None:
            h0 = torch.zeros((b, di, n), dtype=f32, device=x.device)
        h_last = da[:, 0] * h0 + dbx[:, 0]
        y = torch.einsum("bdn,bn->bd", h_last, cmat[:, 0].to(f32))[:, None]
    else:                                          # prefill: K7
        out = mamba_scan(da, dbx, cmat.to(f32), h0=h0,
                         return_state=return_state, device=x.device)
        y, h_last = out if return_state else (out, None)
    y = y + xi.to(f32) * params["D"][None, None]
    y = y * _silu(z.to(f32))
    out = _matmul(y.to(x.dtype), params["out_proj"])

    if return_state:
        new_state = {"conv": new_conv if new_conv is not None else
                     torch.zeros((b, max(kw - 1, 1), di), dtype=x.dtype,
                                 device=x.device),
                     "h": h_last}
        return out, new_state
    return out
