"""Mamba-1 selective state-space mixer (falcon-mamba / hymba SSM heads).

The port of the JAX package's ``repro.models.ssm.mamba_mixer``, op for op
and dtype for dtype: products promote mixed operands as JAX does (hymba
feeds bfloat16 activations into float32 weights), the depthwise causal
convolution is the same sum over taps in the operands' dtype, and
``dt`` goes through ``layers.softplus`` (JAX's op sequence).

Prefill (S > 1) runs the JAX package's three variants, chosen by
``perf_flags.ssm_impl``:

* ``"materialized"`` (the default) discretizes in float32 (``da = exp(dt
  * a)``, ``dbx = (dt * x) * B``, each (B, S, d_inner, N)) and runs the
  selective scan on K7 (``repro_torch.kernels.mamba_scan.mamba_scan``,
  imported by name here so that a check can swap it; its plain version
  for tensors on the CPU) once, from the carried state and returning the
  last one when asked;
* ``"streamed"`` discretizes ``ssm_chunk`` steps at a time and runs K7 on
  each chunk, the state carried from one chunk's ``h_out`` to the next
  one's ``h0``, so ``da``/``dbx`` are (B, chunk, d_inner, N) and never
  (B, S, d_inner, N); with ``ssm_state_dtype="bf16"`` they are rounded
  to bfloat16 where the JAX package rounds them and K7 reads them back
  as float32 (the JAX package combines them in a bfloat16 associative
  scan instead);
* ``"sequential"`` is the per-step recurrence in plain PyTorch, as in the
  JAX package, which has no kernel for it either (K7 needs the
  discretized inputs this variant exists to avoid).

Decode (S == 1) is the one-step recurrence in plain PyTorch, as the JAX
package has no kernel for it either.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.mamba_scan import mamba_scan
from ..kernels.sharded import batch_only, constrain, conv_dtensor, is_dtensor
from .config import SSMConfig
from .layers import _silu, softplus
from .perf_flags import get_flags

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


def _scan_sequential(dt, bmat, cmat, xi, a, h0):
    """The per-step recurrence: the state expanded and y contracted a step
    at a time, nothing with an (S, d_inner, N) extent formed.  dt, xi (B,
    S, di); bmat, cmat (B, S, N); a (di, N); h0 (B, di, N) float32.
    Returns y (B, S, di) float32 and the last state."""
    f32 = torch.float32
    h, ys = h0, []
    for t in range(dt.shape[1]):
        da = torch.exp(dt[:, t].to(f32)[..., None] * a[None])
        h = da * h + (dt[:, t] * xi[:, t]).to(f32)[..., None] \
            * bmat[:, t].to(f32)[:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, t].to(f32)))
    return torch.stack(ys, dim=1), h


def _scan_streamed(dt, bmat, cmat, xi, a, h0, *, chunk: int,
                   state_dtype=torch.float32):
    """K7 a chunk of ``chunk`` steps at a time, each chunk discretized on
    its own and, with ``state_dtype`` bfloat16, rounded to it; the state
    carried across chunks.  Under autograd each chunk is checkpointed (its
    ``da``/``dbx`` made again in the backward), as the JAX package's scan
    body is.  Arguments as :func:`_scan_sequential`'s (``h0`` may be
    None: zero).  Returns y (B, S, di) float32 and the last state."""
    f32 = torch.float32

    def one(dt_c, x_c, b_c, c_c, h):
        da, dbx = discretize(dt_c, x_c, b_c, a)
        if state_dtype != f32:
            da, dbx = da.to(state_dtype).to(f32), dbx.to(state_dtype).to(f32)
        return mamba_scan(da, dbx, c_c.to(f32), h0=h, return_state=True,
                          device=dt_c.device)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (dt, bmat, cmat, xi, a))
    h, ys = h0, []
    for c0 in range(0, dt.shape[1], chunk):
        args = tuple(t[:, c0:c0 + chunk] for t in (dt, xi, bmat, cmat))
        y, h = (checkpoint(one, *args, h, use_reentrant=False) if grad
                else one(*args, h))
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _causal_conv(xi: torch.Tensor, conv_w: torch.Tensor,
                 prev: Optional[torch.Tensor]):
    """The depthwise causal conv over time, a sum over taps in the
    operands' dtype: xi (B, S, di) after the window ``prev`` (B, K-1, di),
    or after K-1 zero rows when it is None; conv_w (K, di).  Returns the
    sum (B, S, di) and the window it leaves, the last K-1 rows (B, K-1,
    di)."""
    kw, s = conv_w.shape[0], xi.shape[1]
    if prev is not None:
        xi_pad = torch.cat([prev, xi], dim=1)                # promotes
    else:
        xi_pad = F.pad(xi, (0, 0, kw - 1, 0))
    conv = sum(xi_pad[:, i:i + s] * conv_w[i][None, None]
               for i in range(kw))
    return conv, xi_pad[:, xi_pad.shape[1] - (kw - 1):]


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
    prev = state["conv"] if state is not None else None      # (B, K-1, di)
    if is_dtensor(xi, params["conv_w"], prev):
        conv, window = conv_dtensor(_causal_conv, xi, params["conv_w"], prev)
    else:
        conv, window = _causal_conv(xi, params["conv_w"], prev)
    new_conv = window if kw > 1 else prev
    xi = _silu(conv + params["conv_b"][None, None])

    # input-dependent SSM parameters ------------------------------------------
    proj = _matmul(xi, params["x_proj"])
    if is_dtensor(proj):
        # x_proj's rows are sharded with the channels, so the product is a
        # partial sum: reduce it here, batch shards kept, so no planner
        # has to place dt, B and C from partial sums (torch 2.11's asks
        # for a shard-to-partial redistribution it does not support)
        proj = constrain(proj, batch_only(proj.placements))
    dt_rank = ssm.dt_rank_of(d)
    dt, bmat, cmat = proj.split([dt_rank, n, n], dim=-1)
    dt = softplus(_matmul(dt, params["dt_proj"])
                  + params["dt_bias"][None, None])            # (B,S,di)
    a = -torch.exp(params["A_log"].float())                   # (di, N)

    f32 = torch.float32
    h0 = state["h"] if state is not None else None
    flags = get_flags()
    if s == 1:                                     # decode: one step
        da, dbx = discretize(dt, xi, bmat, a)
        if h0 is None:
            h0 = torch.zeros((b, di, n), dtype=f32, device=x.device)
        h_last = da[:, 0] * h0 + dbx[:, 0]
        y = torch.einsum("bdn,bn->bd", h_last, cmat[:, 0].to(f32))[:, None]
    elif flags.ssm_impl == "sequential":
        if h0 is None:
            h0 = torch.zeros((b, di, n), dtype=f32, device=x.device)
        y, h_last = _scan_sequential(dt, bmat, cmat, xi, a, h0)
    elif flags.ssm_impl == "streamed":
        sdt = torch.bfloat16 if flags.ssm_state_dtype == "bf16" else f32
        y, h_last = _scan_streamed(dt, bmat, cmat, xi, a, h0,
                                   chunk=flags.ssm_chunk, state_dtype=sdt)
    else:                                          # materialized: K7 once
        da, dbx = discretize(dt, xi, bmat, a)                 # (B,S,di,N)
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
