"""Transformer building blocks in PyTorch (bf16-compute friendly).

The port of the JAX package's ``repro.models.layers``, function for
function.  ``blockwise_attention`` is the online softmax over KV chunks
(flash attention written with tensor ops), with ``q_pos``/``kv_pos``
masks and the ``-1e30`` fill: it is what the JAX package computes
outside any kernel, and the port keeps it for the attention that the
flash-attention kernel (K6, ``repro_torch.kernels.ops.attention``) does
not take: decode (one query against the cache) and cross-attention
(query and key lengths differ).  Self-attention with equal query and key
lengths goes to K6 (``transformer._attention``).

The JAX package's perf-flag variants are here too (``models.perf_flags``):
``rms_norm`` with ``norm_dtype="bf16"`` (elementwise math in bfloat16, the
variance in float32) and :func:`blockwise_attention_qouter` (q-tiles
outside, ``blockwise_attention`` inside, pad queries at position
``2**30``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels.sharded import blockwise_dtensor, is_dtensor
from .perf_flags import get_flags

__all__ = ["apply_rope", "blockwise_attention",
           "blockwise_attention_qouter", "mlp_geglu", "mlp_gelu",
           "mlp_swiglu", "rms_norm", "rope_tables", "soft_cap", "softplus"]

#: the position given to keys and queries that no mask may admit
FAR = 2 ** 30
NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             *, plus_one: bool = False) -> torch.Tensor:
    dt = x.dtype
    if get_flags().norm_dtype == "bf16" and dt == torch.bfloat16:
        # the square in bfloat16, then float32 for the mean; rsqrt cast to
        # bfloat16 and the products in bfloat16, in the JAX package's order
        var = torch.square(x).float().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(dt)
        scale = (1.0 + w).to(dt) if plus_one else w.to(dt)
        return x * inv * scale
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    wf = w.float()
    scale = (1.0 + wf) if plus_one else wf
    return (y * scale).to(dt)


def soft_cap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return (cap * torch.tanh(x / cap)).to(x.dtype)


# -- rotary embeddings ---------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given positions: (..., head_dim/2), float32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # a 0-d host tensor as the base: no copy to the device (which would
    # wait for the stream) on every layer
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# -- blockwise attention ----------------------------------------------------------

def _chunk_attn_update(carry, q, k_c, v_c, mask_c, scale, softcap):
    """Online-softmax update for one KV chunk.

    q: (B, Hq, Sq, D); k_c/v_c: (B, Hkv, C, D); mask_c: (B, Sq, C) boolean;
    carry = (acc (B,Hq,Sq,D), m (B,Hq,Sq), l (B,Hq,Sq)), float32.
    """
    acc, m, l = carry
    b, hq, sq, d = q.shape
    hkv = k_c.shape[1]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k_c.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = s.reshape(b, hq, sq, -1)
    s = torch.where(mask_c[:, None, :, :], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    pg = p.reshape(b, hkv, group, sq, -1)
    pv = torch.einsum("bhgqk,bhkd->bhgqd", pg, v_c.float())
    acc_new = acc * alpha[..., None] + pv.reshape(b, hq, sq, d)
    return acc_new, m_new, l_new


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        q_pos: torch.Tensor, kv_pos: torch.Tensor,
                        causal: bool = True, window=None,
                        softcap: float = 0.0, scale: float = 0.0,
                        chunk: int = 512) -> torch.Tensor:
    """Flash-style attention with tensor ops.

    q: (B, Sq, Hq, D);  k/v: (B, Skv, Hkv, D);
    q_pos: (B, Sq) absolute positions; kv_pos: (B, Skv).
    ``window`` (an int) masks keys older than ``window`` positions (local
    attention); None/0 = full.  Returns (B, Sq, Hq, D) in q.dtype.  On
    ``DTensor`` operands it runs once a rank on the local shards
    (``kernels.sharded``).
    """
    if is_dtensor(q, k, v, q_pos, kv_pos):
        return blockwise_dtensor(
            lambda *t: blockwise_attention(
                *t[:3], q_pos=t[3], kv_pos=t[4], causal=causal,
                window=window, softcap=softcap, scale=scale, chunk=chunk),
            q, k, v, q_pos, kv_pos)
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    scale = scale or (1.0 / math.sqrt(d))
    qt = q.transpose(1, 2)                           # (B,Hq,Sq,D)
    kt = k.transpose(1, 2)                           # (B,Hkv,Skv,D)
    vt = v.transpose(1, 2)

    chunk = min(chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        kt = F.pad(kt, (0, 0, 0, pad))
        vt = F.pad(vt, (0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)

    dev = q.device
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=dev)
    carry = (acc, m, l)
    use_window = bool(window)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        p_c = kv_pos[:, sl]
        mask = p_c[:, None, :] >= 0                  # (B,1,C) valid keys
        if causal:
            mask = mask & (p_c[:, None, :] <= q_pos[:, :, None])
        if use_window:
            mask = mask & (p_c[:, None, :] > q_pos[:, :, None] - window)
        mask = mask.expand(b, sq, p_c.shape[1])
        carry = _chunk_attn_update(carry, qt, kt[:, :, sl], vt[:, :, sl],
                                   mask, scale, softcap)
    acc, m, l = carry
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def blockwise_attention_qouter(q, k, v, *, q_pos, kv_pos, causal=True,
                               window=None, softcap=0.0, scale=0.0,
                               q_chunk=512, kv_chunk=512):
    """The flash loop order: q-tiles of ``q_chunk`` outside,
    :func:`blockwise_attention` over kv chunks of ``kv_chunk`` inside, so
    the float32 accumulator is (B, H, q_chunk, D), made anew a tile.  The
    last tile is padded with zero queries at position ``2**30``, cut off
    after.  Shapes as :func:`blockwise_attention`'s."""
    b, sq, hq, d = q.shape
    q_chunk = min(q_chunk, sq)
    nq = -(-sq // q_chunk)
    pad = nq * q_chunk - sq
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad), value=FAR)
    outs = [blockwise_attention(
        q[:, i * q_chunk:(i + 1) * q_chunk], k, v,
        q_pos=q_pos[:, i * q_chunk:(i + 1) * q_chunk], kv_pos=kv_pos,
        causal=causal, window=window, softcap=softcap, scale=scale,
        chunk=kv_chunk) for i in range(nq)]
    return torch.cat(outs, dim=1)[:, :sq]


# -- MLPs ------------------------------------------------------------------------
# The activations follow the JAX package's op sequence in the operands'
# dtype (jax.nn.silu is x * logistic(x), which XLA expands to 1/(1 +
# exp(-x)); the tanh GELU is jax.nn.gelu's formula with its constants in
# that dtype), so bfloat16 rounds where the JAX package rounds: torch's
# fused silu and gelu round once and differ from it in a third of the
# bfloat16 values.

def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, which JAX writes as
    ``max(x, 0) + log1p(exp(-|x - 0|))`` (``x + 0`` where ``x - 0`` is
    NaN), each op in x's dtype.  Torch's own softplus (``log1p(exp(x))``
    below a threshold of 20) rounds elsewhere in bfloat16."""
    zero = torch.zeros((), dtype=x.dtype)
    d = x - zero
    out = torch.maximum(x, zero) + torch.log1p(torch.exp(-torch.abs(d)))
    return torch.where(torch.isnan(d), x + zero, out)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    c1 = torch.tensor(0.044715, dtype=x.dtype)
    c2 = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    return x * (0.5 * (1 + torch.tanh(c2 * (x + c1 * (x * x * x)))))


def mlp_swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, wg)
    u = torch.matmul(x, wu)
    return torch.matmul(_silu(g) * u, wd).to(x.dtype)


def mlp_gelu(x: torch.Tensor, wi: torch.Tensor,
             wo: torch.Tensor) -> torch.Tensor:
    h = _gelu_tanh(torch.matmul(x, wi))
    return torch.matmul(h, wo).to(x.dtype)


def mlp_geglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
              wd: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, wg)
    u = torch.matmul(x, wu)
    h = _gelu_tanh(g) * u
    return torch.matmul(h, wd).to(x.dtype)
