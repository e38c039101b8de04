"""Flash attention (K6): GQA, causal, sliding window, softcap.

Kernel K6 (``flash_attention_kernel``, CUDA C++ for sm_90a in
``csrc/flash_attention.cu``) replaces the reference's Pallas
``_attn_kernel`` (``repro/kernels/flash_attention.py``): q is scaled by
``scale`` (default ``1/sqrt(D)``), query head ``h`` reads kv head
``h // (Hq/Hkv)``, ``s = q k^T`` (soft-capped as ``softcap * tanh(s /
softcap)`` when ``softcap`` is set), keys outside the causal and window
masks score -1e30, and an online softmax keeps a running max, ``l`` and
``acc`` in float32; the output is ``acc / max(l, 1e-30)`` in q's dtype.

One departure from the reference: the kernel also masks keys at
``k_pos >= S``, so a sequence length that is not a multiple of the tile
needs no padding and the result equals ``ref_attention`` (the reference
wrapper pads k/v with zero rows that enter the softmax when
``causal=False``).

``flash_attention`` counts its launches in ``flash_attention.launches``.
For CUDA tensors it launches K6 or raises; for CPU tensors it runs
:func:`attention_plain`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..device import resolve_device
from .pnr_cost import _ptr, _stream

__all__ = ["MAX_HEAD_DIM", "NEG_INF", "attention_plain", "flash_attention"]

_SOURCE = "flash_attention.cu"
NEG_INF = -1e30
#: largest head dim K6 takes (it pads D to 32, 64 or 128 in shared memory)
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(q, k, v):
    """The reference's shape rules (``flash_attention``), as exceptions."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k and v must be 4-D (B, H, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, s, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != \
            (b, s, d):
        raise ValueError(f"k and v must be (B, Hkv, S, D) = ({b}, Hkv, {s}, "
                         f"{d}), got {tuple(k.shape)} and {tuple(v.shape)}")
    hkv = k.shape[1]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq = {hq} is not a multiple of Hkv = {hkv}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must lie on one device")


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float = 0.0,
                    bk: int = 128) -> torch.Tensor:
    """Plain version of K6: the online softmax over kv blocks of ``bk``
    keys, in float32, with ``_attn_kernel``'s arithmetic (``torch.matmul``
    for the two products).  No S x S tensor is formed: a block updates only
    the query rows its keys can reach; for the others it would be an exact
    no-op (a later real key's ``alpha = exp(-1e30 - m)`` is 0)."""
    _check_args(q, k, v)
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    scale = scale or 1.0 / math.sqrt(d)
    f32 = torch.float32
    dev = q.device
    qs = q.to(f32) * scale
    acc = torch.zeros((b, hq, s, d), dtype=f32, device=dev)
    m = torch.full((b, hq, s), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((b, hq, s), dtype=f32, device=dev)
    bk = max(1, min(bk, s))
    for j0 in range(0, s, bk):
        j1 = min(j0 + bk, s)
        # rows with a key of this block inside their causal and window masks
        r0 = j0 if causal else 0
        r1 = min(s, j1 - 1 + window) if window > 0 else s
        if r0 >= r1:
            continue
        kb = k[:, :, j0:j1].to(f32).repeat_interleave(group, dim=1)
        vb = v[:, :, j0:j1].to(f32).repeat_interleave(group, dim=1)
        sc = torch.matmul(qs[:, :, r0:r1], kb.transpose(-1, -2))
        if softcap:
            sc = softcap * torch.tanh(sc / softcap)
        q_pos = torch.arange(r0, r1, device=dev)[:, None]
        k_pos = torch.arange(j0, j1, device=dev)[None, :]
        mask = torch.ones((r1 - r0, j1 - j0), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window:
            mask = mask & (k_pos > q_pos - window)
        sc = torch.where(mask, sc, torch.tensor(NEG_INF, device=dev))
        m_old = m[:, :, r0:r1]
        m_new = torch.maximum(m_old, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m_old - m_new)
        l[:, :, r0:r1] = l[:, :, r0:r1] * alpha + p.sum(dim=-1)
        acc[:, :, r0:r1] = acc[:, :, r0:r1] * alpha[..., None] \
            + torch.matmul(p, vb)
        m[:, :, r0:r1] = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def _lib():
    from .build import load
    lib = load(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_launch.argtypes = [i, i, i, i, i, p, p, p, p, i,
                                               i, i, f, f, p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float = 0.0,
                    bq: int = 128, bk: int = 128,
                    device="cuda") -> torch.Tensor:
    """q (B, Hq, S, D); k/v (B, Hkv, S, D) with Hq % Hkv == 0.  Returns
    (B, Hq, S, D) in q's dtype, for any S (the kernel masks the ragged
    tile).

    Operands (tensors or arrays) are moved to ``device``: K6 on the card
    (the default; raises without one; float32 or bfloat16, all three of
    one dtype, D <= 128), the plain version on ``device="cpu"``.  ``bq``
    and ``bk`` are the reference's tile sizes: K6's tiles are 64 x 64 and
    ignore them; the plain version steps over keys ``bk`` at a time.
    """
    dev = resolve_device(device)
    q, k, v = (torch.as_tensor(t, device=dev) for t in (q, k, v))
    _check_args(q, k, v)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if dev.type != "cuda":
        return attention_plain(q, k, v, bk=bk, **kw)
    b, hq, s, d = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K6 takes q, k and v all float32 or all bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds K6's {MAX_HEAD_DIM}")
    if b > 65535 or hq > 65535:
        raise ValueError(f"B = {b} or Hq = {hq} exceeds K6's grid (65535)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    rc = lib.flash_attention_launch(
        b, hq, k.shape[1], s, d, _ptr(q), _ptr(k), _ptr(v), _ptr(out),
        _DTYPES[q.dtype], int(bool(causal)), int(window), float(softcap),
        float(scale or 1.0 / math.sqrt(d)), _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_kernel failed to launch: CUDA error {rc} "
            f"({lib.flash_attention_error_string(rc).decode()})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
