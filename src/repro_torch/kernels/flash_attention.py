"""Flash attention (K6): GQA, causal, sliding window, softcap.

Kernel K6 (``flash_attention_kernel``, CUDA C++ for sm_90a in
``csrc/flash_attention.cu``, both products on the tensor cores: bfloat16
``wgmma`` for bfloat16 inputs, 3xTF32 ``wgmma`` for float32) replaces the
reference's Pallas ``_attn_kernel`` (``repro/kernels/flash_attention.py``):
q is scaled by
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
:func:`attention_plain`.  When an operand requires a gradient (and
grad mode is on), K6 runs inside a ``torch.autograd.Function`` whose
backward recomputes the function with :func:`attention_plain` and
differentiates that: the JAX package has no backward kernel either.  A
launch with no operand requiring a gradient (serving) is the bare
kernel, as before.  On ``DTensor`` operands it runs once a rank on the
local shards, and on meta tensors it is one cost op that a counter
charges K6's own work (``kernels.sharded``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..device import resolve_device
from .pnr_cost import _ptr, _stream
from .sharded import (attention_backward_meta, attention_dtensor,
                      attention_meta, is_dtensor)

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


def _splice(t: torch.Tensor, rows: torch.Tensor, r0: int, r1: int):
    """``t`` with its rows ``r0:r1`` (dim 2) replaced by ``rows``."""
    if r0 == 0 and r1 == t.shape[2]:
        return rows
    return torch.cat([t[:, :, :r0], rows, t[:, :, r1:]], dim=2)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float = 0.0,
                    bk: int = 128) -> torch.Tensor:
    """Plain version of K6: the online softmax over kv blocks of ``bk``
    keys, in float32, with ``_attn_kernel``'s arithmetic (``torch.matmul``
    for the two products).  No S x S tensor is formed: a block updates only
    the query rows its keys can reach; for the others it would be an exact
    no-op (a later real key's ``alpha = exp(-1e30 - m)`` is 0).  Every
    update is out of place, so autograd differentiates it: it is K6's
    backward."""
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
        # out of place, so that autograd can differentiate the loop
        l = _splice(l, l[:, :, r0:r1] * alpha + p.sum(dim=-1), r0, r1)
        acc = _splice(acc, acc[:, :, r0:r1] * alpha[..., None]
                      + torch.matmul(p, vb), r0, r1)
        m = _splice(m, m_new, r0, r1)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied if its data does not start on 16 bytes (K6 reads
    rows in 16-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _lib():
    from .build import load
    lib = load(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_launch.argtypes = [i, i, i, i, i, p, p, p, p, p,
                                               i, i, i, f, f, p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_scratch_floats.argtypes = [i, i, i, i]
        lib.flash_attention_scratch_floats.restype = ctypes.c_longlong
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
    and ``bk`` are the reference's tile sizes: K6 picks its own (128 query
    rows, 32 or 64 keys) and ignores them; the plain version steps over
    keys ``bk`` at a time.
    """
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if is_dtensor(q, k, v):
        return attention_dtensor(lambda ql, kl, vl: flash_attention(
            ql, kl, vl, bq=bq, bk=bk, device=ql.device, **kw), q, k, v)
    if all(isinstance(t, torch.Tensor) and t.is_meta for t in (q, k, v)):
        _check_args(q, k, v)
        kw["scale"] = float(scale or 1.0 / math.sqrt(q.shape[-1]))
        return _dispatch(q, k, v, kw)
    dev = resolve_device(device)
    q, k, v = (torch.as_tensor(t, device=dev) for t in (q, k, v))
    _check_args(q, k, v)
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
    kw["scale"] = float(scale or 1.0 / math.sqrt(d))
    return _dispatch(q, k, v, kw)


def _dispatch(q, k, v, kw):
    """K6 inside its autograd Function when an operand needs a gradient,
    else the bare launch (serving)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        return _FlashAttention.apply(q, k, v, kw)
    return _launch(q, k, v, **kw)


def _launch(q, k, v, *, causal: bool, window: int, softcap: float,
            scale: float) -> torch.Tensor:
    """One launch of K6 on checked CUDA operands; counts it.  On meta
    operands, the cost op (no launch)."""
    if q.is_meta:
        return attention_meta(q, k, v, causal, window)
    b, hq, s, d = q.shape
    dev = q.device
    dp = d
    if q.dtype == torch.bfloat16 and d % 8:
        # 16-byte copies of whole rows: zero columns change no score and
        # give output columns that are cut off below
        dp = d + 8 - d % 8
        q, k, v = (torch.nn.functional.pad(t, (0, dp - d)) for t in (q, k, v))
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out[..., :d]
    lib = _lib()
    dt = _DTYPES[q.dtype]
    scratch = torch.empty(
        (max(1, lib.flash_attention_scratch_floats(b * k.shape[1], s, dp,
                                                   dt)),),
        dtype=torch.float32, device=dev)
    rc = lib.flash_attention_launch(
        b, hq, k.shape[1], s, dp, _ptr(q), _ptr(k), _ptr(v), _ptr(scratch),
        _ptr(out), dt, int(bool(causal)), int(window), float(softcap), scale,
        _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_kernel failed to launch: CUDA error {rc} "
            f"({lib.flash_attention_error_string(rc).decode()})")
    flash_attention.launches += 1
    return out if dp == d else out[..., :d].contiguous()


class _FlashAttention(torch.autograd.Function):
    """K6 under autograd: the forward launches K6; the backward
    recomputes the same function with :func:`attention_plain` and returns
    its gradients (there is no backward kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        ctx.kw = kw
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, **kw)

    @staticmethod
    def backward(ctx, grad_out):
        if grad_out.is_meta:                # the dry run: one cost op
            grads = attention_backward_meta(*ctx.saved_tensors, grad_out,
                                            ctx.kw["causal"],
                                            ctx.kw["window"])
            return tuple(g if need else None for g, need in
                         zip(grads, ctx.needs_input_grad)) + (None,)
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = attention_plain(q, k, v, **ctx.kw)
            grads = torch.autograd.grad(out, (q, k, v), grad_out)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,)


flash_attention.launches = 0
