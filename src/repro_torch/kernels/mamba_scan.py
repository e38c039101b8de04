"""Selective scan (K7): the diagonal recurrence inside a Mamba-1 mixer.

Kernel K7 (``mamba_scan_kernel``, CUDA C++ for sm_90a in
``csrc/mamba_scan.cu``) replaces the reference's Pallas ``_scan_kernel``
(``repro/kernels/mamba_scan.py``): with a and bx (B, S, D, N) and c
(B, S, N), ``h`` starts at ``h0`` (B, D, N), or at zero, for each (b, d)
and for each t in order ``h = a_t * h + bx_t``, ``y_t = sum_n h[n] *
c_t[n]``, in float32; y is (B, S, D) float32, and on request ``h`` after
the last step (the Mamba mixer's decode state; the JAX package's scan in
``repro/models/ssm.py`` takes ``h0`` and returns ``h_last``).  Each input
is read once and y written once, so at the main path's widths
device-memory bytes bound it.  The TPU kernel carries ``h`` across
sequence blocks in VMEM scratch; K7 gives each channel a group of lanes
(one a state) that walks the whole sequence.

``mamba_scan`` counts its launches in ``mamba_scan.launches``.  For CUDA
tensors it launches K7 or raises; for CPU tensors it runs
:func:`mamba_scan_plain`.  When an operand requires a gradient (and grad
mode is on), K7 runs inside a ``torch.autograd.Function`` whose backward
recomputes the scan with :func:`mamba_scan_plain` and differentiates
that (the JAX package has no backward kernel either); with no operand
requiring a gradient (serving) the launch is the bare kernel.  On
``DTensor`` operands it runs once a rank on the local shards, and on meta
tensors it is one cost op that a counter charges K7's own work
(``kernels.sharded``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..device import resolve_device
from .pnr_cost import _ptr, _stream
from .sharded import (is_dtensor, scan_backward_meta, scan_dtensor,
                      scan_meta)

__all__ = ["MAX_STATE", "mamba_scan", "mamba_scan_plain"]

_SOURCE = "mamba_scan.cu"
#: largest state size N K7 takes (16 states a lane over 32 lanes)
MAX_STATE = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(a, bx, c, h0=None):
    if a.ndim != 4 or tuple(bx.shape) != tuple(a.shape):
        raise ValueError(f"a and bx must be (B, S, D, N) of one shape, got "
                         f"{tuple(a.shape)} and {tuple(bx.shape)}")
    b, s, d, n = a.shape
    if tuple(c.shape) != (b, s, n):
        raise ValueError(f"c must be (B, S, N) = {(b, s, n)}, got "
                         f"{tuple(c.shape)}")
    if h0 is not None and tuple(h0.shape) != (b, d, n):
        raise ValueError(f"h0 must be (B, D, N) = {(b, d, n)}, got "
                         f"{tuple(h0.shape)}")
    if not a.device == bx.device == c.device or (
            h0 is not None and h0.device != a.device):
        raise ValueError("a, bx, c and h0 must lie on one device")


def mamba_scan_plain(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor, *,
                     h0: Optional[torch.Tensor] = None,
                     return_state: bool = False):
    """Plain version of K7: a loop over S in PyTorch, float32 throughout,
    ``h = a_t * h + bx_t`` as a multiply and an add (as the kernel), from
    ``h0`` (or zero).  Returns y, or ``(y, h_last)`` with
    ``return_state``."""
    _check_args(a, bx, c, h0)
    b, s, d, n = a.shape
    f32 = torch.float32
    h = torch.zeros((b, d, n), dtype=f32, device=a.device) if h0 is None \
        else h0.to(f32)
    y = torch.empty((b, s, d), dtype=f32, device=a.device)
    for t in range(s):
        h = a[:, t].to(f32) * h + bx[:, t].to(f32)
        y[:, t] = torch.sum(h * c[:, t].to(f32)[:, None, :], dim=-1)
    return (y, h) if return_state else y


def _lib():
    from .build import load
    lib = load(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mamba_scan_launch.argtypes = [i, i, i, i, p, p, p, p, p, p, i,
                                         p]
        lib.mamba_scan_launch.restype = i
        lib.mamba_scan_error_string.argtypes = [i]
        lib.mamba_scan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def mamba_scan(a, bx, c, *, h0=None, return_state: bool = False,
               bs: int = 128, bd: int = 128, device="cuda"):
    """a, bx (B, S, D, N); c (B, S, N); ``h0`` (B, D, N), the state before
    the first step (None: zero).  Returns y (B, S, D) float32,
    ``y[b, t, d] = sum_n h[b, t, d, n] * c[b, t, n]`` under the recurrence
    above, for any S and D (the kernel masks the ragged edges); with
    ``return_state``, ``(y, h_last)``, ``h_last`` (B, D, N) float32 the
    state after step S-1 (``h0``, or zero, when S is 0).

    Operands (tensors or arrays) are moved to ``device``: K7 on the card
    (the default; raises without one; a, bx and c float32 or bfloat16, all
    three of one dtype, ``h0`` float32, N <= 512), the plain version on
    ``device="cpu"``.  ``bs`` and ``bd`` are the reference's block sizes,
    accepted and ignored: they change no result.
    """
    if is_dtensor(a, bx, c, h0):
        return scan_dtensor(lambda a_, b_, c_, h_: mamba_scan(
            a_, b_, c_, h0=h_, return_state=return_state,
            device=a_.device), a, bx, c, h0, return_state)
    if all(isinstance(t, torch.Tensor) and t.is_meta for t in (a, bx, c)):
        _check_args(a, bx, c, h0)
        return _dispatch(a, bx, c, h0, return_state)
    dev = resolve_device(device)
    a, bx, c = (torch.as_tensor(t, device=dev) for t in (a, bx, c))
    if h0 is not None:
        h0 = torch.as_tensor(h0, device=dev)
    _check_args(a, bx, c, h0)
    if dev.type != "cuda":
        return mamba_scan_plain(a, bx, c, h0=h0, return_state=return_state)
    b, s, d, n = a.shape
    if a.dtype not in _DTYPES or bx.dtype != a.dtype or c.dtype != a.dtype:
        raise TypeError(f"K7 takes a, bx and c all float32 or all bfloat16, "
                        f"got {a.dtype}, {bx.dtype}, {c.dtype}")
    if h0 is not None and h0.dtype != torch.float32:
        raise TypeError(f"K7 takes h0 float32, got {h0.dtype}")
    if not 0 < n <= MAX_STATE:
        raise ValueError(f"state size N = {n} outside K7's 1..{MAX_STATE}")
    if b > 65535:
        raise ValueError(f"B = {b} exceeds K7's grid (65535)")
    return _dispatch(a, bx, c, h0, return_state)


def _dispatch(a, bx, c, h0, return_state: bool):
    """K7 inside its autograd Function when an operand needs a gradient,
    else the bare launch (serving)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, bx, c, h0)):
        return _MambaScan.apply(a, bx, c, h0, return_state)
    return _launch(a, bx, c, h0, return_state)


def _launch(a, bx, c, h0, return_state: bool):
    """One launch of K7 on checked CUDA operands; counts it.  On meta
    operands, the cost op (no launch)."""
    if a.is_meta:
        return scan_meta(a, bx, c, h0, return_state)
    b, s, d, n = a.shape
    dev = a.device
    a, bx, c = a.contiguous(), bx.contiguous(), c.contiguous()
    if h0 is not None:
        h0 = h0.contiguous()
    y = torch.empty((b, s, d), dtype=torch.float32, device=dev)
    h_out = torch.empty((b, d, n), dtype=torch.float32, device=dev) \
        if return_state else None
    if y.numel() == 0:
        if return_state:
            h_out = h_out.zero_() if h0 is None else h_out.copy_(h0)
        return (y, h_out) if return_state else y
    lib = _lib()
    rc = lib.mamba_scan_launch(b, s, d, n, _ptr(a), _ptr(bx), _ptr(c),
                               _ptr(h0), _ptr(y), _ptr(h_out),
                               _DTYPES[a.dtype], _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"mamba_scan_kernel failed to launch: CUDA error {rc} "
            f"({lib.mamba_scan_error_string(rc).decode()})")
    mamba_scan.launches += 1
    return (y, h_out) if return_state else y


class _MambaScan(torch.autograd.Function):
    """K7 under autograd: the forward launches K7; the backward
    recomputes the scan with :func:`mamba_scan_plain` and returns its
    gradients (there is no backward kernel)."""

    @staticmethod
    def forward(ctx, a, bx, c, h0, return_state):
        ctx.return_state = return_state
        ctx.save_for_backward(a, bx, c, h0)
        return _launch(a, bx, c, h0, return_state)

    @staticmethod
    def backward(ctx, *grads_out):
        if ctx.saved_tensors[0].is_meta:    # the dry run: one cost op
            a = ctx.saved_tensors[0]
            gy = grads_out[0] if grads_out[0] is not None else \
                a.new_zeros(a.shape[:3], dtype=torch.float32)
            got = scan_backward_meta(*ctx.saved_tensors, gy)
            return tuple(g if need else None for g, need in
                         zip(got, ctx.needs_input_grad)) + (None,)
        saved = [None if t is None else t.detach().requires_grad_()
                 for t in ctx.saved_tensors]
        ins = [t for t in saved if t is not None]
        with torch.enable_grad():
            out = mamba_scan_plain(*saved[:3], h0=saved[3],
                                   return_state=ctx.return_state)
            outs = out if ctx.return_state else (out,)
            pairs = [(o, g) for o, g in zip(outs, grads_out)
                     if g is not None]
            grads = iter(torch.autograd.grad([o for o, _ in pairs], ins,
                                             [g for _, g in pairs],
                                             allow_unused=True))
        got = [None if t is None else next(grads) for t in saved]
        return tuple(g if need else None for g, need in
                     zip(got, ctx.needs_input_grad)) + (None,)


mamba_scan.launches = 0
