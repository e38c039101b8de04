"""Selective scan (K7): the diagonal recurrence inside a Mamba-1 mixer.

Kernel K7 (``mamba_scan_kernel``, CUDA C++ for sm_90a in
``csrc/mamba_scan.cu``) replaces the reference's Pallas ``_scan_kernel``
(``repro/kernels/mamba_scan.py``): with a and bx (B, S, D, N) and c
(B, S, N), ``h`` starts at zero for each (b, d) and for each t in order
``h = a_t * h + bx_t``, ``y_t = sum_n h[n] * c_t[n]``, in float32; y is
(B, S, D) float32.  Each input is read once and y written once, so at the
main path's widths device-memory bytes bound it.  The TPU kernel carries
``h`` across sequence blocks in VMEM scratch; K7 gives each channel a group
of lanes (one a state) that walks the whole sequence.

``mamba_scan`` counts its launches in ``mamba_scan.launches``.  For CUDA
tensors it launches K7 or raises; for CPU tensors it runs
:func:`mamba_scan_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import resolve_device
from .pnr_cost import _ptr, _stream

__all__ = ["MAX_STATE", "mamba_scan", "mamba_scan_plain"]

_SOURCE = "mamba_scan.cu"
#: largest state size N K7 takes (16 states a lane over 32 lanes)
MAX_STATE = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(a, bx, c):
    if a.ndim != 4 or tuple(bx.shape) != tuple(a.shape):
        raise ValueError(f"a and bx must be (B, S, D, N) of one shape, got "
                         f"{tuple(a.shape)} and {tuple(bx.shape)}")
    b, s, _, n = a.shape
    if tuple(c.shape) != (b, s, n):
        raise ValueError(f"c must be (B, S, N) = {(b, s, n)}, got "
                         f"{tuple(c.shape)}")
    if not a.device == bx.device == c.device:
        raise ValueError("a, bx and c must lie on one device")


def mamba_scan_plain(a: torch.Tensor, bx: torch.Tensor,
                     c: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: a loop over S in PyTorch, float32 throughout,
    ``h = a_t * h + bx_t`` as a multiply and an add (as the kernel)."""
    _check_args(a, bx, c)
    b, s, d, n = a.shape
    f32 = torch.float32
    h = torch.zeros((b, d, n), dtype=f32, device=a.device)
    y = torch.empty((b, s, d), dtype=f32, device=a.device)
    for t in range(s):
        h = a[:, t].to(f32) * h + bx[:, t].to(f32)
        y[:, t] = torch.sum(h * c[:, t].to(f32)[:, None, :], dim=-1)
    return y


def _lib():
    from .build import load
    lib = load(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mamba_scan_launch.argtypes = [i, i, i, i, p, p, p, p, i, p]
        lib.mamba_scan_launch.restype = i
        lib.mamba_scan_error_string.argtypes = [i]
        lib.mamba_scan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def mamba_scan(a, bx, c, *, bs: int = 128, bd: int = 128,
               device="cuda") -> torch.Tensor:
    """a, bx (B, S, D, N); c (B, S, N).  Returns y (B, S, D) float32,
    ``y[b, t, d] = sum_n h[b, t, d, n] * c[b, t, n]`` under the recurrence
    above, for any S and D (the kernel masks the ragged edges).

    Operands (tensors or arrays) are moved to ``device``: K7 on the card
    (the default; raises without one; float32 or bfloat16, all three of
    one dtype, N <= 512), the plain version on ``device="cpu"``.  ``bs``
    and ``bd`` are the reference's block sizes, accepted and ignored: they
    change no result.
    """
    dev = resolve_device(device)
    a, bx, c = (torch.as_tensor(t, device=dev) for t in (a, bx, c))
    _check_args(a, bx, c)
    if dev.type != "cuda":
        return mamba_scan_plain(a, bx, c)
    b, s, d, n = a.shape
    if a.dtype not in _DTYPES or bx.dtype != a.dtype or c.dtype != a.dtype:
        raise TypeError(f"K7 takes a, bx and c all float32 or all bfloat16, "
                        f"got {a.dtype}, {bx.dtype}, {c.dtype}")
    if not 0 < n <= MAX_STATE:
        raise ValueError(f"state size N = {n} outside K7's 1..{MAX_STATE}")
    if b > 65535:
        raise ValueError(f"B = {b} exceeds K7's grid (65535)")
    a, bx, c = a.contiguous(), bx.contiguous(), c.contiguous()
    y = torch.empty((b, s, d), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y
    lib = _lib()
    rc = lib.mamba_scan_launch(b, s, d, n, _ptr(a), _ptr(bx), _ptr(c),
                               _ptr(y), _DTYPES[a.dtype], _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"mamba_scan_kernel failed to launch: CUDA error {rc} "
            f"({lib.mamba_scan_error_string(rc).decode()})")
    mamba_scan.launches += 1
    return y


mamba_scan.launches = 0
