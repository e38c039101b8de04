"""Matmul with a fused PE-graph epilogue (K5).

The ML-domain PEs the paper derives (Fig. 12) are MAC datapaths followed
by small op chains (bias add, ReLU, requantize, residual add).  On the
card the MAC array is the GEMM; the mined epilogue graph is evaluated on
each output element while its accumulator is still in registers.

Kernel K5 (``gemm_pe_kernel``, CUDA C++ for sm_90a in
``csrc/gemm_pe.cu``) replaces the reference's Pallas ``_gemm_kernel``
(``repro/kernels/gemm.py``): x (M, K) @ w (K, N) with a float32
accumulator, then the epilogue (free port 0 = the accumulator, further
free ports = extras: ``vec`` (N,) broadcast over rows or ``full`` (M, N)),
first sink only, stored as ``out_dtype or x.dtype``.  The product runs on
the TF32 tensor cores with the 3xTF32 split (hi + lo parts of each float32
operand, three products), which keeps float32 accuracy; bfloat16
operands are exact in TF32 and take one product.  At the main path's
shapes it is bound by operations.  The epilogue reaches the kernel as a
short op list (:func:`encode_epilogue`) interpreted per element through
one device table that mirrors ``_JNP_SEMANTICS``; it costs O(M*N*ops)
against the K loop's O(M*N*K), so one build serves every pattern.

``gemm_pe`` counts its launches in ``gemm_pe.launches``.  For CUDA
tensors it launches K5 or raises; for CPU tensors it runs
:func:`gemm_pe_plain`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..graphir.graph import Graph, free_in_ports
from .pe_fused import _TORCH_SEMANTICS, _torch_fn, lower_pattern
from .pnr_cost import _ptr, _stream

__all__ = ["EPI_OPCODES", "Epilogue", "encode_epilogue", "gemm_pe",
           "gemm_pe_plain"]

_SOURCE = "gemm_pe.cu"
#: opcode i of the device table in ``csrc/gemm_pe.cu`` (same order)
EPI_OPCODES: Tuple[str, ...] = tuple(_TORCH_SEMANTICS)
MAX_OPS, MAX_SLOTS, MAX_EXTRA = 32, 64, 8
#: K5's output tile (M, N) and step of K: the split operands are padded
#: to them
TILE = (128, 128, 32)
_KINDS = {"vec": 0, "full": 1}


@dataclass(frozen=True)
class Epilogue:
    """An epilogue as K5 takes it.  Slots: 0 = accumulator, 1..n_extra =
    extras, then the constants (``consts``), then one per op.  Each row of
    ``ops`` is ``(opcode, dst, a, b, c)``; unused operands read slot 0.
    Booleans are 0.0/1.0 and casts to float are no-ops, so they alias."""

    ops: np.ndarray        # (n_ops, 5) int32
    consts: np.ndarray     # (n_const,) float32
    n_extra: int
    out: int               # slot of the first sink

    @property
    def n_slots(self) -> int:
        return 1 + self.n_extra + len(self.consts) + len(self.ops)


def encode_epilogue(pattern: Graph) -> Epilogue:
    """Lower the epilogue pattern (the same walk as K4) into K5's op
    list.  Raises what :func:`~.pe_fused.lower_pattern` raises, the error
    JAX would raise on its booleans, and ``ValueError`` above K5's
    limits (32 ops, 64 slots, 8 extras)."""
    prog = lower_pattern(pattern)
    prog.raise_error()
    n_extra = prog.n_in - 1
    slot = {f"p{i}": i for i in range(prog.n_in)}
    consts = [s for s in prog.stmts if s.op == "const"]
    for i, s in enumerate(consts):
        slot[s.dst] = prog.n_in + i
    nxt = prog.n_in + len(consts)
    rows = []
    for s in prog.stmts:
        if s.op == "const":
            continue
        if s.op in ("cast", "copy"):
            slot[s.dst] = slot[s.args[0]]
            continue
        args = [slot[a] for a in s.args] + [0] * (3 - len(s.args))
        slot[s.dst] = nxt
        rows.append([EPI_OPCODES.index(s.op), nxt, *args])
        nxt += 1
    epi = Epilogue(np.asarray(rows, np.int32).reshape(-1, 5),
                   np.asarray([s.value for s in consts], np.float32),
                   n_extra, slot[prog.outs[0]])
    if (len(epi.ops) > MAX_OPS or epi.n_slots > MAX_SLOTS
            or n_extra > MAX_EXTRA):
        raise ValueError(f"epilogue too large for K5: {len(epi.ops)} ops "
                         f"(max {MAX_OPS}), {epi.n_slots} slots (max "
                         f"{MAX_SLOTS}), {n_extra} extras (max {MAX_EXTRA})")
    return epi


def _check_args(x, w, extras, epilogue, extra_kinds):
    """The reference's checks (``gemm_pe``), as exceptions."""
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"x and w must be 2-D, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    (m, k), (k2, n) = x.shape, w.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    need = 0 if epilogue is None else len(free_in_ports(epilogue)) - 1
    if len(extras) != need or len(extra_kinds) != need:
        raise ValueError(f"the epilogue takes {need} extra operand(s); got "
                         f"{len(extras)} extras and {len(extra_kinds)} kinds")
    for e, kind in zip(extras, extra_kinds):
        want = {"vec": (n,), "full": (m, n)}.get(kind)
        if want is None:
            raise ValueError(f"extra kind must be 'vec' or 'full', got "
                             f"{kind!r}")
        if tuple(e.shape) != want:
            raise ValueError(f"{kind} extra must have shape {want}, got "
                             f"{tuple(e.shape)}")


def gemm_pe_plain(x: torch.Tensor, w: torch.Tensor, *extras: torch.Tensor,
                  epilogue: Optional[Graph] = None,
                  extra_kinds: Tuple[str, ...] = (),
                  out_dtype=None) -> torch.Tensor:
    """Plain version of K5: ``torch.matmul`` in float32, then the
    epilogue through the PyTorch rendering of :data:`_TORCH_SEMANTICS`."""
    _check_args(x, w, extras, epilogue, extra_kinds)
    acc = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    if epilogue is not None:
        prog = lower_pattern(epilogue)
        prog.raise_error()
        vals = [e.to(torch.float32)[None, :] if kind == "vec"
                else e.to(torch.float32)
                for e, kind in zip(extras, extra_kinds)]
        out = _torch_fn(prog)(acc, *vals, acc.device)[0]
        acc = torch.broadcast_to(out, acc.shape)
    return acc.to(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------
class _EpiOp(ctypes.Structure):
    _fields_ = [("code", ctypes.c_int), ("dst", ctypes.c_int),
                ("a", ctypes.c_int), ("b", ctypes.c_int),
                ("c", ctypes.c_int)]


class _EpiArg(ctypes.Structure):
    """Mirror of ``struct Epilogue`` in ``csrc/gemm_pe.cu``."""

    _fields_ = [("n_ops", ctypes.c_int), ("n_extra", ctypes.c_int),
                ("out", ctypes.c_int), ("n_init", ctypes.c_int),
                ("extra_kind", ctypes.c_int * MAX_EXTRA),
                ("extra", ctypes.c_void_p * MAX_EXTRA),
                ("slot_init", ctypes.c_float * MAX_SLOTS),
                ("ops", _EpiOp * MAX_OPS)]


def _lib():
    from .build import load
    lib = load(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gemm_pe_launch.argtypes = [i, i, i, p, p, p, p, p, i, i,
                                       ctypes.POINTER(_EpiArg), p]
        lib.gemm_pe_launch.restype = i
        lib.gemm_pe_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.gemm_pe_limits.restype = i
        lib.gemm_pe_error_string.argtypes = [i]
        lib.gemm_pe_error_string.restype = ctypes.c_char_p
        limits = (ctypes.c_int * 7)()
        lib.gemm_pe_limits(limits)
        if tuple(limits) != (len(EPI_OPCODES), MAX_OPS, MAX_SLOTS,
                             MAX_EXTRA, *TILE):
            raise RuntimeError(f"{_SOURCE} limits {tuple(limits)} differ "
                               f"from gemm.py's")
        lib._typed = True
    return lib


def _epi_arg(epi: Optional[Epilogue], extras: Sequence[torch.Tensor],
             extra_kinds: Sequence[str]) -> _EpiArg:
    arg = _EpiArg()
    if epi is None:
        return arg                      # all zero: the accumulator as is
    arg.n_ops, arg.n_extra, arg.out = len(epi.ops), epi.n_extra, epi.out
    arg.n_init = 1 + epi.n_extra + len(epi.consts)
    for i, (e, kind) in enumerate(zip(extras, extra_kinds)):
        arg.extra_kind[i] = _KINDS[kind]
        arg.extra[i] = e.data_ptr()
    for i, c in enumerate(epi.consts):
        arg.slot_init[1 + epi.n_extra + i] = float(c)
    for i, row in enumerate(epi.ops.tolist()):
        arg.ops[i] = _EpiOp(*row)
    return arg


def _run(x, w, extras, epilogue, extra_kinds, out_dtype,
         device) -> Tuple[torch.Tensor, bool]:
    """Checks, then the plain version (CPU) or K5 (CUDA); returns (out,
    launched)."""
    dev = resolve_device(device)
    x, w = torch.as_tensor(x, device=dev), torch.as_tensor(w, device=dev)
    extras = tuple(torch.as_tensor(e, device=dev) for e in extras)
    extra_kinds = tuple(extra_kinds)
    _check_args(x, w, extras, epilogue, extra_kinds)
    out_dtype = out_dtype or x.dtype
    if dev.type != "cuda":
        return gemm_pe_plain(x, w, *extras, epilogue=epilogue,
                             extra_kinds=extra_kinds,
                             out_dtype=out_dtype), False
    epi = None if epilogue is None else encode_epilogue(epilogue)
    (m, k), n = x.shape, w.shape[1]
    # both operands float32, or both bfloat16 (a float32/bfloat16 mix
    # widens the bfloat16 one, exactly)
    in_bf16 = x.dtype == w.dtype == torch.bfloat16
    dt = torch.bfloat16 if in_bf16 else torch.float32
    x, w = x.to(dt).contiguous(), w.to(dt).contiguous()
    extras = tuple(e.to(torch.float32).contiguous() for e in extras)
    out_bf16 = out_dtype == torch.bfloat16
    out = torch.empty((m, n), device=dev,
                      dtype=torch.bfloat16 if out_bf16 else torch.float32)
    if m * n == 0:
        return out.to(out_dtype), False
    arg = _epi_arg(epi, extras, extra_kinds)
    lib = _lib()
    # the split operands: (parts, Mp, Kp) and (parts, Np, Kp), held here
    # until the launch is queued
    parts = 1 if in_bf16 else 2
    mp, np_, kp = (-(-v // t) * t for v, t in zip((m, n, k), TILE))
    scratch = (torch.empty((parts, mp, kp), device=dev),
               torch.empty((parts, np_, kp), device=dev))
    rc = lib.gemm_pe_launch(m, n, k, _ptr(x), _ptr(w), *map(_ptr, scratch),
                            _ptr(out), int(in_bf16), int(out_bf16),
                            ctypes.byref(arg), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"gemm_pe_launch failed: CUDA error {rc} "
                           f"({lib.gemm_pe_error_string(rc).decode()})")
    return (out if out.dtype == out_dtype else out.to(out_dtype)), True


def gemm_pe(x, w, *extras, epilogue: Optional[Graph] = None,
            extra_kinds: Tuple[str, ...] = (), out_dtype=None,
            device="cuda") -> torch.Tensor:
    """x (M, K) @ w (K, N) with the fused ``epilogue`` (a PE pattern whose
    first free port is the accumulator; one extra per further free port,
    of kind ``vec`` (N,) or ``full`` (M, N)).  Returns (M, N) in
    ``out_dtype or x.dtype``.

    Operands (tensors or arrays) are moved to ``device``: K5 on the card
    (the default; raises without one), the plain version on
    ``device="cpu"``.  Any M, N, K: K5's first pass writes the operands'
    TF32 parts zero-padded to whole tiles (scratch of (Mp + Np) * Kp
    float32 a part), and its main kernel masks the result's ragged edge.
    """
    out, launched = _run(x, w, extras, epilogue, extra_kinds, out_dtype,
                         device)
    gemm_pe.launches += launched
    return out


gemm_pe.launches = 0
