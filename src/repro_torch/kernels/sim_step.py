"""Tile-step ALU dispatch and the cycle-stepper kernel of the simulator.

Every simulated cycle, all PE tiles execute one micro-op of their
configured datapath in lockstep: gather operands, apply the tile's opcode,
write the result.  Opcode 0 is always ``nop`` (padding lanes).  Semantics
are those of the JAX package's simulator (``ALU_IMPLS`` under XLA's CPU
backend) in float32: predicates are encoded as 1.0/0.0 and consumed as
``x != 0``; ``min``/``max`` propagate NaN and order -0 below +0; ``sign``
keeps -0 and NaN; ``sqrt`` is correctly rounded.  ``mac`` rounds as XLA
compiles it: one fused multiply-add when the dispatch's op table lacks
``mul``, and ``a * b`` rounded then ``+ c`` rounded when it holds ``mul``
(the product is then shared with ``mul``'s branch and not contracted);
:func:`kernel_op_ids` applies that rule to a table, once, on the host.
So a schedule simulated here bit-matches the JAX package's simulator,
and the interpreter on IEEE-exact op sets (the whole paper suite:
add/sub/mul/min/max/shift/compare/select).

Plain PyTorch functions:

* :func:`alu_step_reference` — NumPy oracle over the interpreter's
  ``SEMANTICS`` table;
* :func:`alu_step_plain` — compute-all-select over a static op table (the
  reference's ``alu_step_jnp`` and its Pallas ``_build_step_kernel``);
* :func:`alu_step_masked` — the same with an activity mask (inactive
  lanes retire 0.0);
* :func:`alu_step_jnp` — the reference's ``lax.switch`` step (codes
  clamped to the table), on either device.

Kernel K3 (CUDA C++ for sm_90a, ``csrc/sim_step.cu``), with its plain
version beside it:

* :func:`simulate_batch_stepper` — every cycle of every program of one
  bucket, for every input row, in one launch; replaces the reference's
  vmapped ``lax.scan`` (``sim/cycle.py::_build_batch_stepper``) with the
  compute-all-select ALU of the Pallas ``_build_step_kernel`` inside it;
  each cycle walks only the events of its phase (:func:`event_lists`);
* :func:`simulate_batch_plain` — the reference's step function in
  PyTorch, one Python iteration per cycle, on any device.

* :func:`alu_step_pallas` — the reference's Pallas step entry point: one
  free-standing ALU step of every lane, one launch of ``alu_step_kernel``
  (same source), K3's ALU dispatch outside its cycle loop.

Each wrapper counts its launches in ``<function>.launches``.  For a CUDA
tensor it launches its kernel or raises; it never falls back to the
plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .pnr_cost import _check, _ptr, _stream

__all__ = ["ALU_IMPLS", "EVENT_KINDS", "OP_IDS", "OP_MAC2", "TABLES",
           "kernel_op_ids", "op_table",
           "alu_step_reference", "alu_step_plain", "alu_step_jnp",
           "alu_step_pallas", "alu_step_masked",
           "event_lists", "launch_stepper", "micro_ops", "prepare_stepper",
           "simulate_batch_plain", "simulate_batch_stepper",
           "stepper_state_bytes"]

_SOURCE = "sim_step.cu"

#: dynamic shared memory a block may opt into on Hopper (227 KB)
SMEM_LIMIT = 232448


def _f(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(like.dtype)


def _pow2(b: torch.Tensor) -> torch.Tensor:
    """``2.0 ** b`` in float32, exact for integer ``b`` (built from the
    exponent bits), libm's ``pow`` otherwise."""
    n = torch.clamp(torch.nan_to_num(b, nan=0.0), -150.0, 128.0).to(
        torch.int32)
    normal = torch.clamp(n + 127, 1, 254) << 23
    sub = torch.ones_like(n) << torch.clamp(n + 149, 0, 22)
    bits = torch.where(n >= -126, normal, sub).view(torch.float32)
    exact = torch.where(n > 127, torch.full_like(b, float("inf")),
                        torch.where(n < -149, torch.zeros_like(b), bits))
    return torch.where(b == torch.floor(b), exact,
                       torch.pow(torch.full_like(b, 2.0), b))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA contracts ``mac`` in a
    table without ``mul``: the exact product in float64, the sum rounded
    to odd there, then one rounding to float32."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)          # s + err == p + c exactly
    bits = s.view(torch.int64)
    inexact = (err != 0) & torch.isfinite(err)
    toward_zero = (err < 0) != (s < 0)
    odd = torch.where(toward_zero, bits - 1, bits) | 1
    return torch.where(inexact, odd, bits).view(torch.float64).float()


def _min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    pick_a = (a < b) | ((a == b) & torch.signbit(a))
    return torch.where(torch.isnan(a) | torch.isnan(b), a + b,
                       torch.where(pick_a, a, b))


def _max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    pick_a = (a > b) | ((a == b) & ~torch.signbit(a))
    return torch.where(torch.isnan(a) | torch.isnan(b), a + b,
                       torch.where(pick_a, a, b))


#: (a, b, c) -> result, all float32; the order is the op id the kernel's
#: ``switch`` uses (``enum AluOp`` in ``csrc/sim_step.cu``)
ALU_IMPLS: Dict[str, Callable] = {
    "nop": lambda a, b, c: torch.zeros_like(a),
    "add": lambda a, b, c: a + b,
    "sub": lambda a, b, c: a - b,
    "neg": lambda a, b, c: -a,
    "abs": lambda a, b, c: torch.abs(a),
    "mul": lambda a, b, c: a * b,
    "mac": lambda a, b, c: _fma(a, b, c),
    "div": lambda a, b, c: a / b,
    "recip": lambda a, b, c: 1.0 / a,
    "shl": lambda a, b, c: a * _pow2(b),
    "shr": lambda a, b, c: a / _pow2(b),
    "ashr": lambda a, b, c: a / _pow2(b),
    "eq": lambda a, b, c: _f(a == b, a),
    "neq": lambda a, b, c: _f(a != b, a),
    "lt": lambda a, b, c: _f(a < b, a),
    "lte": lambda a, b, c: _f(a <= b, a),
    "gt": lambda a, b, c: _f(a > b, a),
    "gte": lambda a, b, c: _f(a >= b, a),
    "min": lambda a, b, c: _min(a, b),
    "max": lambda a, b, c: _max(a, b),
    "and": lambda a, b, c: _f((a != 0) & (b != 0), a),
    "or": lambda a, b, c: _f((a != 0) | (b != 0), a),
    "xor": lambda a, b, c: _f((a != 0) ^ (b != 0), a),
    "not": lambda a, b, c: _f(a == 0, a),
    "sign": lambda a, b, c: torch.where(
        a > 0, torch.ones_like(a), torch.where(a < 0, -torch.ones_like(a),
                                               a)),
    "sel": lambda a, b, c: torch.where(a != 0, c, b),   # cond,false,true
    "floor": lambda a, b, c: torch.floor(a),
    "round": lambda a, b, c: torch.round(a),            # half to even
    "exp": lambda a, b, c: torch.exp(a),
    "log": lambda a, b, c: torch.log(a),
    "tanh": lambda a, b, c: torch.tanh(a),
    "sigmoid": lambda a, b, c: 1.0 / (1.0 + torch.exp(-a)),
    "rsqrt": lambda a, b, c: torch.rsqrt(a),
    "sqrt": lambda a, b, c: torch.sqrt(a.double()).float(),
    "pow": lambda a, b, c: torch.pow(a, b),
}

#: global op id of every ALU op (the kernel's ``enum AluOp``)
OP_IDS: Dict[str, int] = {name: i for i, name in enumerate(ALU_IMPLS)}

#: op id, past the table's, of ``mac`` rounded twice (``a * b`` rounded,
#: then ``+ c``): the kernel's ``OP_MAC2``
OP_MAC2 = len(ALU_IMPLS)

#: the plain version of every op id a kernel reads
_IMPL_OF_ID: Tuple[Callable, ...] = tuple(ALU_IMPLS.values()) + (
    lambda a, b, c: a * b + c,)


def kernel_op_ids(ops: Sequence[str]) -> Tuple[int, ...]:
    """The op id a kernel reads for each entry of the op table ``ops``.

    XLA contracts ``mac``'s ``a * b + c`` into one FMA only when the
    dispatch has no ``mul``: with ``mul`` in the table the product is
    shared with ``mul``'s branch and rounded before ``+ c``.  So ``mac``
    is :data:`OP_MAC2` in a table that holds ``mul``, ``OP_IDS["mac"]``
    otherwise; every other op is its :data:`OP_IDS` entry."""
    twice = "mul" in ops
    return tuple(OP_MAC2 if twice and name == "mac" else OP_IDS[name]
                 for name in ops)


def op_table(used_ops: Sequence[str]) -> Tuple[str, ...]:
    """Static opcode table for a design: nop first, then sorted used ops."""
    missing = sorted(set(used_ops) - set(ALU_IMPLS))
    if missing:
        raise NotImplementedError(f"no ALU dispatch for ops {missing}")
    return ("nop",) + tuple(sorted(set(used_ops) - {"nop"}))


def alu_step_reference(codes: np.ndarray, a: np.ndarray, b: np.ndarray,
                       c: np.ndarray, ops: Tuple[str, ...]) -> np.ndarray:
    """NumPy oracle built on the interpreter's SEMANTICS table (independent
    of the torch implementations above); codes (N,), operands (..., N)."""
    from ..graphir.interp import SEMANTICS
    from ..graphir.ops import OPS

    out = np.zeros_like(a, dtype=np.float32)
    for k, name in enumerate(ops):
        m = codes == k
        if not m.any() or name == "nop":
            continue
        args = [x[..., m].astype(np.float32) for x in (a, b, c)]
        if name == "sel":
            r = SEMANTICS[name](args[0] != 0, args[1], args[2])
        else:
            r = SEMANTICS[name](*args[:OPS[name].arity])
        out[..., m] = np.asarray(r, dtype=np.float32)
    return out


def alu_step_plain(codes: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, ops: Tuple[str, ...]) -> torch.Tensor:
    """Compute-all-select dispatch: every op of the static table on every
    lane, selected by opcode (0 -> 0.0).  codes broadcast to ``a``;
    ``mac`` rounds by the table (:func:`kernel_op_ids`)."""
    return _alu_by_ids(codes, a, b, c, kernel_op_ids(ops))


def _alu_by_ids(codes, a, b, c, ids: Sequence[int]) -> torch.Tensor:
    """:func:`alu_step_plain` over a table of op ids: code ``k`` runs op
    id ``ids[k]``."""
    out = torch.zeros_like(a)
    for k, i in enumerate(ids):
        if i != OP_IDS["nop"]:
            out = torch.where(codes == k, _IMPL_OF_ID[i](a, b, c), out)
    return out


def alu_step_jnp(codes, a, b, c, ops: Tuple[str, ...], *,
                 device="cuda") -> torch.Tensor:
    """The reference's ``alu_step_jnp``: every lane's op by ``lax.switch``
    on its code, which clamps a code outside the table to its nearest
    end (a negative one to nop, one past the end to the last op).  codes
    (N,), operands (N,) or (B, N) (tensors or arrays, moved to
    ``device``).  Plain PyTorch on either device, as the reference's is
    jnp: :func:`alu_step_plain` on the clamped codes."""
    dev = resolve_device(device)
    codes, a, b, c = (torch.as_tensor(x, device=dev)
                      for x in (codes, a, b, c))
    return alu_step_plain(torch.clamp(codes, 0, len(ops) - 1), a, b, c, ops)


def alu_step_pallas(codes, a, b, c, ops: Tuple[str, ...], *,
                    interpret: bool = True, device="cuda") -> torch.Tensor:
    """The reference's Pallas ``_build_step_kernel`` entry point: one ALU
    step of every lane, compute-all-select, a code outside the table
    retiring 0.0.  codes (N,) or broadcast to the operands (N,) or (..., N)
    (tensors or arrays, moved to ``device``); the result float32 of the
    operands' shape.

    On the card one launch of ``alu_step_kernel`` (``csrc/sim_step.cu``:
    K3's ALU dispatch ``alu`` over the lanes; counted in
    ``alu_step_pallas.launches``); on ``device="cpu"``
    :func:`alu_step_plain`.  Both follow XLA's CPU semantics, as the
    reference's step does in interpret mode: ``mac`` one FMA when ``ops``
    lacks ``mul``, its product rounded first when ``ops`` holds it
    (:func:`kernel_op_ids`).  ``interpret`` is accepted and ignored."""
    dev = resolve_device(device)
    a, b, c = (torch.as_tensor(x, device=dev).to(torch.float32)
               for x in (a, b, c))
    codes = torch.as_tensor(codes, device=dev).to(torch.int32)
    if dev.type != "cuda":
        return alu_step_plain(codes, a, b, c, ops)
    shape = a.shape
    cols = shape[-1] if a.dim() else 1
    a2, b2, c2 = (x.reshape(-1, cols).contiguous() for x in (a, b, c))
    if b2.shape != a2.shape or c2.shape != a2.shape:
        raise ValueError(f"a, b and c must share one shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    if codes.dim() <= 1:
        codes2, stride = torch.broadcast_to(codes, (cols,)).contiguous(), 0
    else:
        codes2 = torch.broadcast_to(codes, shape).reshape(-1, cols)
        codes2, stride = codes2.contiguous(), cols
    table = _op_ids_on(tuple(ops), a2.device)
    out = torch.empty_like(a2)
    lib = _lib()
    rc = lib.sim_alu_step(a2.numel(), cols, stride, len(ops), _ptr(codes2),
                          _ptr(table), _ptr(a2), _ptr(b2), _ptr(c2),
                          _ptr(out), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"alu_step_kernel failed to launch: CUDA error "
                           f"{rc} ({lib.sim_error_string(rc).decode()})")
    alu_step_pallas.launches += 1
    return out.reshape(shape)


alu_step_pallas.launches = 0


@functools.lru_cache(maxsize=64)
def _op_ids_on(ops: Tuple[str, ...], dev: torch.device) -> torch.Tensor:
    """:func:`kernel_op_ids` of ``ops`` (int32, on ``dev``), made once for
    each table and device: copying it to the card on every call would set
    :func:`alu_step_pallas`'s time.  Read only."""
    return torch.tensor(kernel_op_ids(ops), dtype=torch.int32, device=dev)


def alu_step_masked(codes: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, ops: Tuple[str, ...],
                    active: torch.Tensor) -> torch.Tensor:
    """:func:`alu_step_plain` with a dynamic activity mask (broadcast to
    ``a``): padded lanes and micro-op steps retire 0.0, the value the nop
    padding computes, so one bucket-shaped dispatch serves every program
    of a bucket and real lanes keep their per-program results."""
    out = alu_step_plain(codes, a, b, c, ops)
    return torch.where(active, out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# K3: the cycle stepper
# ---------------------------------------------------------------------------
#: stacked per-program tables of one bucket, in the kernel's argument
#: order; G programs, padded to the bucket's (ip, up, ep, sp, wp, lp, cp,
#: op) shapes: ii (G,), dims (G, 2) = [n_steps, n_inst], opcodes (G, ip,
#: up), op_src (G, ip, up, 3), const_pool (G, cp) float32, fire_time (G,
#: ip), ext_time (G, ep), wire_src (G, wp), sig_tmp / sig_owner (G, sp),
#: latch_wire / latch_time / latch_owner (G, lp), out_wire / out_time
#: (G, op); all int32 but const_pool
TABLES = ("ii", "dims", "opcodes", "op_src", "const_pool", "fire_time",
          "ext_time", "wire_src", "sig_tmp", "sig_owner", "latch_wire",
          "latch_time", "latch_owner", "out_wire", "out_time")


def _shapes(tables: Dict[str, torch.Tensor]) -> Dict[str, int]:
    g, ip, up = tables["opcodes"].shape
    return dict(g=g, ip=ip, up=up, ep=tables["ext_time"].shape[1],
                sp=tables["sig_tmp"].shape[1],
                wp=tables["wire_src"].shape[1],
                lp=tables["latch_wire"].shape[1],
                cp=tables["const_pool"].shape[1],
                op=tables["out_wire"].shape[1])


def stepper_state_bytes(ip: int, up: int, ep: int, sp: int, wp: int,
                        lp: int, cp: int, latch_depth: int) -> int:
    """Bytes of machine state one (program, input row) keeps for the whole
    run: the ext/sig registers, double-buffered wire registers, the latch
    FIFOs and the operand buffer ``[latch view | const | tmp]``."""
    return 4 * (ep + sp + 2 * wp + lp * latch_depth + lp + cp + ip * up)


def simulate_batch_plain(tables: Dict[str, torch.Tensor],
                         inputs: torch.Tensor, op_ids: torch.Tensor, *,
                         cycles: int, latch_depth: int) -> torch.Tensor:
    """Plain version of K3: the reference's batched step function, every
    program and input row at once, one Python iteration per cycle.

    ``inputs`` (G, B, K, ep) float32; ``op_ids`` (n_codes,) the op id
    (:func:`kernel_op_ids`) of each bucket opcode.  Returns the captured
    outputs (G, B, K, op) float32.
    """
    t = {k: tables[k].long() if k != "const_pool" else tables[k]
         for k in TABLES}
    s = _shapes(tables)
    g_n, ip, up, ep, sp, wp, lp, cp, op_n = (
        s[k] for k in ("g", "ip", "up", "ep", "sp", "wp", "lp", "cp", "op"))
    _, b_n, k_n, _ = inputs.shape
    dev, d_n = inputs.device, latch_depth
    ids = op_ids.tolist()
    ii = t["ii"][:, None]                                     # (G, 1)
    n_steps, n_inst = t["dims"][:, 0], t["dims"][:, 1]
    lane_act = torch.arange(ip, device=dev)[None, :] < n_inst[:, None]
    tmp_off = lp + cp

    def periodic(c, t0):
        d = c - t0
        k = torch.div(d, ii, rounding_mode="floor")
        live = (d >= 0) & (torch.remainder(d, ii) == 0) & (k < k_n)
        return live, torch.clamp(k, 0, k_n - 1)

    def take(x, idx):                      # x (G, B, n), idx (G, m)
        return torch.gather(x, 2, idx[:, None, :].expand(-1, b_n, -1))

    zeros = lambda *shape: torch.zeros((g_n, b_n) + shape,
                                       dtype=torch.float32, device=dev)
    ext, sig, wire = zeros(ep), zeros(sp), zeros(wp)
    latch, outbuf = zeros(lp, d_n), zeros(k_n, op_n)
    constb = t["const_pool"][:, None, :].expand(-1, b_n, -1)
    for c in range(cycles):
        fire, fire_k = periodic(c, t["fire_time"])            # (G, ip)
        rd = torch.gather(fire_k, 1, t["latch_owner"]) % d_n  # (G, lp)
        latch_view = torch.gather(
            latch, 3, rd[:, None, :, None].expand(-1, b_n, -1, 1))[..., 0]
        operands = torch.cat([latch_view, constb, zeros(ip * up)], dim=2)
        for u in range(up):
            a, b, c3 = (take(operands, t["op_src"][:, :, u, j])
                        for j in range(3))
            act = (lane_act & (u < n_steps)[:, None])[:, None, :]
            r = _alu_by_ids(t["opcodes"][:, None, :, u], a, b, c3, ids)
            operands[:, :, tmp_off + u:tmp_off + ip * up:up] = torch.where(
                act, r, torch.zeros_like(r))

        owner_fires = torch.gather(fire, 1, t["sig_owner"])[:, None, :]
        sig_new = torch.where(owner_fires,
                              take(operands, tmp_off + t["sig_tmp"]), sig)

        ext_live, ext_k = periodic(c, t["ext_time"])          # (G, ep)
        stream = torch.gather(inputs, 2, ext_k[:, None, None, :].expand(
            -1, b_n, 1, -1))[:, :, 0, :]                      # (G, B, ep)
        ext_new = torch.where(ext_live[:, None, :], stream, ext)

        wire_new = take(torch.cat([sig, ext, wire], dim=2), t["wire_src"])

        l_live, l_k = periodic(c, t["latch_time"])
        wr = (l_k % d_n)[:, None, :, None].expand(-1, b_n, -1, 1)
        arriving = take(wire, t["latch_wire"])                # (G, B, lp)
        cur = torch.gather(latch, 3, wr)[..., 0]
        latch = latch.scatter(3, wr, torch.where(
            l_live[:, None, :], arriving, cur)[..., None])

        o_live, o_k = periodic(c, t["out_time"])
        oix = o_k[:, None, None, :].expand(-1, b_n, 1, -1)
        prev = torch.gather(outbuf, 2, oix)[:, :, 0, :]
        vals = take(wire, t["out_wire"])
        outbuf = outbuf.scatter(2, oix, torch.where(
            o_live[:, None, :], vals, prev)[:, :, None, :])

        ext, sig, wire = ext_new, sig_new, wire_new
    return outbuf


def _lib():
    from .build import load
    lib = load(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sim_stepper.argtypes = [i] * 17 + [p] * 16
        lib.sim_stepper.restype = i
        lib.sim_alu_step.argtypes = [ctypes.c_longlong] + [i] * 3 + [p] * 7
        lib.sim_alu_step.restype = i
        lib.sim_error_string.argtypes = [i]
        lib.sim_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_tables(tables, inputs, op_ids, dev) -> Dict[str, int]:
    missing = [k for k in TABLES if k not in tables]
    if missing:
        raise ValueError(f"simulate_batch_stepper: missing tables {missing}")
    s = _shapes(tables)
    g, ip, up = s["g"], s["ip"], s["up"]
    shapes = dict(ii=(g,), dims=(g, 2), opcodes=(g, ip, up),
                  op_src=(g, ip, up, 3), const_pool=(g, s["cp"]),
                  fire_time=(g, ip), ext_time=(g, s["ep"]),
                  wire_src=(g, s["wp"]), sig_tmp=(g, s["sp"]),
                  sig_owner=(g, s["sp"]), latch_wire=(g, s["lp"]),
                  latch_time=(g, s["lp"]), latch_owner=(g, s["lp"]),
                  out_wire=(g, s["op"]), out_time=(g, s["op"]))
    for k in TABLES:
        dt = torch.float32 if k == "const_pool" else torch.int32
        _check(k, tables[k], dt, shapes[k], dev)
    if inputs.dim() != 4:
        raise ValueError(f"inputs: expected (G, B, K, ep), got "
                         f"{tuple(inputs.shape)}")
    _check("inputs", inputs, torch.float32,
           (g,) + tuple(inputs.shape[1:3]) + (s["ep"],), dev)
    _check("op_ids", op_ids, torch.int32, (op_ids.numel(),), dev)
    return s


def _check_indices(t, s, op_ids: torch.Tensor) -> None:
    """Index tables and op ids in range, every operand read from the tmp
    buffer a slot of the reading tile itself (the kernel runs each tile's
    micro-ops in order on one thread, with no barrier between steps), and
    every signal loading a tmp slot of its owner (the kernel computes a
    tile only in the cycles it fires)."""
    ip, up, lp, cp = s["ip"], s["up"], s["lp"], s["cp"]
    tmp_off = lp + cp
    src = t["op_src"]
    lane = torch.arange(ip, device=src.device)[None, :, None, None]
    foreign = (src >= tmp_off) & ((src - tmp_off) // up != lane)

    def out_of(x, hi):
        return (x < 0) | (x >= hi)

    bad = torch.stack([
        out_of(src, tmp_off + ip * up).any(), foreign.any(),
        out_of(t["opcodes"], op_ids.numel()).any(),
        out_of(op_ids, OP_MAC2 + 1).any(),
        out_of(t["wire_src"], s["sp"] + s["ep"] + s["wp"]).any(),
        out_of(t["sig_tmp"], ip * up).any(),
        out_of(t["sig_owner"], ip).any(),
        (t["sig_tmp"] // up != t["sig_owner"]).any(),
        out_of(t["latch_wire"], s["wp"]).any(),
        out_of(t["latch_owner"], ip).any(),
        out_of(t["out_wire"], s["wp"]).any(),
        (t["ii"] < 1).any()])
    if bool(bad.any()):
        raise ValueError("simulate_batch_stepper: an index table or op id "
                         "is out of range, an operand or a signal reads "
                         "another tile's tmp slot, or an II is < 1 (checks: "
                         f"{bad.tolist()})")


#: K3's event kinds, in the order of its lists (``enum EvKind``): tiles
#: (``fire_time``), signals (their owner's ``fire_time``), exts, latch
#: captures and output captures (their own times)
EVENT_KINDS = ("tile", "sig", "ext", "latch", "out")


def event_times(tables: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The first event time (G, n) of every entity of each of
    :data:`EVENT_KINDS`."""
    fire = tables["fire_time"].long()
    return (fire, torch.gather(fire, 1, tables["sig_owner"].long()),
            tables["ext_time"].long(), tables["latch_time"].long(),
            tables["out_time"].long())


def event_lists(tables: Dict[str, torch.Tensor], *, cycles: int,
                iterations: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """K3's per-phase event lists: ``(ev, off, nb)``, on the tables'
    device.

    An entity with first event ``t0`` fires at ``t0 + k * II`` for ``k <
    iterations``.  It is listed (once) under phase ``b = t0 mod II`` of its
    program as ``ev[e] = (index, t0 div II)`` (floor semantics) if it fires
    in ``[0, cycles)``; at cycle ``c = m * II + b`` it fires iff ``0 <= m -
    (t0 div II) < iterations``, at ``k = m - (t0 div II)``.  ``off`` (5, G,
    nb) int32: list ``b`` of kind ``j`` of program ``g`` is ``ev[off[j, g,
    b]:off[j, g, b + 1]]``; ``nb`` is the bucket's largest II + 1.  Plain
    PyTorch, all kinds in one pass on the host (a few thousand entries:
    one copy each way beats many small launches on the card).
    """
    dev = tables["ii"].device
    ev, off, nb = _event_lists_host(tables, cycles=cycles,
                                    iterations=iterations)
    return ev.to(dev), off.to(dev), nb


def _event_lists_host(tables, *, cycles: int, iterations: int):
    """:func:`event_lists` on the host (int32, contiguous)."""
    times = event_times(tables)
    sizes = [t.shape[1] for t in times]
    # one copy to the host: the IIs in column 0, then every kind's times
    packed = torch.cat([tables["ii"].long()[:, None], *times], 1).cpu()
    ii, t = packed[:, :1], packed[:, 1:]
    g_n = ii.shape[0]
    n_ph = max(1, int(ii.max())) if g_n else 1
    kind = torch.cat([torch.full((n,), j) for j, n in enumerate(sizes)])
    idx = torch.cat([torch.arange(n) for n in sizes])
    m0 = torch.div(t, ii, rounding_mode="floor")
    k0 = torch.clamp(-m0, min=0)                  # first k with t + k*II >= 0
    live = (k0 < iterations) & (t + k0 * ii < cycles)
    # list (kind, program, phase) in that order
    key = (kind * g_n + torch.arange(g_n)[:, None]) * n_ph + (t - m0 * ii)
    key, m0 = key[live], m0[live]
    order = torch.sort(key, stable=True).indices
    ev = torch.stack([idx.expand_as(t)[live][order], m0[order]], 1)
    n_lists = len(sizes) * g_n * n_ph
    starts = torch.zeros(n_lists + 1, dtype=torch.long)
    starts[1:] = torch.cumsum(torch.bincount(key, minlength=n_lists), 0)
    at = (torch.arange(len(sizes) * g_n)[:, None] * n_ph
          + torch.arange(n_ph + 1))
    off = starts[at].view(len(sizes), g_n, n_ph + 1)
    if ev.numel() == 0:
        ev = torch.zeros((1, 2), dtype=torch.long)
    return (ev.to(torch.int32).contiguous(),
            off.to(torch.int32).contiguous(), n_ph + 1)


def micro_ops(tables: Dict[str, torch.Tensor],
              op_ids: torch.Tensor) -> torch.Tensor:
    """(G, ip, up, 4) int32: each micro-op as {global op id, operands a, b,
    c}, the bucket's opcode table folded in."""
    op = op_ids.long()[tables["opcodes"].long()]
    return torch.cat([op[..., None].to(torch.int32), tables["op_src"]],
                     -1).contiguous()


def simulate_batch_stepper(tables: Dict[str, torch.Tensor],
                           inputs: torch.Tensor, op_ids: torch.Tensor, *,
                           cycles: int, latch_depth: int,
                           force_global: bool = False) -> torch.Tensor:
    """Run ``cycles`` cycles of every program of one bucket on every input
    row; returns the captured outputs (G, B, K, op) float32.

    ``tables``: the stacked per-program tables (:data:`TABLES`);
    ``inputs`` (G, B, K, ep) float32; ``op_ids`` (n_codes,) int32 op ids
    (:func:`kernel_op_ids`) of the bucket's opcodes.

    Kernel K3 (``sim_stepper_kernel``): one block per (program, input
    row) runs the whole cycle loop with the machine state resident in
    shared memory — or, when it exceeds 227 KB or ``force_global`` is
    set, in a global scratch buffer, same kernel body.  Each cycle walks
    only its phase's events (:func:`event_lists`): the tiles firing then
    run the compute-all-select step of the reference's Pallas
    ``_build_step_kernel`` (with ``alu_step_masked``'s mask) as a device
    function.  The dependent chain of cycles, each three block-wide
    barriers, sets its pace; bytes and operations are far below it.
    """
    if inputs.device.type != "cuda":
        return simulate_batch_plain(tables, inputs, op_ids, cycles=cycles,
                                    latch_depth=latch_depth)
    return launch_stepper(prepare_stepper(
        tables, inputs, op_ids, cycles=cycles, latch_depth=latch_depth,
        force_global=force_global))


simulate_batch_stepper.launches = 0


def prepare_stepper(tables: Dict[str, torch.Tensor], inputs: torch.Tensor,
                    op_ids: torch.Tensor, *, cycles: int, latch_depth: int,
                    force_global: bool = False,
                    floor: bool = False) -> Tuple:
    """The host's share of :func:`simulate_batch_stepper` on CUDA tensors:
    the checks, the event lists, the folded micro-ops and the output and
    scratch buffers; returns the launch's arguments for
    :func:`launch_stepper` (so the kernel can be timed apart).  ``floor``
    keeps only the cycle loop's barriers and event walks: the floor of a
    cycle, for timing; the outputs stay zero."""
    dev = inputs.device
    s = _check_tables(tables, inputs, op_ids, dev)
    _check_indices(tables, s, op_ids)
    g, b, k = inputs.shape[:3]
    state = stepper_state_bytes(s["ip"], s["up"], s["ep"], s["sp"],
                                s["wp"], s["lp"], s["cp"], latch_depth)
    ev, off, nb = _event_lists_host(tables, cycles=cycles, iterations=k)
    # a block stages its program's event lists in shared memory too
    ev_cap = int((off[:, :, -1] - off[:, :, 0]).sum(0).max())
    ev, off = ev.to(dev), off.to(dev)
    lists = 8 * ev_cap + 4 * len(EVENT_KINDS) * nb
    use_global = force_global or state + 4 + lists > SMEM_LIMIT
    outbuf = torch.zeros((g, b, k, s["op"]), dtype=torch.float32,
                         device=dev)
    scratch = torch.empty((g * b * state // 4 if use_global else 1,),
                          dtype=torch.float32, device=dev)
    ints = (g, b, k, cycles, latch_depth, s["ip"], s["up"], s["ep"],
            s["sp"], s["wp"], s["lp"], s["cp"], s["op"], nb, ev_cap,
            int(use_global), int(floor))
    bufs = (tables["ii"], tables["dims"], micro_ops(tables, op_ids),
            tables["const_pool"], tables["fire_time"], tables["wire_src"],
            tables["sig_tmp"], tables["latch_wire"], tables["latch_owner"],
            tables["out_wire"], ev, off, inputs, outbuf, scratch)
    return ints, bufs, dev


def launch_stepper(args: Tuple) -> torch.Tensor:
    """Launch K3 on the arguments of :func:`prepare_stepper` (which hold
    its buffers alive); returns the output buffer."""
    ints, bufs, dev = args
    lib = _lib()
    rc = lib.sim_stepper(*ints, *(_ptr(x) for x in bufs), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"sim_stepper_kernel failed to launch: CUDA "
                           f"error {rc} ({lib.sim_error_string(rc).decode()})")
    simulate_batch_stepper.launches += 1
    return bufs[-2]
