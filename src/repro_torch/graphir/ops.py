"""Primitive operation vocabulary for dataflow graphs.

This is the analogue of the CoreIR primitive library in the paper: every node
of an application dataflow graph carries one of these ops.  Each op belongs to
a *hardware unit* (``hw_unit``) — the paper merges two nodes iff they "are the
same operation, or can both be implemented on the same hardware block"
(Sec. III-C), so the unit partition drives subgraph merging.

Area/energy numbers are 16 nm-class analytical estimates for 16-bit datapaths,
scaled from the Horowitz ISSCC'14 energy survey (45 nm) by ~3x energy / ~4x
area per node generation.  Absolute values are NOT the reproduction target —
the paper's claims are ratios (baseline PE vs. specialized PE), and ratios are
insensitive to the calibration constant.  See DESIGN.md §7.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class OpInfo:
    """Static description of a primitive op."""

    name: str
    arity: int
    hw_unit: str          # hardware block that implements the op
    area_um2: float       # 16 nm, 16-bit datapath, um^2
    energy_pj: float      # pJ per 16-bit operation
    commutative: bool = False
    flops: int = 1        # useful-work accounting (mac counts as 2)


# ---------------------------------------------------------------------------
# Hardware units.  The paper's baseline PE (Fig. 7) contains an ALU
# (add/sub/shift/compare), a multiplier, and a LUT for bit ops.  We keep that
# partition and add a "special" unit for transcendental ops that only appear
# in the ML/LM-domain graphs (piecewise-linear unit in hardware terms).
# ---------------------------------------------------------------------------
U_ADD = "adder"
U_MUL = "multiplier"
U_MAC = "mac"            # fused multiply-add block (mult + adder)
U_SHIFT = "shifter"
U_CMP = "comparator"
U_LOGIC = "lut"
U_MUX = "mux"
U_CONST = "const_reg"
U_DIV = "divider"
U_SPECIAL = "special"    # exp / tanh / sigmoid / rsqrt / sqrt / recip
U_REDUCE = "reduce"      # tensor-level reduction macro-node (LM graphs)
U_MATMUL = "matmul"      # tensor-level matmul macro-node (LM graphs)
U_IO = "io"              # graph inputs / outputs — never merged, zero cost

# Area (um^2) and energy (pJ/op) per hardware unit at 16 nm / 16-bit.
UNIT_AREA: Dict[str, float] = {
    U_ADD: 62.0,
    U_MUL: 558.0,
    U_MAC: 602.0,         # multiplier + final adder, shared partial products
    U_SHIFT: 78.0,
    U_CMP: 36.0,
    U_LOGIC: 24.0,
    U_MUX: 11.0,          # 2:1, 16-bit
    U_CONST: 46.0,        # 16 flops + config decode
    U_DIV: 1240.0,
    U_SPECIAL: 2210.0,    # piecewise-linear transcendental unit
    U_REDUCE: 0.0,
    U_MATMUL: 0.0,
    U_IO: 0.0,
}

UNIT_ENERGY: Dict[str, float] = {
    U_ADD: 0.018,
    U_MUL: 0.24,
    U_MAC: 0.25,
    U_SHIFT: 0.021,
    U_CMP: 0.012,
    U_LOGIC: 0.008,
    U_MUX: 0.003,
    U_CONST: 0.002,
    U_DIV: 0.60,
    U_SPECIAL: 0.85,
    U_REDUCE: 0.0,
    U_MATMUL: 0.0,
    U_IO: 0.0,
}


def _op(name: str, arity: int, unit: str, *, commutative: bool = False,
        flops: int = 1) -> OpInfo:
    return OpInfo(
        name=name,
        arity=arity,
        hw_unit=unit,
        area_um2=UNIT_AREA[unit],
        energy_pj=UNIT_ENERGY[unit],
        commutative=commutative,
        flops=flops,
    )


OPS: Dict[str, OpInfo] = {
    info.name: info
    for info in [
        # ALU family ------------------------------------------------------
        _op("add", 2, U_ADD, commutative=True),
        _op("sub", 2, U_ADD),
        _op("neg", 1, U_ADD),
        _op("abs", 1, U_ADD),
        # multiplier family -----------------------------------------------
        _op("mul", 2, U_MUL, commutative=True),
        _op("mac", 3, U_MAC, flops=2),        # a*b + c  (ports: 0=a,1=b,2=c)
        # shifter -----------------------------------------------------------
        _op("shl", 2, U_SHIFT),
        _op("shr", 2, U_SHIFT),
        _op("ashr", 2, U_SHIFT),
        # comparator family --------------------------------------------------
        _op("eq", 2, U_CMP, commutative=True),
        _op("neq", 2, U_CMP, commutative=True),
        _op("lt", 2, U_CMP),
        _op("lte", 2, U_CMP),
        _op("gt", 2, U_CMP),
        _op("gte", 2, U_CMP),
        _op("min", 2, U_CMP, commutative=True),
        _op("max", 2, U_CMP, commutative=True),
        # LUT / bit ops -------------------------------------------------------
        _op("and", 2, U_LOGIC, commutative=True),
        _op("or", 2, U_LOGIC, commutative=True),
        _op("xor", 2, U_LOGIC, commutative=True),
        _op("not", 1, U_LOGIC),
        _op("sign", 1, U_LOGIC),
        # mux / select --------------------------------------------------------
        _op("sel", 3, U_MUX),                 # ports: 0=cond, 1=false, 2=true
        _op("cmux", 2, U_MUX),                # config-register mux (merged PEs);
                                              # variadic data ports 0..k-1
        # divider / special ---------------------------------------------------
        _op("div", 2, U_DIV),
        _op("recip", 1, U_DIV),
        _op("exp", 1, U_SPECIAL),
        _op("log", 1, U_SPECIAL),
        _op("tanh", 1, U_SPECIAL),
        _op("sigmoid", 1, U_SPECIAL),
        _op("rsqrt", 1, U_SPECIAL),
        _op("sqrt", 1, U_SPECIAL),
        _op("erf", 1, U_SPECIAL),
        _op("pow", 2, U_SPECIAL),
        _op("floor", 1, U_SHIFT),
        _op("round", 1, U_SHIFT),
        # structural ----------------------------------------------------------
        _op("const", 0, U_CONST),
        _op("input", 0, U_IO),
        _op("output", 1, U_IO),
        # tensor-level macro nodes (LM-layer graphs; zero PE-cost, they map
        # to the MXU / reductions and are costed by the roofline model) -----
        _op("matmul", 2, U_MATMUL, flops=2),
        _op("rsum", 1, U_REDUCE),
        _op("rmax", 1, U_REDUCE),
        _op("rmean", 1, U_REDUCE),
        _op("cat", 2, U_IO),
        _op("iota", 0, U_IO),
        _op("gather", 2, U_IO),
        _op("scatter", 3, U_IO),
        _op("cumsum", 1, U_REDUCE),
        _op("sort", 1, U_REDUCE),
        _op("argmax", 1, U_REDUCE),
        _op("top_k", 1, U_REDUCE),
        _op("rmin", 1, U_REDUCE),
        _op("opaque", 0, U_IO),   # unmapped structural primitive (jaxpr path)
    ]
}


# Ops that may be *merged* onto the same hardware block even though the op
# names differ (paper Sec. III-C: "can both be implemented on the same
# hardware block").  The unit partition above already encodes this; helper
# below answers the mergeability question used by core/merge.py.
def mergeable(op_a: str, op_b: str) -> bool:
    """True iff two ops can share one hardware block in a merged PE."""
    ia, ib = OPS[op_a], OPS[op_b]
    if ia.hw_unit in (U_IO,):
        return False
    if ia.hw_unit == ib.hw_unit:
        return True
    # a MAC block subsumes a lone multiplier or a lone adder
    pair = {ia.hw_unit, ib.hw_unit}
    if pair <= {U_MAC, U_MUL} or pair <= {U_MAC, U_ADD}:
        return True
    return False


def merged_unit(op_a: str, op_b: str) -> str:
    """Hardware unit implementing both ops (call only if mergeable)."""
    ia, ib = OPS[op_a], OPS[op_b]
    if ia.hw_unit == ib.hw_unit:
        return ia.hw_unit
    return U_MAC  # only cross-unit merge allowed is into a MAC block


def unit_of(op: str) -> str:
    return OPS[op].hw_unit


def area_of(op: str) -> float:
    return OPS[op].area_um2


def energy_of(op: str) -> float:
    return OPS[op].energy_pj


#: ops excluded from mined patterns (pattern interiors must be real compute)
NON_COMPUTE = {"input", "output"}

#: number of PE data inputs each op consumes when standing alone
def op_arity(op: str) -> int:
    return OPS[op].arity
