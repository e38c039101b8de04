"""Subgraph merging into a reconfigurable PE datapath (paper Sec. III-C).

Following Moreano et al. (the paper's reference [7]):

1. Enumerate *merge opportunities* between the incoming subgraph B and the
   accumulated datapath A: node-node (same hardware block, Fig. 5c) and
   edge-edge (both endpoint merges possible and destination ports match).
2. Build the *compatibility graph*: opportunities as vertices, weight = area
   saved, edge = the two opportunities induce a consistent injective mapping.
3. Solve **maximum-weight clique** (Fig. 5d) -> the lowest-area merge.
4. Reconstruct: merged nodes share one unit; a port receiving different
   sources across configs grows a config mux (Fig. 5e); external inputs and
   output lines are shared greedily across configs.

The datapath accumulates configs (one per merged subgraph), so "merge many
subgraphs" = fold :func:`add_pattern`.  Single ops are 1-node patterns, which
makes the paper's PE 1 (baseline ops only) the same code path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..graphir.graph import Graph, free_in_ports, sink_nodes
from ..graphir.interp import interpret_pattern
from ..graphir.ops import (OPS, UNIT_AREA, U_ADD, U_CONST, U_IO, U_MAC,
                           U_MATMUL, U_MUL, U_MUX, U_REDUCE, unit_of)
from .clique import max_weight_clique
from .pe import Config, Datapath, single_op_pattern

MUX_AREA = UNIT_AREA[U_MUX]

#: units a PE datapath can instantiate
_PE_UNITS = {"adder", "multiplier", "mac", "shifter", "comparator", "lut",
             "mux", "divider", "special", "const_reg"}


def is_pe_pattern(pattern: Graph) -> bool:
    """True iff every node can live inside a PE datapath (no tensor macros)."""
    for n, op in pattern.nodes.items():
        if op in ("input", "output"):
            return False
        if unit_of(op) not in _PE_UNITS:
            return False
        if op == "cmux":
            return False
    return True


def _unit_mergeable(unit_a: str, op_b: str) -> bool:
    ub = unit_of(op_b)
    if unit_a == ub:
        return True
    pair = {unit_a, ub}
    return pair <= {U_MAC, U_MUL} or pair <= {U_MAC, U_ADD}


def _merged_unit(unit_a: str, op_b: str) -> str:
    ub = unit_of(op_b)
    return unit_a if unit_a == ub else U_MAC


def _merge_weight(unit_a: str, op_b: str) -> float:
    ub = unit_of(op_b)
    return UNIT_AREA[unit_a] + UNIT_AREA[ub] - UNIT_AREA[_merged_unit(unit_a, op_b)]


@dataclass
class _Opportunity:
    pairs: Dict[int, int]     # pattern node -> unit id (1 for node, 2 for edge)
    weight: float
    kind: str                 # "node" | "edge"


def _opportunities(dp: Datapath, pattern: Graph) -> List[_Opportunity]:
    opps: List[_Opportunity] = []
    for b, op_b in sorted(pattern.nodes.items()):
        for uid, u in sorted(dp.units.items()):
            if _unit_mergeable(u.unit, op_b):
                opps.append(_Opportunity({b: uid}, _merge_weight(u.unit, op_b),
                                         "node"))
    # edge-edge: pattern edge (sb -> db @ p) onto existing source alternative
    for (sb, db, p) in sorted(pattern.edges):
        for (uid_d, port), lst in sorted(dp.alts.items()):
            if port != p:
                continue
            if not _unit_mergeable(dp.units[uid_d].unit, pattern.nodes[db]):
                continue
            for src in lst:
                if src[0] != "n":
                    continue
                uid_s = src[1]
                if not _unit_mergeable(dp.units[uid_s].unit, pattern.nodes[sb]):
                    continue
                if uid_s == uid_d:
                    continue
                opps.append(_Opportunity({sb: uid_s, db: uid_d},
                                         MUX_AREA, "edge"))
    return opps


def _compatible(a: _Opportunity, b: _Opportunity) -> bool:
    for k, v in a.pairs.items():
        if k in b.pairs and b.pairs[k] != v:
            return False
    inv_a = {v: k for k, v in a.pairs.items()}
    for k, v in b.pairs.items():
        if v in inv_a and inv_a[v] != k:
            return False
    return True


def add_pattern(dp: Datapath, pattern: Graph, name: str,
                *, validate: bool = True, rng_seed: int = 0) -> Config:
    """Merge `pattern` into `dp` (mutating) and register it as a config."""
    if not is_pe_pattern(pattern):
        raise ValueError(f"pattern {name!r} contains non-PE ops: "
                         f"{sorted(set(pattern.nodes.values()))}")
    if name in dp.configs:
        raise ValueError(f"config {name!r} already exists")

    opps = _opportunities(dp, pattern)
    adj: List[Set[int]] = [set() for _ in opps]
    for i in range(len(opps)):
        for j in range(i + 1, len(opps)):
            if _compatible(opps[i], opps[j]):
                adj[i].add(j)
                adj[j].add(i)
    chosen = max_weight_clique([o.weight for o in opps], adj,
                               rng_seed=rng_seed)

    mapping: Dict[int, int] = {}
    for i in chosen:
        mapping.update(opps[i].pairs)

    # new units for unmapped pattern nodes; upgrade units for merged ones
    for b, op_b in sorted(pattern.nodes.items()):
        if b in mapping:
            uid = mapping[b]
            u = dp.units[uid]
            u.unit = _merged_unit(u.unit, op_b)
            u.ops.add(op_b)
        else:
            unit = unit_of(op_b)
            uid = dp.new_unit(unit, {op_b})
            mapping[b] = uid

    # wiring + config ------------------------------------------------------
    sel: Dict[Tuple[int, int], int] = {}
    op_assign: Dict[int, str] = {}
    const_vals: Dict[int, object] = {}
    for b, op_b in pattern.nodes.items():
        uid = mapping[b]
        if op_b == "const":
            const_vals[uid] = pattern.attr(b, "value", 0.0)
        else:
            op_assign[uid] = op_b

    for (sb, db, p) in sorted(pattern.edges):
        idx = dp.add_alt(mapping[db], p, ("n", mapping[sb]))
        sel[(mapping[db], p)] = idx

    ext_bind: Dict[Tuple[int, int], int] = {}
    used_ext: Set[int] = set()
    for (b, p) in free_in_ports(pattern):
        uid = mapping[b]
        lst = dp.alts.get((uid, p), [])
        k = None
        for src in lst:                       # reuse an existing ext line
            if src[0] == "ext" and src[1] not in used_ext:
                k = src[1]
                break
        if k is None:                          # lowest unused line (may be new)
            k = 0
            while k in used_ext:
                k += 1
        idx = dp.add_alt(uid, p, ("ext", k))
        sel[(uid, p)] = idx
        ext_bind[(b, p)] = k
        used_ext.add(k)

    out_sel: List[Tuple[int, int]] = []
    used_lines: Set[int] = set()
    for s in sink_nodes(pattern):
        uid = mapping[s]
        line = None
        for li, lst in enumerate(dp.out_alts):  # reuse a line already wired
            if li not in used_lines and ("n", uid) in lst:
                line = li
                break
        if line is None:
            line = 0
            while line in used_lines:
                line += 1
        idx = dp.add_out_alt(line, ("n", uid))
        out_sel.append((line, idx))
        used_lines.add(line)

    cfg = Config(
        name=name, pattern=pattern.copy(), node_map=dict(mapping),
        op_assign=op_assign, sel=sel, ext_bind=ext_bind,
        const_vals=const_vals, out_sel=out_sel,
        active_units=set(mapping.values()),
    )
    dp.configs[name] = cfg
    if validate:
        ok, msg = validate_config(dp, cfg, rng_seed=rng_seed)
        if not ok:
            raise AssertionError(f"merged config {name!r} mis-executes: {msg}")
    return cfg


def validate_config(dp: Datapath, cfg: Config, *, rng_seed: int = 0,
                    trials: int = 4) -> Tuple[bool, str]:
    """Drive the datapath through its muxes and compare with the pattern."""
    rng = np.random.default_rng(rng_seed)
    pattern = cfg.pattern
    sinks = sink_nodes(pattern)
    for _ in range(trials):
        port_values = {(n, p): float(rng.uniform(0.5, 2.0))
                       for (n, p) in free_in_ports(pattern)}
        const_over = {n: float(rng.uniform(0.5, 2.0))
                      for n, op in pattern.nodes.items() if op == "const"}
        vals = interpret_pattern(pattern, port_values, const_over)
        expected = [vals[s] for s in sinks]
        ext_values = {cfg.ext_bind[fp]: v for fp, v in port_values.items()}
        const_unit_over = {cfg.node_map[n]: v for n, v in const_over.items()}
        got = dp.execute(cfg, ext_values, const_override=const_unit_over)
        if not np.allclose(np.array(expected, dtype=np.float64),
                           np.array(got, dtype=np.float64),
                           rtol=1e-6, atol=1e-9):
            return False, f"expected {expected}, datapath produced {got}"
    return True, "ok"


# ---------------------------------------------------------------------------
# Baseline PE (paper Fig. 7): ALU + multiplier + LUT + constant register.
# ---------------------------------------------------------------------------

#: which ops each baseline hardware block provides
BASELINE_OPS = [
    "add", "sub", "neg", "abs",                     # adder/ALU
    "mul",                                          # multiplier
    "shl", "shr", "ashr",                           # shifter
    "min", "max", "lt", "lte", "gt", "gte", "eq", "neq",   # comparator
    "and", "or", "xor", "not", "sign",              # LUT
    "sel",                                          # data mux
]

_NONCOMM = {"sub", "shl", "shr", "ashr", "div", "lt", "lte", "gt", "gte"}


def baseline_datapath(ops_used: Optional[Set[str]] = None,
                      *, with_const_variants: bool = True) -> Datapath:
    """The general-purpose baseline PE, optionally restricted to `ops_used`
    (that restriction is the paper's PE 1)."""
    ops = [o for o in BASELINE_OPS if ops_used is None or o in ops_used]
    if ops_used is not None:
        # PE 1 must still run every op the app needs (special units etc.)
        for o in sorted(ops_used):
            if o not in ops and unit_of(o) in _PE_UNITS:
                ops.append(o)
    dp = Datapath()
    for op in ops:
        add_pattern(dp, single_op_pattern(op), f"op:{op}", validate=False)
        if with_const_variants and OPS[op].arity >= 2:
            add_pattern(dp, single_op_pattern(op, const_port=1),
                        f"op:{op}_c1", validate=False)
            if op in _NONCOMM:
                add_pattern(dp, single_op_pattern(op, const_port=0),
                            f"op:{op}_c0", validate=False)
    return dp


def merge_subgraphs(subgraphs: Sequence[Tuple[str, Graph]],
                    base: Optional[Datapath] = None,
                    *, validate: bool = True) -> Datapath:
    """Fold a list of (name, pattern) into one PE datapath."""
    dp = base.copy() if base is not None else Datapath()
    for name, g in subgraphs:
        add_pattern(dp, g, name, validate=validate)
    return dp
