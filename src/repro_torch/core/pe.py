"""PE specification — the PEak-DSL analogue (paper Sec. IV step 4/5).

A :class:`Datapath` is a merged, configurable PE architecture:

* **units** — hardware blocks (adder, multiplier, shifter, comparator, LUT,
  special, const register), each able to execute a set of ops;
* **alts** — per (unit, port) the list of alternative sources (another unit,
  or an external PE input line); >1 alternative implies a config mux
  (paper Fig. 5e);
* **out_alts** — PE output lines, each with its own output mux;
* **configs** — one per supported operation pattern ("rewrite rules" in the
  paper): which units are active, which op each performs, mux selections,
  external-input bindings and constant-register values.

Every config's source pattern is stored, so the application mapper can match
patterns in the app graph and the validator can check that the datapath,
*driven purely through its muxes*, computes exactly what the source subgraph
computes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..graphir.graph import Graph, free_in_ports, sink_nodes
from ..graphir.interp import SEMANTICS
from ..graphir.ops import (OPS, UNIT_AREA, UNIT_ENERGY, U_CONST, U_MUX,
                           unit_of)

# source alternatives
Src = Tuple[str, int]          # ("n", unit_id) or ("ext", input_line)


@dataclass
class Unit:
    uid: int
    unit: str                  # hardware block type
    ops: Set[str] = field(default_factory=set)

    @property
    def is_const(self) -> bool:
        return self.unit == U_CONST

    @property
    def arity(self) -> int:
        return max((OPS[o].arity for o in self.ops), default=0)


@dataclass
class Config:
    """One supported operation pattern of the PE."""

    name: str
    pattern: Graph                                  # source subgraph
    node_map: Dict[int, int]                        # pattern node -> unit id
    op_assign: Dict[int, str]                       # unit id -> op it performs
    sel: Dict[Tuple[int, int], int]                 # (unit, port) -> alt index
    ext_bind: Dict[Tuple[int, int], int]            # pattern free port -> ext line
    const_vals: Dict[int, Any]                      # const unit -> value
    out_sel: List[Tuple[int, int]]                  # [(line, alt index)] per sink
    active_units: Set[int] = field(default_factory=set)

    @property
    def n_ops(self) -> int:
        """Compute ops executed per invocation (consts excluded)."""
        return sum(1 for n, op in self.pattern.nodes.items()
                   if op not in ("const", "input", "output"))

    @property
    def n_inputs(self) -> int:
        return len(set(self.ext_bind.values()))


@dataclass
class Datapath:
    """A configurable PE architecture."""

    units: Dict[int, Unit] = field(default_factory=dict)
    alts: Dict[Tuple[int, int], List[Src]] = field(default_factory=dict)
    out_alts: List[List[Src]] = field(default_factory=list)
    configs: Dict[str, Config] = field(default_factory=dict)
    n_ext: int = 0
    _next_uid: int = 0

    # -- construction -------------------------------------------------------
    def new_unit(self, unit: str, ops: Set[str]) -> int:
        uid = self._next_uid
        self._next_uid += 1
        self.units[uid] = Unit(uid, unit, set(ops))
        return uid

    def add_alt(self, uid: int, port: int, src: Src) -> int:
        lst = self.alts.setdefault((uid, port), [])
        if src in lst:
            return lst.index(src)
        lst.append(src)
        if src[0] == "ext":
            self.n_ext = max(self.n_ext, src[1] + 1)
        return len(lst) - 1

    def add_out_alt(self, line: int, src: Src) -> int:
        while len(self.out_alts) <= line:
            self.out_alts.append([])
        lst = self.out_alts[line]
        if src in lst:
            return lst.index(src)
        lst.append(src)
        return len(lst) - 1

    def copy(self) -> "Datapath":
        dp = Datapath()
        dp.units = {u.uid: Unit(u.uid, u.unit, set(u.ops))
                    for u in self.units.values()}
        dp.alts = {k: list(v) for k, v in self.alts.items()}
        dp.out_alts = [list(v) for v in self.out_alts]
        dp.configs = dict(self.configs)   # configs are immutable once built
        dp.n_ext = self.n_ext
        dp._next_uid = self._next_uid
        return dp

    # -- structure metrics ------------------------------------------------------
    def mux_ways(self) -> List[int]:
        """Fan-in of every mux (input and output muxes with >=2 alternatives)."""
        ways = [len(v) for v in self.alts.values() if len(v) >= 2]
        ways += [len(v) for v in self.out_alts if len(v) >= 2]
        return ways

    @property
    def n_out(self) -> int:
        return max(1, len(self.out_alts))

    def area_um2(self, *, include_io: bool = False,
                 cb_area: float = 520.0, sb_area: float = 960.0) -> float:
        """PE core area; optionally add connection/switch-box overhead."""
        a = sum(UNIT_AREA[u.unit] for u in self.units.values())
        a += sum((w - 1) * UNIT_AREA[U_MUX] for w in self.mux_ways())
        # config storage: ~1 flop-equivalent per mux selection bit
        sel_bits = sum(max(1, int(np.ceil(np.log2(max(w, 2)))))
                       for w in self.mux_ways())
        a += 2.1 * sel_bits
        if include_io:
            a += cb_area * max(2, self.n_ext) + sb_area * self.n_out
        return a

    def config_energy_pj(self, cfg: Config, *, idle_fraction: float = 0.55,
                         reg_pj: float = 0.09, clock_pj: float = 0.18
                         ) -> float:
        """Energy of one PE invocation under `cfg`.

        Active units dissipate their full op energy.  Inactive units are NOT
        operand-isolated in a Garnet-class baseline PE, so input toggles
        glitch through them every cycle: they burn `idle_fraction` of their
        op energy (the paper's own Harris observation — "an architecture
        that reduces activity on an input to a multiplier" — is this effect).
        Every mux costs mux energy; each invocation additionally clocks its
        input/output registers and the clock/config tree (`reg_pj` per
        active 16-bit register, `clock_pj` fixed).  Fusing more ops per
        invocation amortizes all of this — the mechanism behind Fig. 8.
        """
        e = 0.0
        for uid, u in self.units.items():
            if uid in cfg.active_units:
                op = cfg.op_assign.get(uid)
                e += OPS[op].energy_pj if op else UNIT_ENERGY[u.unit]
            else:
                e += idle_fraction * UNIT_ENERGY[u.unit]
        n_mux = len(self.mux_ways())
        e += n_mux * UNIT_ENERGY[U_MUX]
        e += reg_pj * (cfg.n_inputs + len(cfg.out_sel)) + clock_pj
        return e

    def idle_cycle_energy_pj(self, *, fraction: float = 0.15,
                             clock_pj: float = 0.18) -> float:
        """Energy a tile burns per cycle it does NOT fire.

        Between invocations the input latches hold, so datapath glitching
        is far below the active-invocation idle_fraction — what remains is
        the clock/config tree plus residual toggling (`fraction` of each
        unit's op energy).  Used by the time-domain cost feedback: a design
        running at II charges every tile II-1 of these per iteration.
        """
        return (fraction * sum(UNIT_ENERGY[u.unit]
                               for u in self.units.values()) + clock_pj)

    def critical_path_ns(self) -> float:
        """Longest combinational path through the datapath (any config)."""
        delay = {
            "adder": 0.15, "multiplier": 0.45, "mac": 0.55, "shifter": 0.12,
            "comparator": 0.10, "lut": 0.05, "mux": 0.02, "const_reg": 0.0,
            "divider": 1.10, "special": 0.85, "reduce": 0.0, "matmul": 0.0,
            "io": 0.0,
        }
        memo: Dict[int, float] = {}

        def arrival(uid: int, stack: Set[int]) -> float:
            if uid in memo:
                return memo[uid]
            if uid in stack:          # structural cycle across configs: cut
                return 0.0
            stack = stack | {uid}
            u = self.units[uid]
            t_in = 0.0
            for port in range(u.arity):
                lst = self.alts.get((uid, port), [])
                mux_d = delay["mux"] * max(0, int(np.ceil(
                    np.log2(max(len(lst), 2)))) if len(lst) >= 2 else 0)
                for src in lst:
                    if src[0] == "n":
                        t_in = max(t_in, arrival(src[1], stack) + mux_d)
                    else:
                        t_in = max(t_in, mux_d)
            memo[uid] = t_in + delay[u.unit]
            return memo[uid]

        t = 0.0
        for line in (self.out_alts or [[]]):
            mux_d = delay["mux"] * (1 if len(line) >= 2 else 0)
            for src in line:
                if src[0] == "n":
                    t = max(t, arrival(src[1], set()) + mux_d)
        for uid in self.units:
            t = max(t, arrival(uid, set()))
        return t + 0.08   # input/output register + clk overhead

    def stage_delay_ns(self) -> float:
        """Pipelined-PE cycle time: slowest unit + its input-mux tree + reg.

        CGRA PEs register unit outputs; the paper's specialized PEs reach
        *higher* fmax than the baseline (Sec. V-A) because each pipeline
        stage is a lean single unit, while the baseline pays a multi-function
        ALU decode.  Baseline decode overhead is modeled via config count.
        """
        delay = {
            "adder": 0.15, "multiplier": 0.45, "mac": 0.55, "shifter": 0.12,
            "comparator": 0.10, "lut": 0.05, "mux": 0.02, "const_reg": 0.0,
            "divider": 1.10, "special": 0.85, "reduce": 0.0, "matmul": 0.0,
            "io": 0.0,
        }
        worst = 0.0
        for uid, u in self.units.items():
            mux_depth = 0.0
            for port in range(u.arity):
                lst = self.alts.get((uid, port), [])
                if len(lst) >= 2:
                    mux_depth = max(mux_depth, float(np.ceil(
                        np.log2(len(lst)))))
            # multi-op units pay an opcode-decode stage proportional to the
            # number of ops they can perform
            decode = 0.015 * max(0, len(u.ops) - 1)
            worst = max(worst, delay[u.unit] + 0.02 * mux_depth + decode)
        return worst + 0.08

    def fmax_ghz(self, *, pipelined: bool = True) -> float:
        t = self.stage_delay_ns() if pipelined else self.critical_path_ns()
        return 1.0 / max(t, 1e-3)

    # -- execution (validation oracle for merged wiring) -----------------------
    def execute(self, cfg: Config, ext_values: Dict[int, Any],
                const_override: Optional[Dict[int, Any]] = None) -> List[Any]:
        """Run one invocation through the datapath muxes.

        ext_values: ext line -> value.  Returns per-sink outputs in
        cfg.out_sel order.  This deliberately does NOT consult cfg.pattern
        for structure — only mux selections — so it validates the wiring.
        """
        memo: Dict[int, Any] = {}

        def value(uid: int) -> Any:
            if uid in memo:
                return memo[uid]
            u = self.units[uid]
            if u.is_const:
                if const_override and uid in const_override:
                    memo[uid] = const_override[uid]
                else:
                    memo[uid] = cfg.const_vals[uid]
                return memo[uid]
            op = cfg.op_assign[uid]
            args = []
            for port in range(OPS[op].arity):
                lst = self.alts[(uid, port)]
                src = lst[cfg.sel[(uid, port)]]
                if src[0] == "n":
                    args.append(value(src[1]))
                else:
                    args.append(ext_values[src[1]])
            memo[uid] = SEMANTICS[op](*args)
            return memo[uid]

        outs = []
        for (line, alt) in cfg.out_sel:
            src = self.out_alts[line][alt]
            assert src[0] == "n"
            outs.append(value(src[1]))
        return outs

    def render_graph(self) -> Graph:
        """Visualization-only Graph with explicit cmux nodes."""
        g = Graph()
        ids: Dict[int, int] = {}
        for uid, u in sorted(self.units.items()):
            rep = sorted(u.ops)[0] if u.ops else "const"
            ids[uid] = g.add_node(rep if rep in OPS else "opaque",
                                  ops=sorted(u.ops), unit=u.unit)
        ext_ids = {k: g.add_node("input", name=f"ext{k}")
                   for k in range(self.n_ext)}

        def src_node(src: Src) -> int:
            return ids[src[1]] if src[0] == "n" else ext_ids[src[1]]

        for (uid, port), lst in sorted(self.alts.items()):
            if len(lst) == 1:
                g.add_edge(src_node(lst[0]), ids[uid], port)
            else:
                m = g.add_node("cmux", ways=len(lst))
                for i, src in enumerate(lst):
                    g.add_edge(src_node(src), m, i)
                g.add_edge(m, ids[uid], port)
        for line, lst in enumerate(self.out_alts):
            out = g.add_node("output", name=f"out{line}")
            if len(lst) == 1:
                g.add_edge(src_node(lst[0]), out, 0)
            elif lst:
                m = g.add_node("cmux", ways=len(lst))
                for i, src in enumerate(lst):
                    g.add_edge(src_node(src), m, i)
                g.add_edge(m, out, 0)
        return g

    def summary(self) -> str:
        unit_str = ", ".join(
            f"{u.unit}{{{'/'.join(sorted(u.ops))}}}" for u in
            sorted(self.units.values(), key=lambda x: x.uid))
        return (f"Datapath[{len(self.units)} units | {len(self.configs)} cfgs"
                f" | in={self.n_ext} out={self.n_out}"
                f" | area={self.area_um2():.0f}um2"
                f" | fmax={self.fmax_ghz():.2f}GHz] {unit_str}")


def single_op_pattern(op: str, const_port: Optional[int] = None) -> Graph:
    """1-op pattern; optionally with port `const_port` fed by a const reg."""
    g = Graph()
    n = g.add_node(op)
    if const_port is not None:
        c = g.add_node("const", value=0.0)
        g.add_edge(c, n, const_port)
    return g
