"""Area / energy / performance evaluation (paper Sec. IV steps 7-8, Sec. V).

The paper synthesizes in TSMC 16 nm and reports PE-core energy per op and
total active-PE-core area (Fig. 8/10/11) plus a CGRA-level comparison with a
Simba-class ASIC (Table I).  We evaluate the same quantities analytically
from the unit tables in graphir.ops:

* PE core area — sum of unit areas + mux trees + config bits.
* Energy per invocation — active units at full op energy, idle units at an
  idle fraction (clock/glitch toggling), plus mux energy.
* Energy per op — total mapped energy / total application compute ops; a
  specialized PE executes more ops per invocation, amortizing overheads.
* Total area — PE core area x number of PEs used (CGRAs are spatial; each
  invocation occupies a tile), exactly Fig. 8's metric.
* fmax — longest combinational unit+mux path (critical path model).
* CGRA level — adds connection-box/switch-box interconnect overhead per PE
  I/O (Sec. II-C) and memory-tile cost for Table I.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..graphir.graph import Graph
from .mapper import Mapping
from .pe import Datapath

# CGRA-level constants (16 nm-class, per tile)
CB_AREA_UM2 = 520.0        # connection box per PE input (10-track, 16-bit)
SB_AREA_UM2 = 960.0        # switch box per PE output
CB_ENERGY_PJ = 0.045       # per word routed through a CB
SB_ENERGY_PJ = 0.060       # per word routed through an SB
MEM_TILE_AREA_UM2 = 9800.0
MEM_TILE_ENERGY_PJ = 1.9   # per access (512 x 16b SRAM bank + control)
PE_PER_MEM = 4.0           # tile ratio on the array (paper Fig. 7 layout)


@dataclass
class AppCost:
    app: str
    pe_name: str
    n_pes: int
    total_ops: int
    pe_area_um2: float
    total_area_um2: float          # PE core area x n_pes (paper Fig. 8)
    energy_pj: float               # PE cores only
    energy_per_op_pj: float
    fmax_ghz: float
    ops_per_pe: float
    unmapped: int
    # CGRA level (Table I)
    cgra_area_um2: float = 0.0
    cgra_energy_pj: float = 0.0
    cgra_energy_per_op_pj: float = 0.0
    # array level, filled by repro_torch.fabric after place-and-route (0 = not run)
    fabric_area_um2: float = 0.0
    fabric_energy_per_op_pj: float = 0.0
    fabric_fmax_ghz: float = 0.0
    fabric_wirelength: int = 0
    fabric_utilization: float = 0.0
    # time domain, filled by repro_torch.sim after modulo scheduling + simulation
    # (0 = not run).  These are *measured* on the scheduled array, not
    # estimated: achieved initiation interval, the schedule's lower bound,
    # pipeline fill latency, per-tile activity, sustained throughput at the
    # fabric clock, and energy/op including the idle cycles each tile burns
    # between fires — the number the static model cannot see.
    sim_ii: int = 0
    sim_min_ii: int = 0
    sim_latency_cycles: int = 0
    sim_active_frac: float = 0.0
    sim_throughput_gops: float = 0.0
    sim_energy_per_op_pj: float = 0.0
    sim_verified: int = -1         # 1 bit-exact vs interp, 0 mismatch, -1 n/a

    def row(self) -> str:
        return (f"{self.app:<16} {self.pe_name:<10} pes={self.n_pes:<5d} "
                f"ops={self.total_ops:<6d} e/op={self.energy_per_op_pj:7.4f}pJ "
                f"area={self.total_area_um2/1e3:8.1f}kum2 "
                f"fmax={self.fmax_ghz:4.2f}GHz opspe={self.ops_per_pe:4.2f}")


def evaluate_mapping(dp: Datapath, mapping: Mapping, pe_name: str = "PE",
                     *, idle_fraction: float = 0.55) -> AppCost:
    pe_area = dp.area_um2()
    energy = 0.0
    for inst in mapping.instances:
        cfg = dp.configs[inst.config]
        energy += dp.config_energy_pj(cfg, idle_fraction=idle_fraction)
    total_ops = mapping.total_ops
    n_pes = mapping.n_pes

    # CGRA level: every PE instance carries its CB/SB share; words routed =
    # one per PE input + output; memory tiles amortized over the array.
    cgra_pe_area = dp.area_um2(include_io=True,
                               cb_area=CB_AREA_UM2, sb_area=SB_AREA_UM2)
    n_mem = max(1.0, n_pes / PE_PER_MEM)
    cgra_area = cgra_pe_area * n_pes + MEM_TILE_AREA_UM2 * n_mem
    route_energy = 0.0
    for inst in mapping.instances:
        cfg = dp.configs[inst.config]
        route_energy += CB_ENERGY_PJ * max(1, cfg.n_inputs) + SB_ENERGY_PJ
    mem_energy = MEM_TILE_ENERGY_PJ * 2.0 * n_mem   # rd + wr per output
    cgra_energy = energy + route_energy + mem_energy

    return AppCost(
        app=mapping.app_name,
        pe_name=pe_name,
        n_pes=n_pes,
        total_ops=total_ops,
        pe_area_um2=pe_area,
        total_area_um2=pe_area * n_pes,
        energy_pj=energy,
        energy_per_op_pj=energy / max(1, total_ops),
        fmax_ghz=dp.fmax_ghz(),
        ops_per_pe=mapping.ops_per_pe,
        unmapped=len(mapping.unmapped),
        cgra_area_um2=cgra_area,
        cgra_energy_pj=cgra_energy,
        cgra_energy_per_op_pj=cgra_energy / max(1, total_ops),
    )


def attach_sim(cost: AppCost, dp: Datapath, schedule,
               *, fabric_cost=None, verified: int = -1) -> AppCost:
    """Write measured time-domain numbers onto an AppCost record.

    schedule: a :class:`repro_torch.sim.schedule.ModuloSchedule`.  Throughput is
    the steady state — ``total_ops`` useful ops retire every II cycles at
    the fabric clock.  Energy/op re-prices the array per *iteration*: every
    invocation at its config energy (as before) plus ``II - 1`` idle cycles
    per tile at the idle-cycle energy, all divided by the ops of one
    iteration.  A schedule with slack (II above the resource bound) now
    shows up as worse energy/op, which the cycle-free model never could.
    """
    cost.sim_ii = schedule.ii
    cost.sim_min_ii = schedule.min_ii
    cost.sim_latency_cycles = schedule.latency
    cost.sim_active_frac = 1.0 / schedule.ii
    fmax = (fabric_cost.fmax_ghz if fabric_cost is not None
            else cost.fabric_fmax_ghz) or cost.fmax_ghz
    total_ops = max(1, cost.total_ops)
    cost.sim_throughput_gops = total_ops * fmax / schedule.ii
    base = (fabric_cost.total_energy_pj if fabric_cost is not None
            else cost.cgra_energy_pj)
    idle = (schedule.ii - 1) * cost.n_pes * dp.idle_cycle_energy_pj()
    cost.sim_energy_per_op_pj = (base + idle) / total_ops
    cost.sim_verified = verified
    return cost


def vector_mac_asic_energy_per_op_pj(n_lanes: int = 8) -> float:
    """Simba-class bound: n_lanes 8-bit vector MACs sharing one control path.

    Per-MAC energy at 8-bit is ~1/4 of the 16-bit MAC (quadratic multiplier
    scaling); control/SRAM overhead is amortized over the vector width.
    A MAC is 2 ops (mul + add).
    """
    from ..graphir.ops import UNIT_ENERGY, U_MAC
    mac8 = UNIT_ENERGY[U_MAC] / 4.0
    control = 0.18 / n_lanes          # sequencer + operand fetch, amortized
    sram = MEM_TILE_ENERGY_PJ / (4.0 * n_lanes)
    return (mac8 + control + sram) / 2.0
