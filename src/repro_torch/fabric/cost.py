"""Array-level area / energy / timing from a placed-and-routed mapping.

The per-tile model in :mod:`repro_torch.core.costmodel` charges every PE a flat
connection-box/switch-box share; after place-and-route we know the actual
interconnect activity, so the fabric cost prices:

* **hop energy** — every routed channel segment toggles wire + switch
  capacitance (``spec.hop_energy_pj`` per word per hop), plus the CB at each
  sink and SB at each driver (the costmodel constants);
* **I/O energy** — each signal entering/leaving the array pays a memory-tile
  access;
* **area** — the full manufactured array (all PE tiles at CGRA-level area)
  plus one memory-interface tile per used I/O cell;
* **timing** — cycle time is the PE stage delay plus the longest
  source-to-sink route (unregistered mesh hops).

:func:`attach_fabric` writes the array-accurate numbers back onto the
:class:`~repro_torch.core.costmodel.AppCost` record so DSE tables can show both
views side by side.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core.costmodel import (AppCost, CB_ENERGY_PJ, MEM_TILE_AREA_UM2,
                              MEM_TILE_ENERGY_PJ, SB_ENERGY_PJ)
from ..core.mapper import Mapping
from ..core.pe import Datapath
from .arch import FabricSpec
from .netlist import Netlist
from .place import Placement
from .route import RouteResult


@dataclass
class FabricCost:
    app: str
    pe_name: str
    rows: int
    cols: int
    n_pe_cells: int
    n_io_cells: int
    utilization: float              # PE cells / PE tiles
    hpwl: float                     # placement objective of the chosen chain
    wirelength_hops: int
    max_channel_util: float
    overflow: int
    crit_path_hops: int
    fmax_ghz: float
    pe_energy_pj: float
    route_energy_pj: float
    io_energy_pj: float
    total_energy_pj: float
    energy_per_op_pj: float
    fabric_area_um2: float

    def row(self) -> str:
        return (f"{self.app:<16} {self.pe_name:<10} "
                f"grid={self.cols}x{self.rows} "
                f"util={self.utilization:4.2f} wl={self.wirelength_hops:<5d} "
                f"chan={self.max_channel_util:4.2f} "
                f"crit={self.crit_path_hops:<3d} "
                f"fmax={self.fmax_ghz:4.2f}GHz "
                f"e/op={self.energy_per_op_pj:7.4f}pJ "
                f"area={self.fabric_area_um2/1e3:8.1f}kum2")


def evaluate_fabric(dp: Datapath, mapping: Mapping, netlist: Netlist,
                    placement: Placement, routes: RouteResult,
                    spec: FabricSpec, *, pe_name: str = "PE",
                    idle_fraction: float = 0.55) -> FabricCost:
    pe_energy = sum(
        dp.config_energy_pj(dp.configs[inst.config],
                            idle_fraction=idle_fraction)
        for inst in mapping.instances)

    hop_e = routes.wirelength * spec.hop_energy_pj
    endpoint_e = sum(SB_ENERGY_PJ + CB_ENERGY_PJ * len(n.sinks)
                     for n in routes.nets)
    route_energy = hop_e + endpoint_e

    io_signals = sum(len(c.signals) for c in netlist.io_cells)
    io_energy = MEM_TILE_ENERGY_PJ * io_signals

    n_io_used = len(netlist.io_cells)
    area = (dp.area_um2(include_io=True) * spec.n_pe_tiles
            + MEM_TILE_AREA_UM2 * n_io_used)

    crit = routes.crit_path_hops
    t_clk = dp.stage_delay_ns() + crit * spec.hop_delay_ns
    fmax = 1.0 / max(t_clk, 1e-3)

    total = pe_energy + route_energy + io_energy
    total_ops = max(1, mapping.total_ops)
    return FabricCost(
        app=mapping.app_name, pe_name=pe_name,
        rows=spec.rows, cols=spec.cols,
        n_pe_cells=len(netlist.pe_cells), n_io_cells=n_io_used,
        utilization=len(netlist.pe_cells) / spec.n_pe_tiles,
        hpwl=placement.cost,
        wirelength_hops=routes.wirelength,
        max_channel_util=routes.max_util,
        overflow=routes.overflow,
        crit_path_hops=crit,
        fmax_ghz=fmax,
        pe_energy_pj=pe_energy,
        route_energy_pj=route_energy,
        io_energy_pj=io_energy,
        total_energy_pj=total,
        energy_per_op_pj=total / total_ops,
        fabric_area_um2=area)


def attach_fabric(cost: AppCost, fc: FabricCost) -> AppCost:
    """Write array-accurate numbers onto the per-tile AppCost record."""
    cost.fabric_area_um2 = fc.fabric_area_um2
    cost.fabric_energy_per_op_pj = fc.energy_per_op_pj
    cost.fabric_fmax_ghz = fc.fmax_ghz
    cost.fabric_wirelength = fc.wirelength_hops
    cost.fabric_utilization = fc.utilization
    return cost
