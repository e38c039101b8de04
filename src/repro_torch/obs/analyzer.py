"""Post-PnR utilization / timing reports (the Kuree `analyzer.py` idiom).

Answers the "why does camera converge to II=17?" class of question from a
finished :class:`~repro_torch.fabric.PnRResult` (and, when available, its
:class:`~repro_torch.sim.schedule.ModuloSchedule`):

* **PE / IO / channel / latch utilization** — how full the array is and
  how hard the mesh works;
* **per-net route depth histogram** — the register distances the modulo
  scheduler has to absorb;
* **operand-skew table** — per dependence edge, when the operand arrives
  vs when the consumer fires; the hold window is
  ``arrival + 1 <= t_fire <= arrival + latch_depth*II``, so each edge
  implies a minimum II of ``ceil(wait / latch_depth)``.  Edges whose
  implied II equals the achieved II are the **skew-critical nets**: they
  are why the schedule could not close at a smaller II.

Pure-Python over existing result objects; imports nothing from torch and
nothing at module scope from the pipeline (no import cycles with
``repro_torch.obs``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["OperandSkew", "PnrReport", "analyze_pnr"]


@dataclass
class OperandSkew:
    """One scheduled dependence edge net -> consuming PE tile."""

    net: str
    src: Tuple[str, int]         # producing op ("pe", inst) | ("in", signal)
    dst: Tuple[str, int]         # consuming op
    tile: Tuple[int, int]        # consumer tile
    hops: int                    # register depth driver -> consumer tile
    arrival: int                 # cycle the operand lands at the tile
    fire: int                    # cycle the consumer fires
    wait: int                    # fire - arrival (>= 1)
    hold: int                    # latch_depth * II: max legal wait
    implied_ii: int              # ceil(wait / latch_depth)

    @property
    def slack(self) -> int:
        return self.hold - self.wait

    def row(self) -> str:
        return (f"{self.net:<12} {str(self.src):<12} -> {str(self.dst):<12}"
                f" hops={self.hops:<3d} arr={self.arrival:<4d}"
                f" fire={self.fire:<4d} wait={self.wait:<4d}"
                f" slack={self.slack:<4d} impliedII={self.implied_ii}")


@dataclass
class PnrReport:
    app: str
    rows: int
    cols: int
    # utilization
    n_pe_cells: int
    n_pe_tiles: int
    n_io_cells: int
    n_io_sites: int
    used_edges: int
    total_edges: int
    mean_channel_util: float
    max_channel_util: float
    overflow: int
    # routes
    route_depth_hist: Dict[int, int]
    # schedule-dependent (None without a schedule)
    ii: Optional[int] = None
    min_ii: Optional[int] = None
    latch_depth: Optional[int] = None
    mean_latch_util: Optional[float] = None
    max_latch_util: Optional[float] = None
    skews: List[OperandSkew] = field(default_factory=list)

    @property
    def pe_util(self) -> float:
        return self.n_pe_cells / max(1, self.n_pe_tiles)

    @property
    def io_util(self) -> float:
        return self.n_io_cells / max(1, self.n_io_sites)

    @property
    def skew_critical(self) -> List[OperandSkew]:
        """Edges whose implied II equals the achieved II — the nets that
        pin the schedule (empty when II is purely resource-bound and no
        edge individually requires it)."""
        if self.ii is None:
            return []
        return [s for s in self.skews if s.implied_ii >= self.ii]

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "app": self.app, "fabric": f"{self.cols}x{self.rows}",
            "pe_util": round(self.pe_util, 4),
            "io_util": round(self.io_util, 4),
            "used_edges": self.used_edges, "total_edges": self.total_edges,
            "mean_channel_util": round(self.mean_channel_util, 4),
            "max_channel_util": round(self.max_channel_util, 4),
            "overflow": self.overflow,
            "route_depth_hist": {str(k): v for k, v
                                 in sorted(self.route_depth_hist.items())},
        }
        if self.ii is not None:
            d.update({
                "ii": self.ii, "min_ii": self.min_ii,
                "latch_depth": self.latch_depth,
                "mean_latch_util": round(self.mean_latch_util or 0.0, 4),
                "max_latch_util": round(self.max_latch_util or 0.0, 4),
                "skew_critical": [s.net for s in self.skew_critical],
            })
        return d

    def render(self) -> str:
        out = [f"== post-pnr report: {self.app} "
               f"({self.cols}x{self.rows} fabric) =="]
        out.append(f"  PE tiles   {self.n_pe_cells}/{self.n_pe_tiles} "
                   f"({100 * self.pe_util:.1f}%)   "
                   f"IO sites {self.n_io_cells}/{self.n_io_sites} "
                   f"({100 * self.io_util:.1f}%)")
        out.append(f"  channels   {self.used_edges}/{self.total_edges} used, "
                   f"mean util {100 * self.mean_channel_util:.1f}%, "
                   f"max {100 * self.max_channel_util:.1f}%, "
                   f"overflow {self.overflow}")
        depth = ", ".join(f"{k}:{v}" for k, v
                          in sorted(self.route_depth_hist.items()))
        out.append(f"  route depth histogram (max hops per net)  {depth}")
        if self.ii is not None:
            out.append(f"  schedule   II={self.ii} (min {self.min_ii}), "
                       f"latch_depth={self.latch_depth}, "
                       f"latch util mean {100 * (self.mean_latch_util or 0):.1f}% "
                       f"max {100 * (self.max_latch_util or 0):.1f}%")
            crit = self.skew_critical
            out.append(f"  operand-skew table ({len(self.skews)} edges, "
                       f"{len(crit)} skew-critical):")
            shown = sorted(self.skews, key=lambda s: (-s.implied_ii,
                                                      -s.wait, s.net))
            for s in shown[:12]:
                mark = " <- skew-critical" if s.implied_ii >= self.ii else ""
                out.append(f"    {s.row()}{mark}")
            if len(shown) > 12:
                out.append(f"    ... {len(shown) - 12} more")
        return "\n".join(out)


def analyze_pnr(pnr, sched=None) -> PnrReport:
    """Build a :class:`PnrReport` from a PnRResult (+ ModuloSchedule)."""
    spec, netlist, routes = pnr.spec, pnr.netlist, pnr.routes
    caps = spec.routing_edges()
    used = {e: u for e, u in routes.edge_usage.items() if u}
    mean_util = (sum(u / caps[e] for e, u in used.items()) / len(used)
                 if used else 0.0)

    depth_hist: Dict[int, int] = {}
    for net in routes.nets:
        d = net.max_hops
        depth_hist[d] = depth_hist.get(d, 0) + 1

    report = PnrReport(
        app=netlist.app_name, rows=spec.rows, cols=spec.cols,
        n_pe_cells=len(netlist.pe_cells), n_pe_tiles=spec.n_pe_tiles,
        n_io_cells=len(netlist.io_cells), n_io_sites=spec.n_io_sites,
        used_edges=len(used), total_edges=len(caps),
        mean_channel_util=mean_util, max_channel_util=routes.max_util,
        overflow=routes.overflow, route_depth_hist=depth_hist)

    if sched is None:
        return report

    from ..sim.schedule import L_OUT

    coords = pnr.placement.coords
    inst_of_cell = {name: c.instance for name, c in netlist.cells.items()
                    if c.kind == "pe"}
    cell_kind = {name: c.kind for name, c in netlist.cells.items()}
    hold = sched.latch_depth * sched.ii
    skews: List[OperandSkew] = []
    for net in sorted(netlist.nets, key=lambda n: n.name):
        src = sched.net_src.get(net.name)
        nt = sched.net_timing.get(net.name)
        if src is None or nt is None:
            continue
        for sink in net.sinks:
            if cell_kind[sink] != "pe":
                continue                      # io_out capture, not an operand
            tile = coords[sink]
            hops = nt.depth[tile]
            arrival = sched.start[src] + L_OUT + hops
            dst = ("pe", inst_of_cell[sink])
            fire = sched.start[dst]
            wait = fire - arrival
            implied = max(1, -(-wait // sched.latch_depth))
            skews.append(OperandSkew(
                net=net.name, src=src, dst=dst, tile=tile, hops=hops,
                arrival=arrival, fire=fire, wait=wait, hold=hold,
                implied_ii=implied))

    report.ii = sched.ii
    report.min_ii = sched.min_ii
    report.latch_depth = sched.latch_depth
    report.skews = skews
    if skews:
        utils = [s.wait / s.hold for s in skews]
        report.mean_latch_util = sum(utils) / len(utils)
        report.max_latch_util = max(utils)
    else:
        report.mean_latch_util = report.max_latch_util = 0.0
    return report
