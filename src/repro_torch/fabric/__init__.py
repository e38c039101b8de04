"""Fabric place-and-route: map DSE variants onto an N x M CGRA array.

The paper's loop (mine -> merge -> map -> cost) stops at the single-PE
level; this subsystem models the array.  Given a
:class:`~repro_torch.core.mapper.Mapping` and a :class:`FabricSpec`, it
extracts the inter-tile netlist, places cells with simulated annealing on
the GPU (:mod:`.place`), routes every net over the mesh, and prices the
result at array level — exposing the tradeoff the per-tile model cannot
see: fewer, bigger PEs mean fewer tiles and shorter routes.

    from repro_torch.fabric import FabricSpec, place_and_route
    pnr = place_and_route(dp, mapping, app, FabricSpec(rows=8, cols=8))
    print(pnr.cost.row())

The hierarchical placer of the JAX package (``cluster.py``,
``place_hierarchical``) is not ported yet: ``pnr_mode="hierarchical"``
raises :class:`NotImplementedError`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core.mapper import Mapping
from ..core.pe import Datapath
from ..graphir.graph import Graph
from .arch import FabricSpec, manhattan
from .cost import FabricCost, attach_fabric, evaluate_fabric
from .netlist import Cell, Net, Netlist, extract_netlist, synthetic_netlist
from .options import FabricOptions
from .place import Placement, PlacementProblem, anneal_jax, \
    anneal_jax_batch, anneal_python, batch_signature, lower, net_incidence, \
    place
from .route import RouteResult, RoutedNet, route_nets

__all__ = [
    "FabricSpec", "FabricOptions", "manhattan", "Cell", "Net", "Netlist",
    "extract_netlist", "synthetic_netlist", "Placement", "PlacementProblem",
    "lower", "net_incidence", "place", "anneal_jax",
    "anneal_jax_batch", "anneal_python", "batch_signature",
    "RouteResult", "RoutedNet", "route_nets",
    "FabricCost", "evaluate_fabric", "attach_fabric", "PnRResult",
    "place_and_route", "HIERARCHICAL_NOT_PORTED",
]

HIERARCHICAL_NOT_PORTED = (
    "pnr_mode='hierarchical' is not ported yet (ROADMAP.md, 'Hierarchical "
    "placement': cluster.py, place_hierarchical and the fixed-box kernels)")


@dataclass
class PnRResult:
    spec: FabricSpec
    netlist: Netlist
    placement: Placement
    routes: RouteResult
    cost: FabricCost


def place_and_route(dp: Datapath, mapping: Mapping, app: Graph,
                    spec: Optional[FabricSpec] = None, *,
                    backend: str = "jax", chains: int = 16,
                    sweeps: int = 32, seed: int = 0,
                    auto_size: bool = True, pe_name: str = "PE",
                    hpwl_backend: str = "jnp",
                    score_mode: str = "delta",
                    max_states: Optional[int] = None,
                    pnr_mode: str = "flat", device="cuda") -> PnRResult:
    """Full flow: netlist -> place -> route -> array-level cost.

    The placement anneals on ``device`` (``"cuda"`` by default; pass
    ``"cpu"`` for the kernels' plain PyTorch versions).
    """
    if pnr_mode == "hierarchical":
        raise NotImplementedError(HIERARCHICAL_NOT_PORTED)
    if pnr_mode != "flat":
        raise ValueError(f"unknown pnr_mode {pnr_mode!r}")
    spec = spec or FabricSpec()
    netlist = extract_netlist(mapping, app, spec)
    if auto_size:
        spec = spec.fit(len(netlist.pe_cells), len(netlist.io_cells))
    placement = place(netlist, spec, backend=backend, chains=chains,
                      sweeps=sweeps, seed=seed, hpwl_backend=hpwl_backend,
                      score_mode=score_mode, max_states=max_states,
                      device=device)
    routes = route_nets(netlist, placement, spec)
    fc = evaluate_fabric(dp, mapping, netlist, placement, routes, spec,
                         pe_name=pe_name)
    return PnRResult(spec, netlist, placement, routes, fc)
