"""Deterministic maze router over mesh channels with congestion rip-up.

PathFinder-style negotiated congestion, scoped to the small fabrics this
subsystem targets: each net is routed as a Steiner-ish tree (Dijkstra from
the growing tree to each sink, farthest sink first), channel overuse is
priced into edge costs, and overused iterations rip up only the offending
nets and reroute them with accumulated history penalties.  Everything is
ordered (sorted nets, sorted neighbor expansion, tie-broken heap) so a
given (netlist, placement, spec) always routes identically.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .arch import Coord, Edge, FabricSpec, manhattan
from .netlist import Netlist
from .place import Placement


@dataclass
class RoutedNet:
    name: str
    driver: Coord
    sinks: List[Coord]
    edges: List[Edge] = field(default_factory=list)     # tree edges, directed
    sink_hops: Dict[Coord, int] = field(default_factory=dict)

    @property
    def wirelength(self) -> int:
        return len(self.edges)

    @property
    def max_hops(self) -> int:
        return max(self.sink_hops.values(), default=0)


@dataclass
class RouteResult:
    nets: List[RoutedNet]
    wirelength: int
    overflow: int                     # sum of per-edge overuse after routing
    max_util: float                   # worst edge usage / capacity
    iterations: int
    edge_usage: Dict[Edge, int] = field(default_factory=dict)

    @property
    def success(self) -> bool:
        return self.overflow == 0

    @property
    def crit_path_hops(self) -> int:
        return max((n.max_hops for n in self.nets), default=0)


def _dijkstra_to_sink(sources: Set[Coord], sink: Coord,
                      caps: Dict[Edge, int], usage: Dict[Edge, int],
                      hist: Dict[Edge, float], spec: FabricSpec,
                      pres_fac: float) -> Optional[List[Edge]]:
    """Cheapest path from any source tile to `sink`; returns directed edges."""
    dist: Dict[Coord, float] = {s: 0.0 for s in sources}
    prev: Dict[Coord, Coord] = {}
    counter = 0
    heap: List[Tuple[float, int, Coord]] = []
    for s in sorted(sources):
        heapq.heappush(heap, (manhattan(s, sink) * 1.0, counter, s))
        counter += 1
    done: Set[Coord] = set()
    while heap:
        _, _, u = heapq.heappop(heap)
        if u in done:
            continue
        done.add(u)
        if u == sink:
            path: List[Edge] = []
            while u not in sources:
                path.append((prev[u], u))
                u = prev[u]
            path.reverse()
            return path
        du = dist[u]
        for v in sorted(spec.neighbors(u)):
            e = (u, v)
            over = usage.get(e, 0) + 1 - caps[e]
            cost = 1.0 + hist.get(e, 0.0) + (pres_fac * over if over > 0
                                             else 0.0)
            nd = du + cost
            if nd < dist.get(v, float("inf")):
                dist[v] = nd
                prev[v] = u
                heapq.heappush(heap, (nd + manhattan(v, sink), counter, v))
                counter += 1
    return None


def _route_one(name: str, driver: Coord, sinks: List[Coord],
               caps: Dict[Edge, int], usage: Dict[Edge, int],
               hist: Dict[Edge, float], spec: FabricSpec,
               pres_fac: float) -> RoutedNet:
    net = RoutedNet(name, driver, list(sinks))
    tree: Set[Coord] = {driver}
    hops: Dict[Coord, int] = {driver: 0}
    used: Set[Edge] = set()
    for sink in sorted(sinks, key=lambda s: (-manhattan(driver, s), s)):
        if sink in tree:
            net.sink_hops[sink] = hops[sink]
            continue
        path = _dijkstra_to_sink(tree, sink, caps, usage, hist, spec,
                                 pres_fac)
        if path is None:                      # grid is connected; defensive
            raise RuntimeError(f"net {name}: no route {driver} -> {sink}")
        base = path[0][0]
        h = hops.get(base, 0)
        for (a, b) in path:
            h += 1
            if (a, b) not in used:
                used.add((a, b))
                net.edges.append((a, b))
                usage[(a, b)] = usage.get((a, b), 0) + 1
            tree.add(b)
            hops[b] = min(hops.get(b, h), h)
        net.sink_hops[sink] = hops[sink]
    return net


def route_nets(netlist: Netlist, placement: Placement, spec: FabricSpec,
               *, max_iters: int = 8, pres_fac: float = 2.0,
               hist_inc: float = 1.0) -> RouteResult:
    """Route every net of `netlist` under `placement`."""
    caps = spec.routing_edges()
    usage: Dict[Edge, int] = {}
    hist: Dict[Edge, float] = {}
    coords = placement.coords

    work = []
    for n in sorted(netlist.nets, key=lambda n: n.name):
        driver = coords[n.driver]
        sinks = [coords[s] for s in n.sinks]
        work.append((n.name, driver, sinks))

    routed: Dict[str, RoutedNet] = {}
    iters = 0
    pending = list(work)
    pf = pres_fac
    for it in range(max_iters):
        iters = it + 1
        for name, driver, sinks in pending:
            routed[name] = _route_one(name, driver, sinks, caps, usage,
                                      hist, spec, pf)
        overused = {e for e, u in usage.items() if u > caps[e]}
        if not overused or it == max_iters - 1:
            break        # done, or out of iterations: keep usage honest
        # penalize, rip up offenders, retry
        for e in overused:
            hist[e] = hist.get(e, 0.0) + hist_inc
        pending = []
        for name, driver, sinks in work:
            net = routed[name]
            if any(e in overused for e in net.edges):
                for e in net.edges:
                    usage[e] -= 1
                pending.append((name, driver, sinks))
        if not pending:
            break
        pf *= 1.6

    nets = [routed[name] for name, _, _ in work]
    overflow = sum(max(0, u - caps[e]) for e, u in usage.items())
    max_util = max((u / caps[e] for e, u in usage.items()), default=0.0)
    return RouteResult(nets=nets,
                       wirelength=sum(n.wirelength for n in nets),
                       overflow=overflow, max_util=max_util,
                       iterations=iters,
                       edge_usage={e: u for e, u in usage.items() if u})
