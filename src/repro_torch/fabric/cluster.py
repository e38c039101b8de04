"""Connectivity-aware netlist partitioning for hierarchical placement.

The two-level placer (:func:`repro_torch.fabric.place.place_hierarchical`)
needs the PE cells of a mega-fabric netlist divided into clusters that
(a) each fit one region of the cluster grid and (b) keep tightly
connected cells together, so most nets become cluster-internal and the
cheap cluster-local anneals capture most of the wirelength.  This module
provides the cgra_pnr-style front half of that recipe: a greedy seeded
growth pass followed by a Kernighan–Lin-flavoured boundary refinement.

Algorithm (deterministic — no RNG, ties break on cell index):

1. **Clique-model weights.** Every net contributes ``1 / (pins - 1)``
   to each pair of its PE pins, the standard clique approximation of
   multi-pin nets.
2. **Seeded growth.** ``n_clusters`` seeds are spread evenly over the
   cell index range; clusters then take turns (round-robin, so sizes
   stay balanced) absorbing the unassigned cell with the highest total
   weight into the cluster (a lazy max-heap per cluster).  A cluster at
   its ``cap`` stops; a cluster with an empty frontier takes the
   lowest-index unassigned cell so every cell lands somewhere.
3. **Boundary refinement.** A few passes over all cells in index order:
   a cell moves to the neighbouring cluster it is more strongly
   connected to, if that cluster has room — the KL move step without
   the paired swap (caps make pairing unnecessary).

Every cell lands in exactly one cluster and no cluster exceeds ``cap``,
by construction — property-tested in ``tests/test_hier_place.py``.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .netlist import Netlist

__all__ = ["Clustering", "partition"]


@dataclass
class Clustering:
    """A partition of a netlist's PE cells into capacity-bounded clusters.

    ``clusters[k]`` lists cell names in instance order;  ``cluster_of``
    is the inverse map.  ``cut_nets`` counts nets whose PE pins span more
    than one cluster (the coarse-level objective), ``internal_nets``
    those fully inside one.
    """

    n_clusters: int
    cap: int
    cluster_of: Dict[str, int] = field(default_factory=dict)
    clusters: List[List[str]] = field(default_factory=list)
    cut_nets: int = 0
    internal_nets: int = 0

    def summary(self) -> str:
        sizes = [len(c) for c in self.clusters]
        return (f"Clustering[{self.n_clusters} clusters cap={self.cap} "
                f"sizes={min(sizes)}..{max(sizes)} "
                f"cut={self.cut_nets}/{self.cut_nets + self.internal_nets}]")


def _pe_adjacency(netlist: Netlist, index_of: Dict[str, int]
                  ) -> List[Dict[int, float]]:
    """Clique-model weighted adjacency over PE cells (IO pins dropped)."""
    adj: List[Dict[int, float]] = [{} for _ in index_of]
    for net in netlist.nets:
        pins = sorted({index_of[c] for c in [net.driver] + net.sinks
                       if c in index_of})
        if len(pins) < 2:
            continue
        w = 1.0 / (len(pins) - 1)
        for i, a in enumerate(pins):
            for b in pins[i + 1:]:
                adj[a][b] = adj[a].get(b, 0.0) + w
                adj[b][a] = adj[b].get(a, 0.0) + w
    return adj


def partition(netlist: Netlist, n_clusters: int, cap: int, *,
              refine_passes: int = 2) -> Clustering:
    """Partition the netlist's PE cells into ``n_clusters`` clusters of at
    most ``cap`` cells each.  Deterministic; raises when the cells cannot
    fit (``n_cells > n_clusters * cap``)."""
    cells = sorted(netlist.pe_cells, key=lambda c: c.instance)
    names = [c.name for c in cells]
    n = len(names)
    if n_clusters < 1:
        raise ValueError(f"n_clusters must be >= 1, got {n_clusters}")
    if n > n_clusters * cap:
        raise ValueError(f"{n} PE cells cannot fit {n_clusters} clusters "
                         f"of cap {cap}")
    index_of = {name: i for i, name in enumerate(names)}
    adj = _pe_adjacency(netlist, index_of)

    assign = [-1] * n
    sizes = [0] * n_clusters
    # per-cluster lazy max-heap of (-gain, cell); gain[] holds the current
    # connectivity of each unassigned cell to each cluster
    heaps: List[List[Tuple[float, int]]] = [[] for _ in range(n_clusters)]
    gain = [[0.0] * n_clusters for _ in range(n)] if n else []

    def absorb(k: int, cell: int) -> None:
        assign[cell] = k
        sizes[k] += 1
        for nb, w in adj[cell].items():
            if assign[nb] == -1:
                gain[nb][k] += w
                heapq.heappush(heaps[k], (-gain[nb][k], nb))

    # seeds spread evenly over the instance order (with locality-structured
    # netlists, instance order correlates with position)
    taken = set()
    for k in range(min(n_clusters, n)):
        s = (k * n) // n_clusters
        while s in taken:
            s = (s + 1) % n
        taken.add(s)
        absorb(k, s)

    unassigned = n - len(taken)
    next_free = 0                      # lowest maybe-unassigned index
    while unassigned:
        progressed = False
        for k in range(n_clusters):
            if not unassigned or sizes[k] >= cap:
                continue
            cell = -1
            while heaps[k]:
                neg, c = heapq.heappop(heaps[k])
                if assign[c] == -1 and -neg == gain[c][k]:
                    cell = c
                    break
            if cell == -1:             # empty frontier: take lowest index
                while next_free < n and assign[next_free] != -1:
                    next_free += 1
                if next_free >= n:
                    continue
                cell = next_free
            absorb(k, cell)
            unassigned -= 1
            progressed = True
        if not progressed:             # all non-full clusters starved
            raise AssertionError("partition growth stalled")  # unreachable

    # -- KL-style boundary refinement -----------------------------------
    for _ in range(max(0, refine_passes)):
        moved = 0
        for cell in range(n):
            src = assign[cell]
            if sizes[src] <= 1:
                continue
            pull: Dict[int, float] = {}
            for nb, w in adj[cell].items():
                pull[assign[nb]] = pull.get(assign[nb], 0.0) + w
            here = pull.get(src, 0.0)
            best_k, best_w = src, here
            for k in sorted(pull):
                if k != src and sizes[k] < cap and pull[k] > best_w:
                    best_k, best_w = k, pull[k]
            if best_k != src:
                sizes[src] -= 1
                sizes[best_k] += 1
                assign[cell] = best_k
                moved += 1
        if not moved:
            break

    clusters: List[List[str]] = [[] for _ in range(n_clusters)]
    cluster_of: Dict[str, int] = {}
    for i, name in enumerate(names):   # instance order within each cluster
        clusters[assign[i]].append(name)
        cluster_of[name] = assign[i]

    cut = internal = 0
    for net in netlist.nets:
        ks = {cluster_of[c] for c in [net.driver] + net.sinks
              if c in cluster_of}
        if len(ks) > 1:
            cut += 1
        elif ks:
            internal += 1
    return Clustering(n_clusters=n_clusters, cap=cap, cluster_of=cluster_of,
                      clusters=clusters, cut_nets=cut,
                      internal_nets=internal)
