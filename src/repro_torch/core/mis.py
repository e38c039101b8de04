"""Maximal-independent-set analysis of subgraph occurrences (paper Sec. III-B).

Occurrences of a mined subgraph may overlap in the application graph; only
non-overlapping occurrences can be accelerated by fully-utilized PEs.  Each
occurrence (distinct node set) becomes a vertex of an *overlap graph*; two
vertices are adjacent iff their node sets intersect.  The size of a maximal
independent set of that graph is the subgraph's utility (paper Fig. 4) and is
the ranking key for which subgraphs get merged into the PE first.

The paper computes a *maximal* (not maximum) independent set; we use the
classic greedy minimum-degree heuristic, which returns a maximal set and
matches the paper's illustration (MIS size 2 for Fig. 3d's four overlapping
occurrences).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Sequence, Set

from .mining import MinedSubgraph


def maximal_independent_set(node_sets: Sequence[FrozenSet[int]]) -> List[int]:
    """Greedy MIS over occurrence node-sets; returns selected indices."""
    n = len(node_sets)
    # adjacency by shared application-graph nodes
    by_node: Dict[int, List[int]] = {}
    for i, s in enumerate(node_sets):
        for v in s:
            by_node.setdefault(v, []).append(i)
    adj: List[Set[int]] = [set() for _ in range(n)]
    for members in by_node.values():
        if len(members) > 1:
            for i in members:
                adj[i].update(members)
    for i in range(n):
        adj[i].discard(i)

    alive = set(range(n))
    chosen: List[int] = []
    while alive:
        # min-degree greedy (ties by index for determinism)
        i = min(alive, key=lambda k: (len(adj[k] & alive), k))
        chosen.append(i)
        dead = {i} | (adj[i] & alive)
        alive -= dead
    return sorted(chosen)


def mis_of_occurrences(embeddings_nodes: Sequence[FrozenSet[int]]) -> int:
    return len(maximal_independent_set(list(embeddings_nodes)))


def rank_by_mis(mined: Sequence[MinedSubgraph]) -> List[MinedSubgraph]:
    """Fill mis_size and return subgraphs sorted by the paper's ranking.

    "The mined subgraphs are ranked by MIS size so that subgraphs that have
    many overlapping occurrences are considered last" (Sec. III-C).  We rank
    by MIS size, breaking ties toward larger subgraphs (more ops fused per PE
    invocation) and then by label for determinism.
    """
    for m in mined:
        occ_sets = sorted({e.nodes for e in m.embeddings}, key=sorted)
        m.mis_size = mis_of_occurrences(occ_sets)
    return sorted(mined, key=lambda m: (-m.mis_size, -m.size, m.label))
