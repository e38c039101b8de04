"""Maximum-weight clique (paper Sec. III-C, Fig. 5d).

Subgraph merging reduces to a maximum-weight clique over the compatibility
graph of merge opportunities.  Compatibility graphs here are small (tens to a
few hundred vertices), so an exact branch-and-bound with a sorted-residual
upper bound is run first; beyond a vertex budget we fall back to randomized
greedy with restarts (documented approximation).
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Set, Tuple


def max_weight_clique(weights: Sequence[float],
                      adj: Sequence[Set[int]],
                      *,
                      exact_limit: int = 160,
                      node_budget: int = 2_000_000,
                      rng_seed: int = 0) -> List[int]:
    """Return vertex indices of a (near-)maximum-weight clique.

    weights[i] > 0; adj[i] = neighbors of i (compatibility).  Exact BnB when
    len(weights) <= exact_limit and the search stays within node_budget;
    otherwise greedy with restarts.
    """
    n = len(weights)
    if n == 0:
        return []
    order = sorted(range(n), key=lambda i: -weights[i])

    if n <= exact_limit:
        result = _bnb(order, weights, adj, node_budget)
        if result is not None:
            return sorted(result)
    return sorted(_greedy_restarts(order, weights, adj, rng_seed))


def _bnb(order: List[int], weights: Sequence[float],
         adj: Sequence[Set[int]], node_budget: int):
    best: List[int] = []
    best_w = 0.0
    visited = 0
    aborted = False

    # prefix weights for the upper bound
    def ub(cands: List[int]) -> float:
        return sum(weights[c] for c in cands)

    def expand(clique: List[int], cw: float, cands: List[int]) -> None:
        nonlocal best, best_w, visited, aborted
        if aborted:
            return
        visited += 1
        if visited > node_budget:
            aborted = True
            return
        if cw > best_w:
            best, best_w = list(clique), cw
        if not cands:
            return
        if cw + ub(cands) <= best_w:
            return
        for idx, v in enumerate(cands):
            rest = cands[idx + 1:]
            if cw + weights[v] + ub(rest) <= best_w:
                break  # sorted by weight: no later start can beat best
            clique.append(v)
            new_cands = [u for u in rest if u in adj[v]]
            expand(clique, cw + weights[v], new_cands)
            clique.pop()
            if aborted:
                return

    expand([], 0.0, list(order))
    if aborted:
        return None
    return best


def _greedy_restarts(order: List[int], weights: Sequence[float],
                     adj: Sequence[Set[int]], rng_seed: int,
                     restarts: int = 32) -> List[int]:
    rng = random.Random(rng_seed)
    best: List[int] = []
    best_w = -1.0
    n = len(order)
    for r in range(restarts):
        if r == 0:
            seq = list(order)
        else:
            seq = list(order)
            # weight-biased shuffle
            rng.shuffle(seq)
            seq.sort(key=lambda i: -weights[i] * rng.uniform(0.5, 1.0))
        clique: List[int] = []
        cset: Set[int] = set()
        for v in seq:
            if all(v in adj[c] for c in clique):
                clique.append(v)
                cset.add(v)
        w = sum(weights[c] for c in clique)
        if w > best_w:
            best, best_w = clique, w
    return best
