"""Frequent subgraph mining on a single large graph (paper Sec. III-A).

The paper uses GRAMI.  We implement the same functionality natively: grow
connected candidate patterns edge-by-edge from frequent seeds, deduplicate by
canonical label, and count support against the application graph.  Two
support measures are tracked:

* ``occurrences`` — distinct embedded node-sets (what Fig. 3 reports, e.g.
  "frequency four" for the overlapping add-add pattern in Fig. 3d);
* ``mni`` — GRAMI's minimum-node-image support, which is anti-monotone and is
  what we prune the growth lattice with.

Patterns are restricted to compute(+const) nodes; ``input``/``output`` and
tensor-macro structural nodes never appear inside a mined pattern's interior
op set unless ``allow_macros`` is set (LM tensor-level graphs mine elementwise
idioms around matmul macro nodes; the PE generator later filters).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from ..graphir.graph import Graph
from ..graphir.ops import NON_COMPUTE, OPS, unit_of, U_IO, U_REDUCE, U_MATMUL
from .isomorphism import Embedding, find_embeddings, mni_support

#: ops that may seed/extend patterns by default (real PE compute + const)
def _default_minable(op: str) -> bool:
    if op in NON_COMPUTE:
        return False
    u = unit_of(op)
    return u not in (U_IO, U_REDUCE, U_MATMUL)


@dataclass
class MinedSubgraph:
    """A frequent subgraph with its occurrence statistics."""

    pattern: Graph
    label: str
    embeddings: List[Embedding]
    occurrences: int          # distinct node sets
    mni: int                  # GRAMI MNI support
    mis_size: int = -1        # filled in by core.mis.rank_by_mis

    @property
    def size(self) -> int:
        return self.pattern.num_compute_nodes()

    def __repr__(self) -> str:  # pragma: no cover
        hist = self.pattern.op_histogram()
        ops = ",".join(f"{k}x{v}" for k, v in sorted(hist.items()))
        return (f"MinedSubgraph({ops}; occ={self.occurrences}, mni={self.mni},"
                f" mis={self.mis_size})")


@dataclass
class MiningConfig:
    min_support: int = 2          # MNI threshold (GRAMI semantics)
    max_pattern_nodes: int = 6    # pattern size cap
    max_patterns_per_level: int = 400
    max_embeddings: int = 100_000
    max_ext_embeddings: int = 300  # embeddings examined when extending
    time_budget_s: float = 60.0
    allow_macros: bool = False    # let matmul/reduce macro nodes into patterns


def _minable(op: str, cfg: MiningConfig) -> bool:
    if cfg.allow_macros:
        return op not in NON_COMPUTE and unit_of(op) != U_IO
    return _default_minable(op)


def _seed_patterns(target: Graph, cfg: MiningConfig) -> Dict[str, Graph]:
    """All 1-edge patterns present in the target, keyed by canonical label."""
    seeds: Dict[str, Graph] = {}
    for (s, d, p) in target.edges:
        so, do = target.nodes[s], target.nodes[d]
        if not (_minable(so, cfg) and _minable(do, cfg)):
            continue
        g = Graph()
        a = g.add_node(so)
        b = g.add_node(do)
        g.add_edge(a, b, p)
        seeds.setdefault(g.canonical_label(), g)
    return seeds


def _attach_port(pattern: Graph, dst: int, want: int) -> Optional[int]:
    """Port at which a new in-edge may attach to `dst` inside the pattern.

    Non-commutative ops need exactly `want`; commutative ops take any free
    port (PE input muxes make operand order configurable)."""
    driven = set(pattern.in_edges(dst))
    op = pattern.nodes[dst]
    if not OPS[op].commutative:
        return None if want in driven else want
    for port in range(OPS[op].arity):
        if port not in driven:
            return port
    return None


def _extensions(pattern: Graph, embeddings: List[Embedding],
                target: Graph, cfg: MiningConfig) -> Dict[str, Graph]:
    """Candidate (pattern + 1 edge) extensions, keyed by canonical label."""
    out: Dict[str, Graph] = {}
    pat_nodes = sorted(pattern.nodes)
    n_nodes = len(pat_nodes)
    # one embedding per distinct node-set is enough to enumerate extensions
    uniq: Dict[FrozenSet[int], Embedding] = {}
    for e in embeddings:
        uniq.setdefault(e.nodes, e)
    for emb in list(uniq.values())[: cfg.max_ext_embeddings]:
        inv = {tn: pn for pn, tn in emb.mapping.items()}
        image = emb.nodes
        for (ts, td, tp) in target.edges:
            s_in = ts in image
            d_in = td in image
            if not (s_in or d_in):
                continue
            if s_in and d_in:
                # close an edge between two mapped nodes
                ps, pd = inv[ts], inv[td]
                if any(src == ps for src in pattern.in_edges(pd).values()):
                    continue
                port = _attach_port(pattern, pd, tp)
                if port is None:
                    continue  # port already driven inside pattern
                g = pattern.copy()
                g.add_edge(ps, pd, port)
            else:
                if n_nodes >= cfg.max_pattern_nodes:
                    continue
                new_op = target.nodes[td if s_in else ts]
                if not _minable(new_op, cfg):
                    continue
                g = pattern.copy()
                nid = g.add_node(new_op)
                if s_in:
                    g.add_edge(inv[ts], nid, tp)
                else:
                    port = _attach_port(pattern, inv[td], tp)
                    if port is None:
                        continue
                    g.add_edge(nid, inv[td], port)
            try:
                label = g.canonical_label()
            except ValueError:
                continue
            out.setdefault(label, g)
            if len(out) >= cfg.max_patterns_per_level * 4:
                return out
    return out


def mine_frequent_subgraphs(target: Graph,
                            config: Optional[MiningConfig] = None,
                            ) -> List[MinedSubgraph]:
    """Mine frequent connected subgraphs of `target`.

    Returns patterns with MNI support >= min_support and >= 2 compute nodes,
    sorted by (size desc, occurrences desc).  Single-op "patterns" are the
    baseline PE's territory (paper PE 1) and are not returned here.
    """
    cfg = config or MiningConfig()
    t0 = time.monotonic()
    results: List[MinedSubgraph] = []
    seen: Set[str] = set()

    frontier: Dict[str, Graph] = _seed_patterns(target, cfg)
    while frontier:
        if time.monotonic() - t0 > cfg.time_budget_s:
            break
        scored: List[Tuple[str, Graph, List[Embedding], int, int]] = []
        for label, pat in frontier.items():
            if label in seen:
                continue
            seen.add(label)
            embs = find_embeddings(pat, target,
                                   max_embeddings=cfg.max_embeddings)
            if not embs:
                continue
            occ = len({e.nodes for e in embs})
            mni = mni_support(pat, embs)
            if mni >= cfg.min_support:
                scored.append((label, pat, embs, occ, mni))
        # record + grow the most promising patterns of this level
        scored.sort(key=lambda t: (-t[3], t[0]))
        scored = scored[: cfg.max_patterns_per_level]
        next_frontier: Dict[str, Graph] = {}
        for label, pat, embs, occ, mni in scored:
            results.append(MinedSubgraph(
                pattern=pat, label=label, embeddings=embs,
                occurrences=occ, mni=mni))
            if time.monotonic() - t0 > cfg.time_budget_s:
                break
            for xlabel, xpat in _extensions(pat, embs, target, cfg).items():
                if xlabel not in seen:
                    next_frontier.setdefault(xlabel, xpat)
        frontier = next_frontier

    results.sort(key=lambda m: (-m.size, -m.occurrences, m.label))
    return results
