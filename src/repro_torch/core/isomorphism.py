"""Subgraph-isomorphism (embedding) enumeration — VF2-style backtracking.

This underlies both frequent-subgraph mining (occurrence counting, paper
Sec. III-A) and the application mapper (covering, Sec. IV step 6).

Pattern semantics
-----------------
* Pattern nodes carry ops; an embedding maps them injectively onto target
  nodes with the *same op* (``const`` matches any ``const`` — constant
  registers are configured per application, Fig. 2c).
* Every pattern edge ``(ps, pd, port)`` must map onto a target edge
  ``(f(ps), f(pd), port')``.  For non-commutative destination ops the port
  must match exactly (operand order is significant, Sec. II-B); for
  commutative ops the PE's input muxes make operand order configurable, so
  the pattern's internal in-edges of a node must map onto *distinct* target
  in-edges at any ports.
* Pattern free in-ports are unconstrained (fed from outside the PE).
* Optionally (mapper mode) interior pattern nodes — those whose value is
  consumed inside the pattern and which are not pattern sinks — must have no
  *other* consumers in the target graph: a PE only exposes its outputs, so a
  covered interior value cannot feed anything outside the PE instance.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from ..graphir.graph import Graph, sink_nodes
from ..graphir.ops import NON_COMPUTE, OPS


class Embedding:
    """An occurrence of a pattern in a target graph."""

    __slots__ = ("mapping", "nodes")

    def __init__(self, mapping: Dict[int, int]):
        self.mapping = mapping                       # pattern node -> target node
        self.nodes: FrozenSet[int] = frozenset(mapping.values())

    def __repr__(self) -> str:  # pragma: no cover
        return f"Embedding({self.mapping})"


def _search_order(pattern: Graph) -> List[int]:
    """Connected visit order over pattern nodes (undirected BFS)."""
    nodes = sorted(pattern.nodes)
    if not nodes:
        return []
    adj: Dict[int, Set[int]] = {n: set() for n in nodes}
    for (s, d, _) in pattern.edges:
        adj[s].add(d)
        adj[d].add(s)
    order: List[int] = []
    seen: Set[int] = set()
    for root in nodes:
        if root in seen:
            continue
        queue = [root]
        seen.add(root)
        while queue:
            n = queue.pop(0)
            order.append(n)
            for m in sorted(adj[n]):
                if m not in seen:
                    seen.add(m)
                    queue.append(m)
    return order


def _commutative(op: str) -> bool:
    return OPS[op].commutative


def find_embeddings(pattern: Graph, target: Graph, *,
                    max_embeddings: int = 200_000,
                    interior_private: bool = False,
                    max_exposed: Optional[int] = None,
                    allowed_nodes: Optional[Set[int]] = None,
                    ) -> List[Embedding]:
    """Enumerate embeddings of `pattern` in `target` (see module docstring).

    interior_private=True with max_exposed=k allows up to k interior values
    to escape the instance — the PE exposes them on spare output lines
    (multi-output PEs, paper Fig. 5e / Garnet's res+res_p)."""
    order = _search_order(pattern)
    if not order:
        return []

    # target indexes ------------------------------------------------------
    t_in: Dict[int, Dict[int, int]] = {}      # dst -> {port: src}
    t_out: Dict[int, List[Tuple[int, int]]] = {}  # src -> [(dst, port)]
    for (s, d, p) in target.edges:
        t_in.setdefault(d, {})[p] = s
        t_out.setdefault(s, []).append((d, p))
    by_op: Dict[str, List[int]] = {}
    for n, op in target.nodes.items():
        if allowed_nodes is not None and n not in allowed_nodes:
            continue
        by_op.setdefault(op, []).append(n)

    p_in: Dict[int, Dict[int, int]] = {}
    p_out: Dict[int, List[Tuple[int, int]]] = {}
    for (s, d, p) in pattern.edges:
        p_in.setdefault(d, {})[p] = s
        p_out.setdefault(s, []).append((d, p))

    sinks = set(sink_nodes(pattern))
    results: List[Embedding] = []
    mapping: Dict[int, int] = {}
    used: Set[int] = set()

    def edge_ok(tn_src: int, tn_dst: int, port: int, dst_op: str) -> bool:
        """Does target have edge tn_src -> tn_dst honoring port semantics?"""
        ins = t_in.get(tn_dst, {})
        if not _commutative(dst_op):
            return ins.get(port) == tn_src
        return tn_src in ins.values()

    def node_edges_ok(pn: int, tn: int) -> bool:
        """All pattern edges between pn and already-mapped nodes hold."""
        # in-edges of pn
        internal_srcs: List[int] = []
        for port, ps in p_in.get(pn, {}).items():
            if ps in mapping:
                if not edge_ok(mapping[ps], tn, port, pattern.nodes[pn]):
                    return False
                internal_srcs.append(mapping[ps])
        # commutative: distinct pattern in-edges need distinct target in-edges
        if _commutative(pattern.nodes[pn]) and internal_srcs:
            tgt_srcs = list(t_in.get(tn, {}).values())
            for s in set(internal_srcs):
                if internal_srcs.count(s) > tgt_srcs.count(s):
                    return False
        # out-edges of pn
        for (pd, port) in p_out.get(pn, ()):
            if pd in mapping:
                if not edge_ok(tn, mapping[pd], port, pattern.nodes[pd]):
                    return False
        return True

    def candidates(pn: int) -> Iterator[int]:
        op = pattern.nodes[pn]
        for port, ps in p_in.get(pn, {}).items():
            if ps in mapping:
                for (td, tp) in t_out.get(mapping[ps], ()):
                    if target.nodes.get(td) != op:
                        continue
                    if _commutative(op) or tp == port:
                        yield td
                return
        for (pd, port) in p_out.get(pn, ()):
            if pd in mapping:
                td = mapping[pd]
                if _commutative(pattern.nodes[pd]):
                    for src in t_in.get(td, {}).values():
                        if target.nodes.get(src) == op:
                            yield src
                else:
                    src = t_in.get(td, {}).get(port)
                    if src is not None and target.nodes.get(src) == op:
                        yield src
                return
        yield from by_op.get(op, ())

    def feasible(pn: int, tn: int) -> bool:
        if tn in used:
            return False
        if allowed_nodes is not None and tn not in allowed_nodes:
            return False
        if target.nodes[tn] != pattern.nodes[pn]:
            return False
        return node_edges_ok(pn, tn)

    def interior_ok(emb: Dict[int, int]) -> bool:
        if not interior_private:
            return True
        budget = max_exposed or 0
        image = set(emb.values())
        exposed = 0
        for pn, tn in emb.items():
            if pn in sinks:
                continue
            # const registers are duplicated per PE instance (Fig. 2c), so a
            # shared constant never blocks covering
            if pattern.nodes[pn] in NON_COMPUTE or pattern.nodes[pn] == "const":
                continue
            if any(td not in image for (td, _) in t_out.get(tn, ())):
                exposed += 1
                if exposed > budget:
                    return False
        return True

    def backtrack(i: int) -> bool:
        if i == len(order):
            emb = dict(mapping)
            if interior_ok(emb):
                results.append(Embedding(emb))
            return len(results) < max_embeddings
        pn = order[i]
        seen_c: Set[int] = set()
        for tn in candidates(pn):
            if tn in seen_c:
                continue
            seen_c.add(tn)
            if not feasible(pn, tn):
                continue
            mapping[pn] = tn
            used.add(tn)
            ok = backtrack(i + 1)
            del mapping[pn]
            used.discard(tn)
            if not ok:
                return False
        return True

    backtrack(0)
    return results


def count_occurrences(pattern: Graph, target: Graph, **kw) -> int:
    """Occurrences = distinct embedded node-sets (automorphism-collapsed)."""
    embs = find_embeddings(pattern, target, **kw)
    return len({e.nodes for e in embs})


def mni_support(pattern: Graph, embeddings: List[Embedding]) -> int:
    """GRAMI's minimum-node-image support (anti-monotone)."""
    if not embeddings:
        return 0
    images: Dict[int, Set[int]] = {}
    for e in embeddings:
        for pn, tn in e.mapping.items():
            images.setdefault(pn, set()).add(tn)
    return min(len(v) for v in images.values())
