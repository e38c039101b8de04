"""Directed, port-labeled dataflow graph — the CoreIR analogue.

Nodes carry a primitive op name (see :mod:`repro_torch.graphir.ops`); edges carry
the *destination port* (operand index), because operand order matters for
non-commutative ops (paper Sec. II-B).  A node has at most one producer per
input port.

The same structure is used for full application graphs, mined subgraph
patterns, and merged PE datapaths (which additionally contain ``sel``/mux
nodes inserted by :mod:`repro_torch.core.merge`).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

from .ops import OPS, NON_COMPUTE

Edge = Tuple[int, int, int]  # (src_node, dst_node, dst_port)


@dataclass
class Graph:
    """Mutable dataflow graph.

    nodes: node id -> op name
    attrs: node id -> free-form attributes (const value, input index, ...)
    edges: set of (src, dst, dst_port)
    outputs: ordered node ids whose values are graph results
    """

    nodes: Dict[int, str] = field(default_factory=dict)
    attrs: Dict[int, Dict[str, Any]] = field(default_factory=dict)
    edges: set = field(default_factory=set)
    outputs: List[int] = field(default_factory=list)
    _next_id: int = 0

    # -- construction ------------------------------------------------------
    def add_node(self, op: str, **attrs: Any) -> int:
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}")
        nid = self._next_id
        self._next_id += 1
        self.nodes[nid] = op
        if attrs:
            self.attrs[nid] = dict(attrs)
        return nid

    def add_edge(self, src: int, dst: int, port: int) -> None:
        if src not in self.nodes or dst not in self.nodes:
            raise KeyError("edge endpoints must exist")
        # one producer per (dst, port)
        for (s, d, p) in self.edges:
            if d == dst and p == port:
                raise ValueError(f"port {port} of node {dst} already driven by {s}")
        self.edges.add((src, dst, port))

    def mark_output(self, nid: int) -> None:
        self.outputs.append(nid)

    # -- views -------------------------------------------------------------
    def op(self, nid: int) -> str:
        return self.nodes[nid]

    def attr(self, nid: int, key: str, default: Any = None) -> Any:
        return self.attrs.get(nid, {}).get(key, default)

    def in_edges(self, nid: int) -> Dict[int, int]:
        """port -> src node id."""
        return {p: s for (s, d, p) in self.edges if d == nid}

    def out_edges(self, nid: int) -> List[Tuple[int, int]]:
        """[(dst, port)] sorted for determinism."""
        return sorted((d, p) for (s, d, p) in self.edges if s == nid)

    def fanout(self, nid: int) -> int:
        return sum(1 for (s, _, _) in self.edges if s == nid)

    def num_nodes(self) -> int:
        return len(self.nodes)

    def num_compute_nodes(self) -> int:
        return sum(1 for op in self.nodes.values() if op not in NON_COMPUTE)

    def compute_nodes(self) -> List[int]:
        return [n for n, op in sorted(self.nodes.items()) if op not in NON_COMPUTE]

    def op_histogram(self) -> Dict[str, int]:
        hist: Dict[str, int] = {}
        for op in self.nodes.values():
            hist[op] = hist.get(op, 0) + 1
        return hist

    # -- algorithms ----------------------------------------------------------
    def topo_order(self) -> List[int]:
        indeg = {n: 0 for n in self.nodes}
        for (_, d, _) in self.edges:
            indeg[d] += 1
        ready = sorted(n for n, k in indeg.items() if k == 0)
        order: List[int] = []
        succs: Dict[int, List[int]] = {n: [] for n in self.nodes}
        for (s, d, _) in self.edges:
            succs[s].append(d)
        seen_edge: Dict[int, int] = dict(indeg)
        while ready:
            n = ready.pop()
            order.append(n)
            for d in succs[n]:
                seen_edge[d] -= 1
                if seen_edge[d] == 0:
                    ready.append(d)
            ready.sort()
        if len(order) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return order

    def induced_subgraph(self, keep: Iterable[int]) -> "Graph":
        """Subgraph on `keep` nodes with all edges among them (ids preserved)."""
        keep_set = set(keep)
        g = Graph()
        g.nodes = {n: self.nodes[n] for n in keep_set}
        g.attrs = {n: dict(self.attrs[n]) for n in keep_set if n in self.attrs}
        g.edges = {(s, d, p) for (s, d, p) in self.edges
                   if s in keep_set and d in keep_set}
        g.outputs = [n for n in self.outputs if n in keep_set]
        g._next_id = max(keep_set, default=-1) + 1
        return g

    def copy(self) -> "Graph":
        g = Graph()
        g.nodes = dict(self.nodes)
        g.attrs = {n: dict(a) for n, a in self.attrs.items()}
        g.edges = set(self.edges)
        g.outputs = list(self.outputs)
        g._next_id = self._next_id
        return g

    # -- JSON round trip ------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """JSON-serializable dict; :meth:`from_dict` restores a graph whose
        :func:`repro_torch.explore.graph_key` fingerprint matches the original's
        (node ids, attrs, edge set, and output order all preserved)."""
        return {
            "nodes": {str(n): op for n, op in sorted(self.nodes.items())},
            "attrs": {str(n): dict(a)
                      for n, a in sorted(self.attrs.items()) if a},
            "edges": sorted(list(e) for e in self.edges),
            "outputs": list(self.outputs),
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Graph":
        """Rebuild a graph from :meth:`to_dict` output, validating ops and
        edge endpoints (raises ``ValueError`` on malformed input)."""
        if not isinstance(d, dict):
            raise ValueError(f"graph blob must be an object, "
                             f"got {type(d).__name__}")
        g = Graph()
        try:
            nodes = {int(n): str(op)
                     for n, op in dict(d.get("nodes", {})).items()}
        except (TypeError, ValueError):
            raise ValueError("graph nodes must map int ids to op names")
        for nid, op in nodes.items():
            if op not in OPS:
                raise ValueError(f"unknown op {op!r} at node {nid}")
        g.nodes = nodes
        g.attrs = {int(n): dict(a)
                   for n, a in dict(d.get("attrs", {})).items()}
        for (s, dst, p) in d.get("edges", []):
            g.add_edge(int(s), int(dst), int(p))
        for nid in d.get("outputs", []):
            if int(nid) not in g.nodes:
                raise ValueError(f"output node {nid} does not exist")
            g.outputs.append(int(nid))
        g._next_id = max(g.nodes, default=-1) + 1
        return g

    def relabeled(self) -> "Graph":
        """Copy with node ids renumbered 0..n-1 in topological order."""
        mapping = {old: i for i, old in enumerate(self.topo_order())}
        g = Graph()
        g.nodes = {mapping[n]: op for n, op in self.nodes.items()}
        g.attrs = {mapping[n]: dict(a) for n, a in self.attrs.items()}
        g.edges = {(mapping[s], mapping[d], p) for (s, d, p) in self.edges}
        g.outputs = [mapping[n] for n in self.outputs]
        g._next_id = len(g.nodes)
        return g

    # -- canonical form -------------------------------------------------------
    def _eff_port(self, dst: int, port: int) -> int:
        """Effective port label: commutative ops' operand order is immaterial
        (PE input muxes make order configurable, paper Sec. II-B)."""
        if OPS[self.nodes[dst]].commutative:
            return -1
        return port

    def canonical_label(self) -> str:
        """Canonical string; equal iff graphs are isomorphic (op labels +
        effective-port labels — commutative operand order collapsed).

        Weisfeiler-Lehman color refinement, then exhaustive permutation within
        residual color classes.  Intended for small graphs (mined patterns,
        <= ~12 nodes); raises for graphs where the residual search would blow up.
        """
        nodes = sorted(self.nodes)
        if not nodes:
            return "()"
        in_adj: Dict[int, List[Tuple[int, int]]] = {n: [] for n in nodes}
        out_adj: Dict[int, List[Tuple[int, int]]] = {n: [] for n in nodes}
        for (s, d, p) in self.edges:
            ep = self._eff_port(d, p)
            out_adj[s].append((d, ep))
            in_adj[d].append((s, ep))

        # WL refinement
        color: Dict[int, Any] = {n: self.nodes[n] for n in nodes}
        for _ in range(len(nodes)):
            new_color = {}
            for n in nodes:
                ins = tuple(sorted((color[s], p) for (s, p) in in_adj[n]))
                outs = tuple(sorted((color[d], p) for (d, p) in out_adj[n]))
                new_color[n] = (color[n], ins, outs)
            # compress
            uniq = sorted(set(new_color.values()), key=repr)
            remap = {c: i for i, c in enumerate(uniq)}
            compressed = {n: (self.nodes[n], remap[new_color[n]]) for n in nodes}
            if len(set(compressed.values())) == len(set(color.values())):
                color = compressed
                break
            color = compressed

        # group into classes
        classes: Dict[Any, List[int]] = {}
        for n in nodes:
            classes.setdefault(color[n], []).append(n)
        class_list = sorted(classes.items(), key=lambda kv: repr(kv[0]))
        # bound the permutation search
        perm_count = 1
        for _, members in class_list:
            for k in range(2, len(members) + 1):
                perm_count *= k
            if perm_count > 40320:
                raise ValueError(
                    f"canonical_label: residual automorphism search too large "
                    f"({self.num_nodes()} nodes)")

        best: Optional[str] = None
        member_perms = [list(itertools.permutations(m)) for _, m in class_list]
        for combo in itertools.product(*member_perms):
            mapping: Dict[int, int] = {}
            i = 0
            for perm in combo:
                for n in perm:
                    mapping[n] = i
                    i += 1
            sig_nodes = tuple(
                self.nodes[n] for n in sorted(mapping, key=mapping.get))
            sig_edges = tuple(sorted(
                (mapping[s], mapping[d], self._eff_port(d, p))
                for (s, d, p) in self.edges))
            sig = repr((sig_nodes, sig_edges))
            if best is None or sig < best:
                best = sig
        assert best is not None
        return best

    # -- IO ---------------------------------------------------------------------
    def to_dot(self, name: str = "g") -> str:
        lines = [f"digraph {name} {{"]
        for n, op in sorted(self.nodes.items()):
            extra = ""
            if op == "const":
                extra = f"={self.attr(n, 'value')}"
            shape = "box" if op not in NON_COMPUTE else "ellipse"
            lines.append(f'  n{n} [label="{op}{extra}\\n#{n}", shape={shape}];')
        for (s, d, p) in sorted(self.edges):
            lines.append(f'  n{s} -> n{d} [label="{p}"];')
        lines.append("}")
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Graph(nodes={len(self.nodes)}, edges={len(self.edges)}, "
                f"outputs={len(self.outputs)})")


def pattern_from_spec(spec: Sequence[Tuple[str, Sequence[int]]]) -> Graph:
    """Build a small pattern graph from a compact spec.

    spec[i] = (op, (operand_node_indices...)); operand index -1 means the port
    is fed from outside the pattern (left dangling).  Example — the paper's
    Fig. 3b ``mul -> add``::

        pattern_from_spec([("mul", (-1, -1)), ("add", (0, -1))])
    """
    g = Graph()
    ids: List[int] = []
    for op, operands in spec:
        nid = g.add_node(op, value=0.0) if op == "const" else g.add_node(op)
        ids.append(nid)
        for port, operand in enumerate(operands):
            if operand >= 0:
                g.add_edge(ids[operand], nid, port)
    return g


def free_in_ports(g: Graph) -> List[Tuple[int, int]]:
    """(node, port) pairs not driven inside the graph = PE data inputs."""
    driven = {(d, p) for (_, d, p) in g.edges}
    out: List[Tuple[int, int]] = []
    for n in sorted(g.nodes):
        op = g.nodes[n]
        if op in NON_COMPUTE:
            continue
        for port in range(OPS[op].arity):
            if (n, port) not in driven:
                out.append((n, port))
    return out


def sink_nodes(g: Graph) -> List[int]:
    """Nodes exposed as PE outputs: no consumer inside the graph, or an
    explicitly marked graph output."""
    srcs = {s for (s, _, _) in g.edges}
    sinks = [n for n in sorted(g.nodes)
             if g.nodes[n] not in NON_COMPUTE
             and (n not in srcs or n in g.outputs)]
    if not sinks:
        sinks = sorted(g.nodes)[-1:]
    return sinks
