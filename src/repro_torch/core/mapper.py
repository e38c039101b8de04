"""Application mapper (paper Sec. IV step 6).

Covers the application dataflow graph with PE configurations, minimizing the
number of PEs used: multi-op configs are matched first (largest pattern
first, non-overlapping greedy — the same maximal-independent-set machinery
that ranks subgraphs), remaining compute nodes fall back to single-op
configs.  CGRAs are spatial, so every covered instance occupies one PE tile.

Constants are absorbed into the instance that consumes them (configured
constant registers, Fig. 2c) and may be freely duplicated across instances.
Tensor-macro nodes (matmul / reductions in LM-layer graphs) are not PE ops —
they are counted separately as "offloaded" (they map to the MXU / XLA in the
TPU adaptation).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..graphir.graph import Graph
from ..graphir.ops import NON_COMPUTE, OPS, unit_of
from .isomorphism import Embedding, find_embeddings
from .merge import _PE_UNITS
from .mis import maximal_independent_set
from .pe import Config, Datapath


@dataclass
class MappedInstance:
    config: str
    mapping: Dict[int, int]          # pattern node -> app node
    covered: Set[int]                # app compute nodes covered (consts excl.)
    n_ops: int


@dataclass
class Mapping:
    app_name: str
    instances: List[MappedInstance] = field(default_factory=list)
    offloaded: List[int] = field(default_factory=list)   # macro nodes
    unmapped: List[int] = field(default_factory=list)    # should be empty

    @property
    def n_pes(self) -> int:
        return len(self.instances)

    @property
    def total_ops(self) -> int:
        return sum(i.n_ops for i in self.instances)

    @property
    def ops_per_pe(self) -> float:
        return self.total_ops / max(1, self.n_pes)


def _coverable(op: str) -> bool:
    return (op not in NON_COMPUTE and op != "const"
            and unit_of(op) in _PE_UNITS and op != "cmux")


def map_application(dp: Datapath, app: Graph, app_name: str = "app",
                    *, max_embeddings: int = 50_000,
                    max_exposed: int = 1) -> Mapping:
    """max_exposed: spare PE output lines usable to expose interior values
    (Garnet-class PEs have a second output; see Fig. 5e)."""
    m = Mapping(app_name)
    covered: Set[int] = set()
    compute = [n for n, op in sorted(app.nodes.items()) if _coverable(op)]
    m.offloaded = [n for n, op in sorted(app.nodes.items())
                   if op not in NON_COMPUTE and op != "const"
                   and not _coverable(op)]

    # ---- multi-op configs, largest first ---------------------------------
    multi = [c for c in dp.configs.values() if c.n_ops >= 2]
    multi.sort(key=lambda c: (-c.n_ops, c.name))
    for cfg in multi:
        embs = find_embeddings(cfg.pattern, app, interior_private=True,
                               max_exposed=max_exposed,
                               max_embeddings=max_embeddings)
        # drop embeddings conflicting with already-covered nodes, dedupe by
        # node set, then take a maximal independent set of the remainder —
        # the same machinery that ranks subgraphs (Sec. III-B) maximizes the
        # number of non-overlapping instances here.
        cand: Dict[frozenset, Embedding] = {}
        for e in embs:
            hard = frozenset(t for p, t in e.mapping.items()
                             if cfg.pattern.nodes[p] != "const")
            if hard & covered:
                continue
            cand.setdefault(hard, e)
        sets = sorted(cand.keys(), key=sorted)
        keep = maximal_independent_set(sets)
        for i in keep:
            hard = sets[i]
            e = cand[hard]
            covered |= hard
            m.instances.append(MappedInstance(
                cfg.name, dict(e.mapping), set(hard), cfg.n_ops))

    # ---- single-op fallback ------------------------------------------------
    for n in compute:
        if n in covered:
            continue
        op = app.nodes[n]
        ins = app.in_edges(n)
        # prefer a const-register variant when an operand is a constant
        cand: List[str] = []
        for p in sorted(ins):
            if app.nodes.get(ins[p]) == "const":
                cand.append(f"op:{op}_c{p}")
        cand.append(f"op:{op}")
        chosen: Optional[str] = None
        for name in cand:
            if name in dp.configs:
                chosen = name
                break
        if chosen is None:
            m.unmapped.append(n)
            continue
        cfg = dp.configs[chosen]
        pat_nodes = {pn for pn, o in cfg.pattern.nodes.items() if o == op}
        pn = sorted(pat_nodes)[0]
        covered.add(n)
        m.instances.append(MappedInstance(chosen, {pn: n}, {n}, cfg.n_ops))
    return m
