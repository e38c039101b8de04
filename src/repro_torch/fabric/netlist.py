"""Mapping -> fabric netlist extraction (the exemplar's "packing" step).

A :class:`~repro_torch.core.mapper.Mapping` places every covered application node
inside some PE instance; the fabric netlist is the inter-tile view of that
cover:

* one **PE cell** per mapped instance;
* **I/O cells** for signals that enter/leave the array — application graph
  inputs, graph outputs, and values exchanged with offloaded tensor macros.
  Up to ``io_capacity`` distinct signals share one I/O cell (a streaming
  memory-interface tile serves several operands);
* one **net** per produced signal, from its driver cell to every cell that
  consumes it externally.

Constants are folded: ``const`` nodes live in configured constant registers
inside the consuming PE (paper Fig. 2c), so they generate neither cells nor
nets.  Values produced and consumed inside the same instance stay inside the
tile and also generate no nets.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..core.mapper import Mapping
from ..graphir.graph import Graph
from .arch import FabricSpec


@dataclass
class Cell:
    name: str
    kind: str                    # "pe" | "io_in" | "io_out"
    instance: int = -1           # index into mapping.instances for PE cells
    signals: List[int] = field(default_factory=list)   # app nodes on IO cells


@dataclass
class Net:
    name: str
    driver: str                  # cell name
    sinks: List[str]             # cell names (deduped, sorted)
    signal: int = -1             # producing app node

    @property
    def degree(self) -> int:
        return 1 + len(self.sinks)


@dataclass
class Netlist:
    app_name: str
    cells: Dict[str, Cell] = field(default_factory=dict)
    nets: List[Net] = field(default_factory=list)

    @property
    def pe_cells(self) -> List[Cell]:
        return [c for c in self.cells.values() if c.kind == "pe"]

    @property
    def io_cells(self) -> List[Cell]:
        return [c for c in self.cells.values() if c.kind != "pe"]

    def summary(self) -> str:
        return (f"Netlist[{self.app_name}: {len(self.pe_cells)} PEs, "
                f"{len(self.io_cells)} IOs, {len(self.nets)} nets]")


def synthetic_netlist(spec: FabricSpec, *, fill: float = 0.85,
                      seed: int = 0, max_fanout: int = 3,
                      io_frac: float = 0.25,
                      locality: Optional[int] = None) -> Netlist:
    """Random netlist sized to a fabric — the placer-scaling workload.

    Fills ``fill`` of the PE tiles with cells; each PE drives one net to
    1..max_fanout random PE sinks (one produced signal per cell, like the
    extractor emits), ``io_frac`` of the perimeter sites split between
    input streams (each feeding a few PEs) and output taps (extra sinks on
    existing PE nets).  Deterministic in ``seed``; no application needed,
    so it scales to any ``rows x cols``.

    ``locality`` (a window radius in tiles) biases each PE's sinks to
    cells whose *home tile* — cell ``i`` homes at ``(i % cols,
    i // cols)`` — lies within a Chebyshev window of the driver's.  Real
    mapped dataflow graphs are local (producers feed nearby consumers),
    and the hierarchical placer's clustering only pays off on such
    structure; uniformly random netlists have no clusters to find.  The
    default (``None``) keeps the original fully random draw, bit-identical
    to what this function produced before ``locality`` existed.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    n_pe = max(2, int(spec.n_pe_tiles * fill))
    n_io = min(spec.n_io_sites, max(2, int(spec.n_io_sites * io_frac)))
    n_in = max(1, n_io // 2)
    n_out = max(1, n_io - n_in)

    nl = Netlist(f"synthetic_{spec.cols}x{spec.rows}_s{seed}")
    for i in range(n_pe):
        nl.cells[f"pe{i}"] = Cell(f"pe{i}", "pe", instance=i)
    for j in range(n_in):
        nl.cells[f"in{j}"] = Cell(f"in{j}", "io_in", signals=[j])
    for j in range(n_out):
        nl.cells[f"out{j}"] = Cell(f"out{j}", "io_out", signals=[n_in + j])

    sinks_of: Dict[int, Set[str]] = {}
    for i in range(n_pe):
        k = int(rng.integers(1, max_fanout + 1))
        if locality:
            hx, hy = i % spec.cols, i // spec.cols
            ys = np.arange(max(0, hy - locality),
                           min(spec.rows, hy + locality + 1))
            xs = np.arange(max(0, hx - locality),
                           min(spec.cols, hx + locality + 1))
            window = (ys[:, None] * spec.cols + xs[None, :]).ravel()
            window = window[(window < n_pe) & (window != i)]
            cand = rng.choice(window, size=min(k, len(window)),
                              replace=False)
            sinks = [f"pe{c}" for c in cand]
        else:
            # draw one spare so dropping the driver still leaves k sinks
            cand = rng.choice(n_pe, size=min(k + 1, n_pe), replace=False)
            sinks = [f"pe{c}" for c in cand if c != i][:k]
        sinks_of[i] = set(sinks) or {f"pe{(i + 1) % n_pe}"}
    for j in range(n_out):                 # output taps on random PE nets
        sinks_of[int(rng.integers(0, n_pe))].add(f"out{j}")
    for i in range(n_pe):
        nl.nets.append(Net(f"n{i:05d}", f"pe{i}",
                           sorted(sinks_of[i]), signal=i))
    for j in range(n_in):                  # input streams into random PEs
        k = int(rng.integers(1, max_fanout + 1))
        cand = rng.choice(n_pe, size=min(k, n_pe), replace=False)
        nl.nets.append(Net(f"n_in{j:05d}", f"in{j}",
                           sorted({f"pe{c}" for c in cand}),
                           signal=n_pe + j))
    nl.nets.sort(key=lambda n: n.name)
    return nl


def extract_netlist(mapping: Mapping, app: Graph,
                    spec: Optional[FabricSpec] = None,
                    *, io_group: Optional[int] = None) -> Netlist:
    """Build the inter-tile netlist for `mapping` of `app`.

    io_group: distinct signals per I/O cell (defaults to spec.io_capacity,
    else 4).
    """
    if io_group is None:
        io_group = spec.io_capacity if spec is not None else 4
    nl = Netlist(mapping.app_name)

    # PE cells + home map (covered app node -> owning cell)
    home: Dict[int, str] = {}
    for i, inst in enumerate(mapping.instances):
        cell = Cell(f"pe{i}", "pe", instance=i)
        nl.cells[cell.name] = cell
        for n in inst.covered:
            home[n] = cell.name

    off_array = set(mapping.offloaded)

    # signal -> external consumer cells
    consumers: Dict[int, Set[str]] = {}
    for i, inst in enumerate(mapping.instances):
        cname = f"pe{i}"
        for n in inst.covered:
            for port, src in app.in_edges(n).items():
                if src in inst.covered or app.nodes.get(src) == "const":
                    continue        # intra-tile wire / folded constant
                consumers.setdefault(src, set()).add(cname)

    # signals that leave the array: graph outputs, feeds into offloaded
    # macros or explicit output nodes
    leaves: Set[int] = set()
    for n in home:
        if n in app.outputs:
            leaves.add(n)
        for dst, _ in app.out_edges(n):
            op = app.nodes[dst]
            if dst in off_array or op == "output":
                leaves.add(n)

    # off-array producers consumed by PEs: graph inputs, offloaded macros,
    # and (defensively) unmapped compute nodes
    ext_inputs = sorted(s for s in consumers if s not in home)

    def _alloc_io(signals: List[int], kind: str, prefix: str) -> Dict[int, str]:
        where: Dict[int, str] = {}
        for gi in range(0, len(signals), io_group):
            group = signals[gi:gi + io_group]
            cell = Cell(f"{prefix}{gi // io_group}", kind, signals=list(group))
            nl.cells[cell.name] = cell
            for s in group:
                where[s] = cell.name
        return where

    in_cell_of = _alloc_io(ext_inputs, "io_in", "in")
    out_cell_of = _alloc_io(sorted(leaves), "io_out", "out")

    # nets: one per produced signal with external consumers
    for sig in sorted(set(consumers) | leaves):
        driver = home.get(sig) or in_cell_of.get(sig)
        if driver is None:
            continue
        sinks = {c for c in consumers.get(sig, ()) if c != driver}
        if sig in out_cell_of:
            sinks.add(out_cell_of[sig])
        sinks.discard(driver)
        if not sinks:
            continue
        nl.nets.append(Net(f"n{sig}", driver, sorted(sinks), signal=sig))
    nl.nets.sort(key=lambda n: n.name)
    return nl
