"""Iterative modulo scheduler for a placed-and-routed mapping.

The static pipeline (mine -> merge -> map -> place -> route) says nothing
about *time*: every PE instance fires once per loop iteration, and the
initiation interval (II) — how many cycles separate consecutive iterations —
is what turns a mapped design into delivered throughput.  This module
assigns each schedulable unit a start cycle under modulo resource
reservation (Rau's iterative modulo scheduling), reporting the achieved II
against the recurrence/resource-constrained minimum (MII).

Timing model (shared with :mod:`repro_torch.sim.cycle`, which executes it):

* a producer's output register is valid one cycle after it fires
  (``L_OUT = 1``);
* every mesh hop is a pipeline register: the value reaches hop depth ``d``
  of its routed tree at ``t_producer + L_OUT + d``;
* each consumer tile latches an arriving operand into a per-(cell, signal)
  input FIFO the cycle it lands (``L_LATCH = 1``); the FIFO is
  ``spec.latch_depth`` iterations deep and refreshed every II cycles, so a
  consumer must fire inside the window
  ``arrival + 1 <= t <= arrival + latch_depth * II`` or the stream
  overwrites its operand (the classic modulo hold constraint, relaxed by
  Garnet-style input FIFOs that absorb operand-arrival skew).

Schedulable units ("ops"):

* ``("in", signal)`` — an I/O tile streaming one input word; a tile with k
  signals needs k distinct cycle slots mod II, which is what makes stencil
  apps input-bandwidth-bound (ResMII = max signals per I/O cell);
* ``("pe", instance)`` — a PE instance firing its configured invocation;
  it also reserves the output-capture slot at every io_out tile it feeds.

Application graphs here are acyclic (the tracer builds pure dataflow), so
RecMII is 1; the machinery still detects cycles and refuses them loudly.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, Generator, List, Optional, Set, Tuple

import numpy as np

from ..errors import BudgetExceeded
from ..fabric.arch import Coord, FabricSpec
from ..fabric.netlist import Netlist
from ..fabric.place import Placement
from ..fabric.route import RoutedNet, RouteResult
from ..obs import span
from ..obs.metrics import global_registry

#: output-register and input-latch latencies (cycles)
L_OUT = 1
L_LATCH = 1

OpKey = Tuple[str, int]          # ("in", signal) | ("pe", instance index)


@dataclass
class NetTiming:
    """Per-net register chain derived from the routed tree.

    ``parent[t]`` is the tile whose hop register feeds tile ``t``;
    ``depth[t]`` is the register distance from the driver.  One pipeline
    register exists per non-driver tile of the tree (per-track, so nets
    sharing a physical channel keep separate registers).
    """

    driver: Coord
    parent: Dict[Coord, Coord]
    depth: Dict[Coord, int]


def route_timing(net: RoutedNet) -> NetTiming:
    """Min-depth parent chain over the routed (tree-ish) edge set."""
    depth: Dict[Coord, int] = {net.driver: 0}
    # relax to fixpoint; edge sets are tiny and may rarely contain a
    # redundant in-edge, so pick the min-depth parent deterministically
    changed = True
    while changed:
        changed = False
        for (a, b) in sorted(net.edges):
            if a in depth and depth[a] + 1 < depth.get(b, 1 << 30):
                depth[b] = depth[a] + 1
                changed = True
    parent: Dict[Coord, Coord] = {}
    for (a, b) in sorted(net.edges):
        if a in depth and depth[a] + 1 == depth.get(b):
            parent.setdefault(b, a)
    for s in net.sinks:
        if s not in depth:
            raise ValueError(f"routed net does not reach sink {s}")
    return NetTiming(net.driver, parent, depth)


@dataclass
class DepEdge:
    src: OpKey
    dst: OpKey
    hops: int                    # register depth driver -> consumer tile
    signal: int


@dataclass
class CaptureEvent:
    """An output word landing on an io_out tile (one word/cycle/tile)."""

    producer: OpKey
    signal: int
    tile: Coord
    hops: int


@dataclass
class ModuloSchedule:
    ii: int
    rec_mii: int
    res_mii: int
    start: Dict[OpKey, int]                  # op -> fire cycle (iteration 0)
    capture: Dict[int, int]                  # leaving signal -> capture cycle
    latency: int                             # cycles to iteration-0 outputs
    attempts: int                            # IIs tried before success
    latch_depth: int = 1                     # input-FIFO depth scheduled for
    hop_time: Dict[Tuple[str, Coord], int] = field(default_factory=dict)
    # (net name, tile) -> cycle its hop register first holds iteration-0 data
    net_timing: Dict[str, NetTiming] = field(default_factory=dict)
    net_src: Dict[str, OpKey] = field(default_factory=dict)
    # per-net register chains and producer ops, published so the simulator
    # lowers against the exact timing the scheduler used (single source)

    @property
    def min_ii(self) -> int:
        return max(self.rec_mii, self.res_mii)

    def summary(self) -> str:
        return (f"ModuloSchedule[II={self.ii} (min {self.min_ii}: "
                f"rec {self.rec_mii}/res {self.res_mii}) "
                f"latency={self.latency} ops={len(self.start)}]")


@dataclass
class _Problem:
    ops: List[OpKey]
    tile_of: Dict[OpKey, Coord]
    deps: List[DepEdge]
    captures: List[CaptureEvent]
    preds: Dict[OpKey, List[DepEdge]]
    succs: Dict[OpKey, List[DepEdge]]
    caps_of: Dict[OpKey, List[CaptureEvent]]
    net_src: Dict[str, OpKey] = field(default_factory=dict)


def _build_problem(netlist: Netlist, placement: Placement,
                   routes: RouteResult) -> Tuple[_Problem,
                                                 Dict[str, NetTiming]]:
    coords = placement.coords
    cell_kind = {name: c.kind for name, c in netlist.cells.items()}
    inst_of_cell = {name: c.instance for name, c in netlist.cells.items()
                    if c.kind == "pe"}

    ops: List[OpKey] = []
    tile_of: Dict[OpKey, Coord] = {}
    for c in sorted(netlist.io_cells, key=lambda c: c.name):
        if c.kind != "io_in":
            continue
        for s in c.signals:
            ops.append(("in", s))
            tile_of[("in", s)] = coords[c.name]
    for c in sorted(netlist.pe_cells, key=lambda c: c.instance):
        ops.append(("pe", c.instance))
        tile_of[("pe", c.instance)] = coords[c.name]

    timing: Dict[str, NetTiming] = {}
    deps: List[DepEdge] = []
    captures: List[CaptureEvent] = []
    routed = {n.name: n for n in routes.nets}
    net_src: Dict[str, OpKey] = {}
    for net in sorted(netlist.nets, key=lambda n: n.name):
        nt = route_timing(routed[net.name])
        timing[net.name] = nt
        if cell_kind[net.driver] == "pe":
            src: OpKey = ("pe", inst_of_cell[net.driver])
        else:
            src = ("in", net.signal)
        net_src[net.name] = src
        for sink in net.sinks:
            d = nt.depth[coords[sink]]
            if cell_kind[sink] == "pe":
                deps.append(DepEdge(src, ("pe", inst_of_cell[sink]), d,
                                    net.signal))
            else:
                captures.append(CaptureEvent(src, net.signal, coords[sink],
                                             d))

    preds: Dict[OpKey, List[DepEdge]] = {op: [] for op in ops}
    succs: Dict[OpKey, List[DepEdge]] = {op: [] for op in ops}
    for e in deps:
        preds[e.dst].append(e)
        succs[e.src].append(e)
    caps_of: Dict[OpKey, List[CaptureEvent]] = {op: [] for op in ops}
    for ev in captures:
        caps_of[ev.producer].append(ev)
    return _Problem(ops, tile_of, deps, captures, preds, succs, caps_of,
                    net_src), timing


def min_ii(netlist: Netlist, routes: RouteResult, spec: FabricSpec,
           placement: Placement) -> Tuple[int, int]:
    """(RecMII, ResMII) lower bounds for any feasible modulo schedule."""
    p, _ = _build_problem(netlist, placement, routes)
    return _min_ii(p, routes, spec)


def _min_ii(p: "_Problem", routes: RouteResult,
            spec: FabricSpec) -> Tuple[int, int]:
    # RecMII: app dataflow graphs are acyclic; verify and refuse otherwise
    order = _topo(p)
    if order is None:
        raise NotImplementedError(
            "modulo scheduling of cyclic (loop-carried) instance graphs "
            "is not supported; application graphs are pure dataflow")
    rec = 1
    # ResMII: every tile issues at most one word per cycle
    per_tile: Dict[Coord, int] = {}
    for op in p.ops:
        t = p.tile_of[op]
        per_tile[t] = per_tile.get(t, 0) + 1
    for ev in p.captures:
        per_tile[ev.tile] = per_tile.get(ev.tile, 0) + 1
    res = max(per_tile.values(), default=1)
    # routed channels: tracks shared beyond capacity would also bound II
    caps = spec.routing_edges()
    for e, u in routes.edge_usage.items():
        res = max(res, -(-u // caps[e]))
    return rec, max(1, res)


def _topo(p: _Problem) -> Optional[List[OpKey]]:
    indeg = {op: 0 for op in p.ops}
    for e in p.deps:
        indeg[e.dst] += 1
    ready = sorted(op for op, k in indeg.items() if k == 0)
    order: List[OpKey] = []
    while ready:
        op = ready.pop(0)
        order.append(op)
        for e in sorted(p.succs[op], key=lambda e: e.dst):
            indeg[e.dst] -= 1
            if indeg[e.dst] == 0:
                ready.append(e.dst)
        ready.sort()
    return order if len(order) == len(p.ops) else None


def _heights(p: _Problem) -> Dict[OpKey, int]:
    """Longest dependence path from each op to any terminal (priority)."""
    order = _topo(p)
    assert order is not None
    h = {op: 0 for op in p.ops}
    for op in reversed(order):
        for e in p.succs[op]:
            h[op] = max(h[op], h[e.dst] + e.hops + L_OUT + L_LATCH)
        for ev in p.caps_of[op]:
            h[op] = max(h[op], ev.hops + L_OUT)
    return h


def modulo_schedule(netlist: Netlist, placement: Placement,
                    routes: RouteResult, spec: FabricSpec,
                    *, max_ii: Optional[int] = None,
                    budget_factor: int = 8) -> ModuloSchedule:
    """Schedule every I/O stream and PE instance under modulo resources.

    Tries II = MII, MII+1, ... with Rau-style scheduling (priority by
    height, bounded eviction budget per II).  Raises
    :class:`repro_torch.errors.BudgetExceeded` (a RuntimeError) when nothing
    fits by ``max_ii`` (default: number of ops + MII, always sufficient
    for a DAG — a finite exhaustion point, so the search is a budget, not
    an open-ended loop).
    """
    p, timing = _build_problem(netlist, placement, routes)
    rec_mii, res_mii = _min_ii(p, routes, spec)
    mii = max(rec_mii, res_mii)
    if max_ii is None:
        max_ii = mii + len(p.ops) + 1
    heights = _heights(p)
    depth = spec.latch_depth

    stats = global_registry().view()
    attempts = 0
    for ii in range(mii, max_ii + 1):
        attempts += 1
        stats["sched_attempts"] += 1
        start = _try_schedule(p, ii, heights, budget_factor, depth,
                              stats=stats)
        if start is not None:
            return _finish(p, timing, ii, rec_mii, res_mii, start, attempts,
                           depth)
    stats["sched_budget_exhausted"] += 1
    raise BudgetExceeded(f"no modulo schedule found up to II={max_ii}",
                         max_ii=max_ii, mii=mii, attempts=attempts,
                         n_ops=len(p.ops), budget_factor=budget_factor)


def fabric_signature(spec: FabricSpec) -> Tuple[int, int, int, int]:
    """Key under which pairs share one lockstep scheduling group.

    Grouping is purely a batching decision — every pair's schedule is
    bit-identical however pairs are grouped (or scheduled solo); sharing
    array dimensions just keeps a round's stacked conflict scans similarly
    sized, so no pair pads the others' windows.
    """
    return (spec.rows, spec.cols, spec.io_capacity, spec.latch_depth)


class _PairSched:
    """Lockstep driver state for one pair in a scheduling group."""

    __slots__ = ("index", "p", "timing", "rec_mii", "res_mii", "heights",
                 "depth", "ii", "max_ii", "attempts", "gen", "req")


def modulo_schedule_batch(items: List[Tuple[Netlist, Placement, RouteResult,
                                            FabricSpec]],
                          *, max_ii: Optional[int] = None,
                          budget_factor: int = 8,
                          stats=None, isolate: bool = False) -> List:
    """Modulo-schedule many placed-and-routed pairs, batch-first.

    Pairs are grouped by :func:`fabric_signature`; within a group every
    pair's Rau coroutine advances in lockstep and ALL pending slot-conflict
    scans are answered by one stacked numpy gather per round
    (:func:`_feasible_scan_batch`), instead of one Python probe-loop per
    candidate cycle per pair.  Each pair's schedule is bit-identical to
    :func:`modulo_schedule` on that pair alone.  ``stats`` (a Counter, if
    given) gets one ``sched_group`` tick per lockstep group.  Returns
    schedules in ``items`` order.

    ``isolate=True`` turns per-pair failures (an unschedulable pair
    exhausting its II budget, a malformed problem) into Exception objects
    at that pair's output index instead of killing the whole group — each
    pair's coroutine trajectory depends only on its own state, so a
    dropped pair cannot change its groupmates' schedules.
    """
    out: List = [None] * len(items)
    groups: Dict[Tuple, List[int]] = {}
    for i, (_, _, _, spec) in enumerate(items):
        groups.setdefault(fabric_signature(spec), []).append(i)
    if stats is None:
        stats = global_registry().view()
    for sig, idxs in groups.items():
        stats["sched_group"] += 1
        with span("schedule.group", fabric="x".join(map(str, sig)),
                  pairs=len(idxs)):
            _schedule_group(items, idxs, out, max_ii, budget_factor,
                            stats=stats, isolate=isolate)
    return out


def _schedule_group(items, idxs: List[int], out: List,
                    max_ii: Optional[int], budget_factor: int,
                    stats=None, isolate: bool = False) -> None:
    pairs: List[_PairSched] = []
    for i in idxs:
        netlist, placement, routes, spec = items[i]
        st = _PairSched()
        st.index = i
        try:
            st.p, st.timing = _build_problem(netlist, placement, routes)
            st.rec_mii, st.res_mii = _min_ii(st.p, routes, spec)
        except Exception as e:
            if not isolate:
                raise
            out[i] = e
            continue
        st.ii = max(st.rec_mii, st.res_mii)
        st.max_ii = (st.ii + len(st.p.ops) + 1) if max_ii is None else max_ii
        st.heights = _heights(st.p)
        st.depth = spec.latch_depth
        st.attempts = 0
        pairs.append(st)

    def start(st: _PairSched) -> bool:
        """Open a new II attempt; True while the pair still wants scans."""
        st.attempts += 1
        if stats is not None:
            stats["sched_attempts"] += 1
        st.gen = _schedule_gen(st.p, st.ii, st.heights, budget_factor,
                               st.depth)
        return advance(st, None)

    def advance(st: _PairSched, ans: Optional[int]) -> bool:
        try:
            st.req = st.gen.send(ans)
            return True
        except StopIteration as stop:
            if stop.value is not None:
                out[st.index] = _finish(st.p, st.timing, st.ii, st.rec_mii,
                                        st.res_mii, stop.value, st.attempts,
                                        st.depth)
                return False
            st.ii += 1                    # this II failed; retry one higher
            if st.ii > st.max_ii:
                if stats is not None:
                    stats["sched_budget_exhausted"] += 1
                raise BudgetExceeded(
                    f"no modulo schedule found up to II={st.max_ii}",
                    max_ii=st.max_ii, mii=max(st.rec_mii, st.res_mii),
                    attempts=st.attempts, n_ops=len(st.p.ops),
                    budget_factor=budget_factor)
            return start(st)

    def safely(st: _PairSched, fn) -> bool:
        """Run start/advance, dropping (not killing) the pair's group
        when isolating — a failed pair's slot gets its exception."""
        try:
            return fn()
        except Exception as e:
            if not isolate:
                raise
            out[st.index] = e
            return False

    active = [st for st in pairs
              if safely(st, lambda st=st: start(st))]
    while active:
        answers = _feasible_scan_batch([st.req for st in active])
        if stats is not None:
            stats["sched_rounds"] += 1
            stats["sched_scans"] += len(answers)
            stats["sched_backtracks"] += sum(1 for a in answers
                                             if a is None)
        active = [st for st, ans in zip(active, answers)
                  if safely(st, lambda st=st, ans=ans: advance(st, ans))]


def _slots_needed(p: _Problem, op: OpKey, t: int,
                  ii: int) -> List[Tuple[Coord, int]]:
    slots = [(p.tile_of[op], t % ii)]
    for ev in p.caps_of[op]:
        slots.append((ev.tile, (t + L_OUT + ev.hops) % ii))
    return slots


@dataclass
class _ScanReq:
    """One first-feasible-slot query against a pair's occupancy table.

    The occupancy array mirrors the MRT dict exactly (``occ[tile, slot]``
    is true iff ``(tile coord, slot)`` is reserved); tiles are indexed by
    the pair-local table the emitting coroutine built.
    """

    occ: np.ndarray              # (n_tiles, ii) bool
    ii: int
    tiles: np.ndarray            # (S,) int64: occ row per required slot
    offs: np.ndarray             # (S,) int64: cycle offset per required slot
    early: int
    hi: int


def _feasible_scan(req: _ScanReq) -> Optional[int]:
    """First t in [early, hi] with every required slot free, else None."""
    if req.hi < req.early:
        return None
    ts = np.arange(req.early, req.hi + 1)
    slots = (ts[:, None] + req.offs[None, :]) % req.ii
    conflict = req.occ[req.tiles[None, :], slots].any(axis=1)
    if conflict.all():
        return None
    return int(req.early + int(np.argmin(conflict)))


def _feasible_scan_batch(reqs: List[_ScanReq]) -> List[Optional[int]]:
    """Answer many scan requests in ONE stacked numpy gather.

    Every pending pair's candidate window is padded to the round's widest
    window and largest slot set; per-pair occupancy tables are flattened
    into one buffer so the whole round is a single fancy-index + reduce
    instead of one Python probe-loop per candidate cycle per pair.
    Answers are identical to :func:`_feasible_scan` per request.
    """
    n = len(reqs)
    width = max(max(r.hi - r.early + 1 for r in reqs), 1)
    n_slots = max(r.tiles.shape[0] for r in reqs)
    sizes = np.asarray([r.occ.size for r in reqs])
    base = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    occ_flat = np.concatenate([r.occ.ravel() for r in reqs])
    ii = np.asarray([r.ii for r in reqs])
    early = np.asarray([r.early for r in reqs])
    hi = np.asarray([r.hi for r in reqs])
    tiles = np.zeros((n, n_slots), np.int64)
    offs = np.zeros((n, n_slots), np.int64)
    smask = np.zeros((n, n_slots), bool)
    for i, r in enumerate(reqs):
        s = r.tiles.shape[0]
        tiles[i, :s] = r.tiles
        offs[i, :s] = r.offs
        smask[i, :s] = True
    ts = early[:, None] + np.arange(width)[None, :]            # (n, W)
    wmask = ts <= hi[:, None]
    slots = (ts[:, :, None] + offs[:, None, :]) % ii[:, None, None]
    idx = (base[:, None, None] + tiles[:, None, :] * ii[:, None, None]
           + slots)                                            # (n, W, S)
    conflict = occ_flat[idx] & smask[:, None, :]
    bad = conflict.any(axis=2) | ~wmask
    out: List[Optional[int]] = []
    for i in range(n):
        w = int(np.argmin(bad[i]))
        out.append(None if bad[i, w] else int(early[i] + w))
    return out


def _schedule_gen(p: _Problem, ii: int, heights: Dict[OpKey, int],
                  budget_factor: int, depth: int
                  ) -> Generator[_ScanReq, Optional[int],
                                 Optional[Dict[OpKey, int]]]:
    """Rau's inner loop as a coroutine: yields slot-conflict scan requests
    (answered with the first feasible cycle, or None) and returns the
    start map — or None when the eviction budget is exhausted.

    Driving it solo (:func:`_try_schedule`) or in lockstep with other
    pairs (:func:`modulo_schedule_batch`) produces identical schedules:
    the trajectory depends only on this pair's own state, never on who
    answers the scans.
    """
    tix: Dict[Coord, int] = {}
    for op in p.ops:
        tix.setdefault(p.tile_of[op], len(tix))
    for ev in p.captures:
        tix.setdefault(ev.tile, len(tix))
    occ = np.zeros((max(1, len(tix)), ii), bool)
    scan_tiles: Dict[OpKey, np.ndarray] = {}
    scan_offs: Dict[OpKey, np.ndarray] = {}
    for op in p.ops:
        caps = p.caps_of[op]
        scan_tiles[op] = np.asarray(
            [tix[p.tile_of[op]]] + [tix[ev.tile] for ev in caps], np.int64)
        scan_offs[op] = np.asarray(
            [0] + [L_OUT + ev.hops for ev in caps], np.int64)

    time: Dict[OpKey, int] = {}
    mrt: Dict[Tuple[Coord, int], OpKey] = {}
    order_ix = {op: i for i, op in enumerate(p.ops)}
    heap: List[Tuple[int, int, OpKey]] = []
    for op in p.ops:
        heapq.heappush(heap, (-heights[op], order_ix[op], op))
    last_placed: Dict[OpKey, int] = {}
    budget = budget_factor * len(p.ops) + 64
    hold = depth * ii

    def occupy(op: OpKey, t: int) -> None:
        time[op] = t
        for s in _slots_needed(p, op, t, ii):
            mrt[s] = op
            occ[tix[s[0]], s[1]] = True
        last_placed[op] = t

    def unschedule(op: OpKey) -> None:
        t = time.pop(op)
        for slot in _slots_needed(p, op, t, ii):
            if mrt.get(slot) == op:
                del mrt[slot]
                occ[tix[slot[0]], slot[1]] = False
        heapq.heappush(heap, (-heights[op], order_ix[op], op))

    while heap:
        _, _, op = heapq.heappop(heap)
        if op in time:
            continue                      # stale heap entry
        # dependence window w.r.t. already-scheduled neighbors
        early, late = 0, 1 << 30
        for e in p.preds[op]:
            if e.src in time:
                arr = time[e.src] + L_OUT + e.hops
                early = max(early, arr + L_LATCH)
                late = min(late, arr + hold)
        for e in p.succs[op]:
            if e.dst in time:
                # consumer window: arr + L_LATCH <= t_dst <= arr + hold
                early = max(early, time[e.dst] - e.hops - L_OUT - hold)
                late = min(late, time[e.dst] - e.hops - L_OUT - L_LATCH)
        early = max(early, 0)

        t = yield _ScanReq(occ, ii, scan_tiles[op], scan_offs[op],
                           early, min(late, early + ii - 1))
        if t is not None:
            occupy(op, t)
            continue

        # forced placement with eviction (Rau)
        budget -= 1
        if budget <= 0:
            return None
        t = max(early, last_placed.get(op, -1) + 1)
        evict: Set[OpKey] = set()
        for s in _slots_needed(p, op, t, ii):
            if s in mrt:
                evict.add(mrt[s])
        for e in p.preds[op]:
            if e.src in time:
                arr = time[e.src] + L_OUT + e.hops
                if not (arr + L_LATCH <= t <= arr + hold):
                    evict.add(e.src)
        for e in p.succs[op]:
            if e.dst in time:
                arr = t + L_OUT + e.hops
                if not (arr + L_LATCH <= time[e.dst] <= arr + hold):
                    evict.add(e.dst)
        for other in sorted(evict, key=lambda o: order_ix[o]):
            unschedule(other)
        occupy(op, t)
    return time


def _try_schedule(p: _Problem, ii: int, heights: Dict[OpKey, int],
                  budget_factor: int, depth: int, *, stats=None
                  ) -> Optional[Dict[OpKey, int]]:
    """Drive one pair's scheduling coroutine solo."""
    gen = _schedule_gen(p, ii, heights, budget_factor, depth)
    ans: Optional[int] = None
    while True:
        try:
            req = gen.send(ans)
        except StopIteration as stop:
            return stop.value
        ans = _feasible_scan(req)
        if stats is not None:
            stats["sched_rounds"] += 1
            stats["sched_scans"] += 1
            if ans is None:
                stats["sched_backtracks"] += 1


def _finish(p: _Problem, timing: Dict[str, NetTiming], ii: int,
            rec_mii: int, res_mii: int, start: Dict[OpKey, int],
            attempts: int, depth: int) -> ModuloSchedule:
    capture: Dict[int, int] = {}
    latest = 0
    for ev in p.captures:
        capture[ev.signal] = start[ev.producer] + L_OUT + ev.hops
        latest = max(latest, capture[ev.signal])
    for op, t in start.items():
        latest = max(latest, t)
    hop_time: Dict[Tuple[str, Coord], int] = {}
    for net_name, nt in sorted(timing.items()):
        src = p.net_src[net_name]
        for tile, d in sorted(nt.depth.items()):
            if tile != nt.driver:
                hop_time[(net_name, tile)] = start[src] + L_OUT + d
    sched = ModuloSchedule(ii=ii, rec_mii=rec_mii, res_mii=res_mii,
                           start=dict(sorted(start.items())),
                           capture=capture, latency=latest + 1,
                           attempts=attempts, hop_time=hop_time,
                           latch_depth=depth, net_timing=dict(timing),
                           net_src=dict(p.net_src))
    _check(p, sched)
    return sched


def _check(p: _Problem, s: ModuloSchedule) -> None:
    """Assert the invariants the simulator relies on."""
    hold = s.latch_depth * s.ii
    for e in p.deps:
        arr = s.start[e.src] + L_OUT + e.hops
        t = s.start[e.dst]
        if not (arr + L_LATCH <= t <= arr + hold):
            raise AssertionError(
                f"dependence window violated: {e.src}->{e.dst} "
                f"arr={arr} t={t} II={s.ii} depth={s.latch_depth}")
    mrt: Dict[Tuple[Coord, int], OpKey] = {}
    for op, t in s.start.items():
        for slot in _slots_needed(p, op, t, s.ii):
            if slot in mrt:
                raise AssertionError(f"modulo resource conflict at {slot}: "
                                     f"{mrt[slot]} vs {op}")
            mrt[slot] = op
