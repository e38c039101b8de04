"""Cycle-accurate functional simulator of a scheduled CGRA array.

Executes a placed, routed, modulo-scheduled mapping over time: every tile
runs in lockstep, one step per clock cycle, with the whole machine state
held in dense arrays.  The cycle loop of a whole bucket of programs runs
in one launch of the cycle-stepper kernel K3
(:func:`repro_torch.kernels.sim_step.simulate_batch_stepper`) on the
card, or in its plain PyTorch version on the CPU.

Machine model (the register set the scheduler's arithmetic assumes —
see :mod:`repro_torch.sim.schedule`):

* ``ext``   — one streaming register per array input signal, refreshed with
  the next iteration's word every II cycles by its io_in tile;
* ``sig``   — one output register per PE-produced signal, loaded when the
  producing instance fires;
* ``wire``  — one pipeline register per (net, tile) hop of every routed
  tree (per-track: nets sharing a channel keep separate registers), shifted
  unconditionally every cycle — a value physically ripples down its route;
* ``latch`` — one input FIFO per (consumer tile, signal),
  ``spec.latch_depth`` iterations deep, capturing the arriving word the
  cycle it lands (slot = iteration mod depth) while the consumer reads the
  slot of the iteration it is executing — operand skew up to
  ``depth x II`` survives, exactly what the scheduler assumed;
* ``tmp``   — combinational values inside a firing tile: each instance's
  covered app nodes execute as a short micro-op program (topological order,
  at most ``n_steps`` per tile), all tiles dispatching their step-``u``
  opcode simultaneously through :mod:`repro_torch.kernels.sim_step`.

Because instances execute the *application* nodes they cover (not the
merged-PE pattern — the datapath validator already proved those equal),
simulated outputs must bit-match :func:`repro_torch.graphir.interp.interpret`
whenever the op set is IEEE-exact, which is the entire paper suite.  A
mismatch means the mapping, placement, routing, or schedule is wrong —
this simulator is the end-to-end correctness oracle the static pipeline
never had.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.mapper import Mapping
from ..graphir.graph import Graph
from ..graphir.ops import OPS
from ..fabric.netlist import Netlist
from ..fabric.place import Placement
from ..kernels.sim_step import TABLES
from .schedule import ModuloSchedule

_ARITY_PAD = 3


@dataclass
class SimProgram:
    """A scheduled design lowered to the dense arrays the stepper consumes."""

    app_name: str
    ii: int
    latency: int
    n_inst: int
    n_steps: int                      # micro-ops per tile (padded)
    ops: Tuple[str, ...]              # opcode table (0 = nop)
    # tile micro-code
    opcodes: np.ndarray               # (n_inst, n_steps) int32
    op_src: np.ndarray                # (n_inst, n_steps, 3) int32 (operand ix)
    # operand space = [latch | const | tmp]
    n_latch: int
    n_const: int
    const_pool: np.ndarray            # (n_const,) float32
    # schedule times
    fire_time: np.ndarray             # (n_inst,) int32
    ext_time: np.ndarray              # (n_ext,) int32
    # wires: src space = [sig | ext | wire]
    n_sig: int
    n_ext: int
    n_wire: int
    wire_src: np.ndarray              # (n_wire,) int32
    # producers
    sig_tmp: np.ndarray               # (n_sig,) int32 into tmp-flat
    sig_owner: np.ndarray             # (n_sig,) int32 instance index
    # latches
    latch_wire: np.ndarray            # (n_latch,) int32 wire index
    latch_time: np.ndarray            # (n_latch,) int32 first capture cycle
    latch_owner: np.ndarray           # (n_latch,) int32 consumer instance
    latch_depth: int                  # FIFO slots per latch
    # outputs
    out_wire: np.ndarray              # (n_out,) int32 wire index
    out_time: np.ndarray              # (n_out,) int32 first capture cycle
    out_cols: List[int]               # graph.outputs -> capture column
    input_names: List[str]            # per ext index
    schedule: ModuloSchedule = None

    @property
    def n_out(self) -> int:
        return len(self.out_wire)

    def total_cycles(self, iterations: int) -> int:
        return self.latency + (iterations - 1) * self.ii

    def summary(self) -> str:
        return (f"SimProgram[{self.app_name}: II={self.ii} "
                f"latency={self.latency} tiles={self.n_inst} "
                f"steps={self.n_steps} wires={self.n_wire} "
                f"latches={self.n_latch}]")


def check_cycle_budget(prog: SimProgram, iterations: int,
                       max_cycles: Optional[int], *,
                       metrics=None) -> None:
    """Refuse (pre-dispatch) to simulate a program over its cycle cap.

    Raises :class:`repro_torch.errors.BudgetExceeded` when ``max_cycles`` is
    set and ``prog.total_cycles(iterations)`` exceeds it — checked before
    any kernel launches, so an over-budget program degrades to a structured
    failure instead of burning the budget it already exceeds.  No-op when
    ``max_cycles`` is None (the default).
    """
    if max_cycles is None:
        return
    total = prog.total_cycles(iterations)
    if total > max_cycles:
        if metrics is not None:
            metrics.inc("sim.budget_exhausted")
        from ..errors import BudgetExceeded
        raise BudgetExceeded(
            f"simulation of {prog.app_name} needs {total} cycles "
            f"(> sim_max_cycles={max_cycles})",
            total_cycles=total, max_cycles=max_cycles,
            iterations=iterations, ii=prog.ii, latency=prog.latency)


@dataclass
class SimResult:
    outputs: np.ndarray               # (B, K, n_graph_outputs) float32
    ii: int
    min_ii: int
    latency: int
    cycles: int
    iterations: int
    n_fires: int                      # PE invocations actually issued
    active_frac: float                # fires / (cycles * tiles)
    backend: str

    def throughput_ops_per_cycle(self, total_ops: int) -> float:
        return total_ops / self.ii


def lower_program(mapping: Mapping, app: Graph, netlist: Netlist,
                  placement: Placement,
                  schedule: ModuloSchedule) -> SimProgram:
    """Lower a scheduled design into a :class:`SimProgram`.

    Route timing comes from the schedule itself
    (:attr:`ModuloSchedule.net_timing` / ``hop_time``), so the simulator
    executes exactly the register chains the scheduler reasoned about.
    """
    if mapping.unmapped:
        raise ValueError(f"cannot simulate: unmapped nodes {mapping.unmapped}")
    if mapping.offloaded:
        raise NotImplementedError(
            "time-domain simulation requires fully PE-mapped graphs "
            f"(offloaded macros: {mapping.offloaded})")

    from ..kernels.sim_step import op_table

    coords = placement.coords
    cell_kind = {name: c.kind for name, c in netlist.cells.items()}
    inst_of_cell = {name: c.instance for name, c in netlist.cells.items()
                    if c.kind == "pe"}

    # -- signal spaces ------------------------------------------------------
    ext_sigs: List[int] = []
    for c in sorted(netlist.io_cells, key=lambda c: c.name):
        if c.kind == "io_in":
            ext_sigs.extend(c.signals)
    ext_sigs.sort()
    ext_ix = {s: i for i, s in enumerate(ext_sigs)}
    pe_sigs = sorted(n.signal for n in netlist.nets
                     if cell_kind[n.driver] == "pe")
    sig_ix = {s: i for i, s in enumerate(pe_sigs)}
    n_sig, n_ext = len(pe_sigs), len(ext_sigs)

    # -- wires: one register per (net, non-driver tile), timed exactly as
    # the scheduler published (ModuloSchedule.net_timing/net_src) ----------
    wire_ix: Dict[Tuple[str, Tuple[int, int]], int] = {}
    wire_src: List[int] = []
    timings = schedule.net_timing
    for net in sorted(netlist.nets, key=lambda n: n.name):
        nt = timings[net.name]
        drv_src = (sig_ix[net.signal]
                   if schedule.net_src[net.name][0] == "pe"
                   else n_sig + ext_ix[net.signal])
        for tile in sorted(nt.depth, key=lambda t: (nt.depth[t], t)):
            if tile == nt.driver:
                continue
            wire_ix[(net.name, tile)] = len(wire_src)
            parent = nt.parent[tile]
            if parent == nt.driver:
                wire_src.append(drv_src)
            else:
                wire_src.append(n_sig + n_ext
                                + wire_ix[(net.name, parent)])
    n_wire = len(wire_src)

    # -- latches: one per (consumer pe cell, signal) ------------------------
    latch_ix: Dict[Tuple[str, int], int] = {}
    latch_wire: List[int] = []
    latch_time: List[int] = []
    latch_owner: List[int] = []
    for net in sorted(netlist.nets, key=lambda n: n.name):
        nt = timings[net.name]
        for sink in net.sinks:
            if cell_kind[sink] != "pe":
                continue
            tile = coords[sink]
            latch_ix[(sink, net.signal)] = len(latch_wire)
            latch_wire.append(wire_ix[(net.name, tile)])
            latch_time.append(schedule.hop_time[(net.name, tile)])
            latch_owner.append(inst_of_cell[sink])
    n_latch = len(latch_wire)

    # -- constants -----------------------------------------------------------
    const_nodes = sorted(n for n, op in app.nodes.items() if op == "const")
    const_ix = {n: i for i, n in enumerate(const_nodes)}
    const_pool = np.asarray([float(app.attr(n, "value", 0.0))
                             for n in const_nodes], np.float32)
    n_const = len(const_nodes)

    # -- per-instance micro-code --------------------------------------------
    topo_pos = {n: i for i, n in enumerate(app.topo_order())}
    n_inst = mapping.n_pes
    per_inst_nodes = [sorted(inst.covered, key=topo_pos.get)
                      for inst in mapping.instances]
    n_steps = max((len(ns) for ns in per_inst_nodes), default=1)
    used_ops = sorted({app.nodes[n] for ns in per_inst_nodes for n in ns})
    ops = op_table(used_ops)
    code_of = {name: k for k, name in enumerate(ops)}

    def operand(i: int, tmp_of: Dict[int, int], cell: str,
                node: int, port: int) -> int:
        src = app.in_edges(node)[port]
        if src in tmp_of:
            return n_latch + n_const + i * n_steps + tmp_of[src]
        op = app.nodes[src]
        if op == "const":
            return n_latch + const_ix[src]
        # external operand (graph input or another tile's value)
        if (cell, src) not in latch_ix:
            raise AssertionError(
                f"no latch for signal {src} at {cell}: netlist/route mismatch")
        return latch_ix[(cell, src)]

    opcodes = np.zeros((n_inst, n_steps), np.int32)
    op_src = np.zeros((n_inst, n_steps, _ARITY_PAD), np.int32)
    for i, nodes in enumerate(per_inst_nodes):
        cell = f"pe{i}"
        tmp_of: Dict[int, int] = {}
        for u, node in enumerate(nodes):
            op = app.nodes[node]
            opcodes[i, u] = code_of[op]
            for port in range(OPS[op].arity):
                op_src[i, u, port] = operand(i, tmp_of, cell, node, port)
            tmp_of[node] = u

    # -- producers -----------------------------------------------------------
    sig_tmp = np.zeros((n_sig,), np.int32)
    sig_owner = np.zeros((n_sig,), np.int32)
    home = {}
    for i, inst in enumerate(mapping.instances):
        for n in inst.covered:
            home[n] = i
    for s, ix in sig_ix.items():
        i = home[s]
        sig_owner[ix] = i
        sig_tmp[ix] = i * n_steps + per_inst_nodes[i].index(s)

    # -- schedule times ------------------------------------------------------
    fire_time = np.asarray([schedule.start[("pe", i)]
                            for i in range(n_inst)], np.int32)
    ext_time = np.asarray([schedule.start[("in", s)] for s in ext_sigs],
                          np.int32)

    # -- output captures ----------------------------------------------------
    out_wire: List[int] = []
    out_time: List[int] = []
    cap_col: Dict[int, int] = {}
    for net in sorted(netlist.nets, key=lambda n: n.name):
        for sink in net.sinks:
            if cell_kind[sink] != "io_out":
                continue
            cap_col[net.signal] = len(out_wire)
            out_wire.append(wire_ix[(net.name, coords[sink])])
            out_time.append(schedule.hop_time[(net.name, coords[sink])])
    missing = [o for o in app.outputs if o not in cap_col]
    if missing:
        raise ValueError(f"graph outputs with no io_out capture: {missing} "
                         "(pass-through inputs/consts are not simulable)")
    out_cols = [cap_col[o] for o in app.outputs]

    input_names = [str(app.attr(s, "name", f"in{s}")) for s in ext_sigs]
    return SimProgram(
        app_name=mapping.app_name, ii=schedule.ii, latency=schedule.latency,
        n_inst=n_inst, n_steps=n_steps, ops=ops,
        opcodes=opcodes, op_src=op_src,
        n_latch=n_latch, n_const=n_const, const_pool=const_pool,
        fire_time=fire_time, ext_time=ext_time,
        n_sig=n_sig, n_ext=n_ext, n_wire=n_wire,
        wire_src=np.asarray(wire_src, np.int32),
        sig_tmp=sig_tmp, sig_owner=sig_owner,
        latch_wire=np.asarray(latch_wire, np.int32),
        latch_time=np.asarray(latch_time, np.int32),
        latch_owner=np.asarray(latch_owner, np.int32),
        latch_depth=schedule.latch_depth,
        out_wire=np.asarray(out_wire, np.int32),
        out_time=np.asarray(out_time, np.int32),
        out_cols=out_cols, input_names=input_names, schedule=schedule)


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------
def _coerce_inputs(prog: SimProgram, inputs) -> np.ndarray:
    """Normalize to (B, K, n_ext) float32 in ext-signal order."""
    if isinstance(inputs, dict):
        cols = []
        for name in prog.input_names:
            if name not in inputs:
                raise KeyError(f"missing input {name!r}")
            cols.append(np.asarray(inputs[name], np.float32))
        arr = np.stack(cols, axis=-1)
    else:
        arr = np.asarray(inputs, np.float32)
    if arr.ndim == 2:
        arr = arr[None]
    if arr.ndim != 3 or arr.shape[-1] != prog.n_ext:
        raise ValueError(f"inputs must be (B, K, {prog.n_ext}); "
                         f"got {arr.shape}")
    return arr



# ---------------------------------------------------------------------------
# cross-program batching: many (variant, app) simulations in one dispatch
# ---------------------------------------------------------------------------
#: sentinel start time for padded periodic events — they never fire
_NEVER = 1 << 30


#: per-dimension lower bounds for the bucket key, sized so the programs a
#: 16x16-class array typically produces all land in ONE bucket: dispatch
#: count — not padded-lane arithmetic — dominates wall clock on a sweep,
#: so small programs trade padding for sharing one launch.  Floors
#: are static constants, so a program's bucket (and therefore its padded
#: lowering and outputs) still depends only on the program itself.
_SIG_FLOORS = (64, 4, 32, 64, 512, 64, 32, 1, 256)


def sim_signature(prog: SimProgram, iterations: int,
                  batch: int) -> Tuple[int, ...]:
    """Static shape key two programs must share to ride one launch.

    Every dimension pads to its power-of-two bucket
    (:func:`repro_torch.kernels.tiling.pow2_bucket`), floored by
    :data:`_SIG_FLOORS` — tiles, micro-op steps, I/O streams,
    signal/wire/latch registers, output captures, and the total cycle
    count — so the key (and therefore both the launch shapes and a
    program's simulated outputs) depends only on the program itself,
    never on its groupmates.
    """
    from ..kernels.tiling import pow2_bucket as b

    dims = (prog.n_inst, prog.n_steps, prog.n_ext, prog.n_sig, prog.n_wire,
            prog.n_latch, prog.n_const, prog.n_out,
            prog.total_cycles(iterations))
    return tuple(max(b(d), f) for d, f in zip(dims, _SIG_FLOORS)) \
        + (prog.latch_depth, iterations, batch)


def _pad_program(prog: SimProgram, sig: Tuple[int, ...],
                 code_of: Dict[str, int]) -> Dict[str, np.ndarray]:
    """Lower one program onto the bucket shapes of ``sig``.

    Operand/wire indices are remapped into the padded address spaces,
    opcodes into the group's shared table; padded periodic events start at
    ``_NEVER`` so they never fire, and padded register slots are only ever
    read by other padding (real index tables reference real entries only).
    """
    ip, up, ep, sp, wp, lp, cp, op_, _, _, _, _ = sig
    n_l, n_c, n_s = prog.n_latch, prog.n_const, prog.n_steps

    lut = np.asarray([code_of[name] for name in prog.ops], np.int32)
    opcodes = np.zeros((ip, up), np.int32)
    opcodes[:prog.n_inst, :n_s] = lut[prog.opcodes]

    # operand space [latch | const | tmp] -> [latch(lp) | const(cp) | tmp]
    v = prog.op_src
    tmp_off = v - n_l - n_c
    remapped = np.where(
        v < n_l, v,
        np.where(v < n_l + n_c, lp + (v - n_l),
                 lp + cp + (tmp_off // n_s) * up + tmp_off % n_s))
    op_src = np.zeros((ip, up, _ARITY_PAD), np.int32)
    op_src[:prog.n_inst, :n_s] = remapped

    # wire sources [sig | ext | wire] -> [sig(sp) | ext(ep) | wire]
    w = prog.wire_src
    wire_src = np.zeros((wp,), np.int32)
    wire_src[:prog.n_wire] = np.where(
        w < prog.n_sig, w,
        np.where(w < prog.n_sig + prog.n_ext, sp + (w - prog.n_sig),
                 sp + ep + (w - prog.n_sig - prog.n_ext)))

    sig_tmp = np.zeros((sp,), np.int32)
    sig_tmp[:prog.n_sig] = ((prog.sig_tmp // n_s) * up + prog.sig_tmp % n_s)
    sig_owner = np.zeros((sp,), np.int32)   # padded sigs may latch tile 0's
    sig_owner[:prog.n_sig] = prog.sig_owner  # value; nothing ever reads them

    def pad_time(src: np.ndarray, n: int) -> np.ndarray:
        out = np.full((n,), _NEVER, np.int32)
        out[:src.shape[0]] = src
        return out

    def pad_ix(src: np.ndarray, n: int) -> np.ndarray:
        out = np.zeros((n,), np.int32)
        out[:src.shape[0]] = src
        return out

    const_pool = np.zeros((cp,), np.float32)
    const_pool[:n_c] = prog.const_pool
    return dict(
        ii=np.int32(prog.ii),
        dims=np.asarray([n_s, prog.n_inst], np.int32),
        opcodes=opcodes, op_src=op_src, const_pool=const_pool,
        fire_time=pad_time(prog.fire_time, ip),
        ext_time=pad_time(prog.ext_time, ep),
        wire_src=wire_src, sig_tmp=sig_tmp, sig_owner=sig_owner,
        latch_wire=pad_ix(prog.latch_wire, lp),
        latch_time=pad_time(prog.latch_time, lp),
        latch_owner=pad_ix(prog.latch_owner, lp),
        out_wire=pad_ix(prog.out_wire, op_),
        out_time=pad_time(prog.out_time, op_))


#: field order of the stacked arrays fed to the batched stepper
_BATCH_FIELDS = TABLES




def bucket_tensors(progs: List[SimProgram], arrs: List[np.ndarray],
                   sig: Tuple[int, ...], device):
    """The stepper's arguments for ``progs`` padded onto the bucket ``sig``
    with input sets ``arrs`` ((B, K, n_ext) each): ``(tables, inputs,
    op_ids)`` on ``device``."""
    import torch

    from ..kernels.sim_step import kernel_op_ids, op_table

    ops = op_table(sorted(set().union(*(p.ops for p in progs)) - {"nop"}))
    code_of = {name: k for k, name in enumerate(ops)}
    padded = [_pad_program(p, sig, code_of) for p in progs]
    tables = {k: torch.from_numpy(np.stack([d[k] for d in padded])).to(
        device) for k in _BATCH_FIELDS}
    B, K = arrs[0].shape[:2]
    inputs = np.zeros((len(progs), B, K, sig[2]), np.float32)
    for i, (p, a) in enumerate(zip(progs, arrs)):
        inputs[i, :, :, :p.n_ext] = a
    op_ids = torch.tensor(kernel_op_ids(ops), dtype=torch.int32)
    return tables, torch.from_numpy(inputs).to(device), op_ids.to(device)


def _run_bucket(progs: List[SimProgram], arrs: List[np.ndarray],
                sig: Tuple[int, ...], device) -> np.ndarray:
    """Run every cycle of ``progs`` on the bucket ``sig`` in one launch of
    the stepper on ``device``; the captured outputs (G, B, K, op) on the
    host."""
    from ..device import resolve_device
    from ..kernels.sim_step import simulate_batch_stepper

    tables, inputs, op_ids = bucket_tensors(progs, arrs, sig,
                                            resolve_device(device))
    out = simulate_batch_stepper(tables, inputs, op_ids, cycles=sig[8],
                                 latch_depth=sig[9])
    return out.cpu().numpy()


def simulate_batch(progs: List[SimProgram], inputs_list,
                   *, backend: str = "jax", metrics=None,
                   device="cuda") -> List[SimResult]:
    """Simulate many programs in ONE launch of the cycle stepper.

    All programs must share one :func:`sim_signature` (group by it first)
    and all input sets one (batch, iterations) shape; the union of the
    group's opcode tables drives one shared ALU dispatch.  Cycles beyond a
    program's real count execute harmlessly (no capture fires past
    iteration K-1), padded events never fire, and padded lanes retire
    zeros — so per-program outputs are bit-identical to :func:`simulate`
    on that program alone, regardless of which programs share the
    dispatch.  ``backend`` keeps the JAX package's name of the batched
    path ("jax"); ``device`` is where the stepper runs ("cuda" by
    default: kernel K3; "cpu": its plain version).

    Bucket provenance lands in ``metrics`` (default: the global registry):
    one ``sim.dispatch`` tick plus ``sim.bucket_programs`` /
    ``sim.bucket_cycles`` histogram observations per call, and the
    dispatch runs under a ``sim.dispatch`` span naming the bucket.
    """
    from ..obs import span
    from ..obs.metrics import global_registry

    if backend != "jax":
        raise ValueError("simulate_batch supports backend='jax' only "
                         "(the JAX package's pallas backend is per-program)")
    if len(progs) != len(inputs_list):
        raise ValueError("inputs_list must match progs 1:1")
    arrs = [_coerce_inputs(p, x) for p, x in zip(progs, inputs_list)]
    B, K, _ = arrs[0].shape
    for a in arrs:
        if a.shape[:2] != (B, K):
            raise ValueError("all input sets must share one (B, K) shape; "
                             f"got {a.shape[:2]} vs {(B, K)}")
    sigs = {sim_signature(p, K, B) for p in progs}
    if len(sigs) != 1:
        raise ValueError(f"programs span {len(sigs)} sim signatures; "
                         "group by sim_signature() first")
    sig = next(iter(sigs))

    reg = metrics if metrics is not None else global_registry()
    reg.inc("sim.dispatch")
    reg.observe("sim.bucket_programs", len(progs))
    reg.observe("sim.bucket_cycles", sig[8])

    with span("sim.dispatch", bucket="x".join(str(d) for d in sig),
              programs=len(progs)):
        outbuf = _run_bucket(progs, arrs, sig, device)

    results = []
    for i, p in enumerate(progs):
        cycles = p.total_cycles(K)
        n_fires = K * p.n_inst
        results.append(SimResult(
            outputs=outbuf[i][:, :, p.out_cols], ii=p.ii,
            min_ii=p.schedule.min_ii, latency=p.latency, cycles=cycles,
            iterations=K, n_fires=n_fires,
            active_frac=n_fires / max(1, cycles * p.n_inst),
            backend="jax-batch"))
    return results


def simulate(prog: SimProgram, inputs, *, backend: str = "jax",
             device="cuda") -> SimResult:
    """Run `prog` over `inputs` and return per-iteration outputs.

    inputs: dict name -> (K,) or (B, K) arrays, or an (B, K, n_ext) /
    (K, n_ext) array in ext-signal order.  K = loop iterations; new
    iterations are issued every II cycles (software pipelining), so the
    run itself verifies the modulo schedule is hazard-free.

    The program runs as a group of one, padded to its own
    :func:`sim_signature`, through the same stepper as
    :func:`simulate_batch` on ``device``, so its outputs equal the batched
    ones.  ``backend`` names the JAX package's tile-step dispatch ("jax" or
    "pallas"); both select the same kernel here and the name is kept in
    :attr:`SimResult.backend`.
    """
    if backend not in ("jax", "pallas"):
        raise ValueError(f"unknown sim backend {backend!r} (jax | pallas)")
    arr = _coerce_inputs(prog, inputs)
    B, K, _ = arr.shape
    outbuf = _run_bucket([prog], [arr], sim_signature(prog, K, B), device)
    n_fires = K * prog.n_inst
    cycles = prog.total_cycles(K)
    return SimResult(
        outputs=outbuf[0][:, :, prog.out_cols], ii=prog.ii,
        min_ii=prog.schedule.min_ii, latency=prog.latency, cycles=cycles,
        iterations=K, n_fires=n_fires,
        active_frac=n_fires / max(1, cycles * prog.n_inst),
        backend=backend)
