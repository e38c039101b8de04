"""Golden verification: the simulated array must bit-match the interpreter.

The static pipeline proves merged datapaths correct per-config
(core/merge validation); nothing before this subsystem proved that the
*composition* — cover, placement, routing, modulo schedule — still computes
the application.  :func:`verify_mapping` closes that loop: it runs the full
time-domain flow on random inputs and compares, bit for bit, against
:func:`repro_torch.graphir.interp.interpret`.

All paper-suite apps use IEEE-exact ops (add/sub/mul/shift/compare/
min/max/select), so float32 equality is exact, not approximate: any
nonzero error is a real bug somewhere in the stack.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.mapper import Mapping
from ..core.pe import Datapath
from ..graphir.graph import Graph
from ..graphir.interp import interpret
from ..fabric import FabricSpec, PnRResult, place_and_route
from .cycle import SimProgram, SimResult, lower_program, simulate
from .schedule import modulo_schedule


def build_sim(dp: Datapath, mapping: Mapping, app: Graph,
              spec: Optional[FabricSpec] = None, *,
              place_backend: str = "jax", chains: int = 8,
              sweeps: int = 24, seed: int = 0,
              hpwl_backend: str = "jnp",
              pnr: Optional[PnRResult] = None,
              max_ii: Optional[int] = None,
              budget_factor: int = 8, device="cuda"
              ) -> Tuple[SimProgram, PnRResult]:
    """Place, route, schedule, and lower a mapping into a SimProgram.

    ``max_ii`` / ``budget_factor`` bound the scheduler's II search and
    eviction budget (:func:`repro_torch.sim.schedule.modulo_schedule`); on
    exhaustion the scheduler raises
    :class:`repro_torch.errors.BudgetExceeded`.  Without ``pnr`` the
    placement anneals on ``device``.
    """
    if pnr is None:
        pnr = place_and_route(dp, mapping, app, spec,
                              backend=place_backend, chains=chains,
                              sweeps=sweeps, seed=seed,
                              hpwl_backend=hpwl_backend, device=device)
    sched = modulo_schedule(pnr.netlist, pnr.placement, pnr.routes,
                            pnr.spec, max_ii=max_ii,
                            budget_factor=budget_factor)
    prog = lower_program(mapping, app, pnr.netlist, pnr.placement, sched)
    return prog, pnr


@dataclass
class GoldenReport:
    app: str
    ok: bool
    bit_exact: bool
    max_abs_err: float
    ii: int
    min_ii: int
    latency: int
    iterations: int
    batch: int
    n_outputs: int

    def row(self) -> str:
        status = "BIT-EXACT" if self.bit_exact else (
            "ok" if self.ok else "MISMATCH")
        return (f"{self.app:<16} II={self.ii:<3d} (min {self.min_ii}) "
                f"lat={self.latency:<4d} outs={self.n_outputs:<3d} "
                f"iters={self.iterations}x{self.batch} "
                f"err={self.max_abs_err:.3e} {status}")


def random_inputs(prog: SimProgram, iterations: int, batch: int,
                  seed: int = 0, lo: float = 0.0, hi: float = 256.0
                  ) -> np.ndarray:
    """(B, K, n_ext) float32 pixel-range test vectors."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(lo, hi, (batch, iterations, prog.n_ext))
    return np.round(vals).astype(np.float32)   # integral: exact in f32


def build_sim_batch(items, *, stats=None, max_ii: Optional[int] = None,
                    budget_factor: int = 8, isolate: bool = False) -> list:
    """Schedule and lower many placed-and-routed pairs, batch-first.

    ``items``: one ``(dp, mapping, app, pnr)`` per pair.  Modulo
    scheduling runs through
    :func:`repro_torch.sim.schedule.modulo_schedule_batch` (one lockstep
    conflict-scan group per fabric signature); lowering stays per-pair
    (cheap Python).  Returns :class:`SimProgram` objects in ``items``
    order, bit-identical to ``build_sim(..., pnr=pnr)[0]`` per pair.

    ``isolate=True``: a failing pair (fault-injection site ``schedule``,
    an exhausted II budget, a lowering error) yields the Exception object
    at its index instead of killing the batch; groupmates' schedules are
    unaffected (each pair's coroutine trajectory is its own).
    """
    from .. import faultinject
    from .schedule import modulo_schedule_batch

    n = len(items)
    failed: dict = {}
    todo = []                        # indices still scheduling
    for i, (_, mapping, _, _) in enumerate(items):
        try:
            faultinject.fire("schedule", app=mapping.app_name)
            todo.append(i)
        except Exception as e:
            if not isolate:
                raise
            failed[i] = e
    scheds = modulo_schedule_batch(
        [(items[i][3].netlist, items[i][3].placement, items[i][3].routes,
          items[i][3].spec) for i in todo],
        stats=stats, max_ii=max_ii, budget_factor=budget_factor,
        isolate=isolate)
    out: list = [None] * n
    for i, sched in zip(todo, scheds):
        _, mapping, app, pnr = items[i]
        if isinstance(sched, Exception):
            out[i] = sched
            continue
        try:
            out[i] = lower_program(mapping, app, pnr.netlist,
                                   pnr.placement, sched)
        except Exception as e:
            if not isolate:
                raise
            out[i] = e
    for i, e in failed.items():
        out[i] = e
    return out


def compare_with_interp(prog: SimProgram, app: Graph, inputs: np.ndarray,
                        res: SimResult) -> Tuple[float, bool]:
    """(max |err| vs interpreter, bit-exact?) for a precomputed result."""
    B, K, _ = inputs.shape
    feed: Dict[str, np.ndarray] = {
        name: inputs[:, :, j].reshape(-1)
        for j, name in enumerate(prog.input_names)}
    # inputs the computation never consumes don't reach the array; the
    # interpreter still wants a value for their dangling input nodes
    for n, op in app.nodes.items():
        if op == "input":
            feed.setdefault(str(app.attr(n, "name")),
                            np.zeros(B * K, np.float32))
    want = interpret(app, feed)
    err = 0.0
    exact = True
    for j in range(len(app.outputs)):
        got = res.outputs[:, :, j].reshape(-1)
        expect = np.asarray(want[j], np.float32)
        exact = exact and np.array_equal(got, expect)
        err = max(err, float(np.max(np.abs(got - expect), initial=0.0)))
    return err, exact


def check_against_interp(prog: SimProgram, app: Graph,
                         inputs: np.ndarray, *, backend: str = "jax",
                         device="cuda") -> Tuple[SimResult, float, bool]:
    """(sim result, max |err| vs interpreter, bit-exact?); the simulation
    runs on ``device``."""
    res = simulate(prog, inputs, backend=backend, device=device)
    err, exact = compare_with_interp(prog, app, inputs, res)
    return res, err, exact


def verify_mapping(dp: Datapath, mapping: Mapping, app: Graph,
                   spec: Optional[FabricSpec] = None, *,
                   iterations: int = 3, batch: int = 2, seed: int = 0,
                   backend: str = "jax",
                   place_backend: str = "jax", chains: int = 8,
                   sweeps: int = 24,
                   pnr: Optional[PnRResult] = None,
                   device="cuda") -> GoldenReport:
    """End-to-end golden check of a mapping on the fabric; placement and
    simulation run on ``device``."""
    prog, pnr = build_sim(dp, mapping, app, spec,
                          place_backend=place_backend, chains=chains,
                          sweeps=sweeps, seed=seed, pnr=pnr, device=device)
    inputs = random_inputs(prog, iterations, batch, seed=seed)
    res, err, exact = check_against_interp(prog, app, inputs,
                                           backend=backend, device=device)
    return GoldenReport(
        app=mapping.app_name, ok=err == 0.0, bit_exact=exact,
        max_abs_err=err, ii=res.ii, min_ii=res.min_ii,
        latency=res.latency, iterations=iterations, batch=batch,
        n_outputs=len(app.outputs))
