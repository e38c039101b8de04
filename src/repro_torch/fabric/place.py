"""Simulated-annealing placer: batched parallel chains on the GPU.

Follows the cgra_pnr (thunder/SADetailedPlacer) shape: a placement is a
permutation of cells over tiles, moves swap a random cell with a random
tile (occupied -> swap, empty -> move), and candidate states are scored by
total half-perimeter wirelength.  Two engines share one lowering:

* ``backend="python"`` — the classic single-chain annealer with incremental
  per-net cost updates (the reference path);
* ``backend="jax"`` — C independent chains annealed in lockstep by the
  annealing kernel (:func:`repro_torch.kernels.pnr_cost.anneal_chains`,
  K2), one warp per chain for the whole sweep, after the batched HPWL
  kernel (K1) scores every chain's start.  The backend keeps its name
  ``"jax"`` (the name of the device annealer) so config blobs, memo keys,
  ``Placement.backend`` and records equal the JAX package's.

The move streams are inputs of the kernel, drawn on the host by
:mod:`repro_torch.fabric.prng`, a bit-exact port of the ``jax.random``
calls the JAX package makes: placements equal the JAX package's at equal
seeds and nonces, and a chain anneals the same moves on the CPU and the
GPU.

Move scoring (``score_mode``): a swap touches only the nets incident to
the two swapped entities, so the default ``"delta"`` mode keeps the
per-net cost vector and rescores just those <=2K nets per move; ``"full"``
recomputes every net's HPWL per move and is kept as the debug fallback.
HPWL values being exactly-representable integers, both modes accept the
same moves and return bit-identical placements.

Entry points take ``device`` (default ``"cuda"``): with no card they
raise unless the caller passes ``device="cpu"``, which runs the kernels'
plain PyTorch versions.

PE cells live on the rows x cols grid, I/O cells on the perimeter ring;
moves never cross the two classes, so every intermediate state is legal by
construction.
"""

from __future__ import annotations

import math
import random as _random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.tiling import pow2_bucket as _bucket
from .arch import Coord, FabricSpec
from .netlist import Netlist

__all__ = ["PlacementProblem", "Placement", "lower", "net_incidence",
           "anneal_python", "anneal_jax", "anneal_jax_batch", "place",
           "batch_signature", "check_anneal_budget", "CURVE_POINTS",
           "KERNEL_INPUTS", "flat_inputs", "batch_inputs", "run_chains"]


@dataclass
class PlacementProblem:
    spec: FabricSpec
    cell_names: List[str]            # PE cells first, then I/O cells
    n_pe_cells: int
    n_io_cells: int
    slot_xy: np.ndarray              # (E, 2) float32; PE slots then I/O slots
    n_pe_slots: int
    n_io_slots: int
    net_pins: np.ndarray             # (N, D) int32 entity indices (0-padded)
    net_mask: np.ndarray             # (N, D) bool
    ent_nets: np.ndarray = None      # (E, K) int32 entity -> incident nets,
    # padded with N (out of range) — the incidence table delta scoring uses
    # to find the nets a swap touches
    net_fix: Optional[np.ndarray] = None   # (N, 4) float32 per-net fixed
    # bounding boxes of the hierarchical placer's sub-problems; that placer
    # is not ported yet, so the annealers refuse problems that carry them

    @property
    def n_entities(self) -> int:
        return self.n_pe_slots + self.n_io_slots

    def entity_of(self, cell_idx: int) -> int:
        """Entity index of the cell_idx-th cell in cell_names order."""
        if cell_idx < self.n_pe_cells:
            return cell_idx
        return self.n_pe_slots + (cell_idx - self.n_pe_cells)


@dataclass
class Placement:
    coords: Dict[str, Coord]         # cell name -> tile
    cost: float                      # HPWL of the chosen chain
    backend: str
    chains: int
    sweeps: int
    chain_costs: List[float] = field(default_factory=list)


def lower(netlist: Netlist, spec: FabricSpec) -> PlacementProblem:
    """Lower a netlist to the padded arrays both annealers consume."""
    pe = sorted(netlist.pe_cells, key=lambda c: c.instance)
    io = sorted(netlist.io_cells, key=lambda c: c.name)
    if len(pe) > spec.n_pe_tiles:
        raise ValueError(f"{len(pe)} PE cells exceed {spec.n_pe_tiles} tiles "
                         f"({spec.summary()}); use spec.fit()")
    if len(io) > spec.n_io_sites:
        raise ValueError(f"{len(io)} I/O cells exceed {spec.n_io_sites} "
                         f"perimeter sites ({spec.summary()})")
    slot_xy = np.asarray(spec.pe_tiles() + spec.io_sites(), np.float32)
    ent_of: Dict[str, int] = {}
    for i, c in enumerate(pe):
        ent_of[c.name] = i
    for j, c in enumerate(io):
        ent_of[c.name] = spec.n_pe_tiles + j

    nets = netlist.nets
    deg = max((n.degree for n in nets), default=1)
    net_pins = np.zeros((max(1, len(nets)), deg), np.int32)
    net_mask = np.zeros_like(net_pins, dtype=bool)
    for i, n in enumerate(nets):
        for j, cell in enumerate([n.driver] + n.sinks):
            net_pins[i, j] = ent_of[cell]
            net_mask[i, j] = True

    return PlacementProblem(
        spec=spec,
        cell_names=[c.name for c in pe] + [c.name for c in io],
        n_pe_cells=len(pe), n_io_cells=len(io),
        slot_xy=slot_xy,
        n_pe_slots=spec.n_pe_tiles, n_io_slots=spec.n_io_sites,
        net_pins=net_pins, net_mask=net_mask,
        ent_nets=net_incidence(net_pins, net_mask,
                               spec.n_pe_tiles + spec.n_io_sites))


def net_incidence(net_pins: np.ndarray, net_mask: np.ndarray,
                  n_entities: int) -> np.ndarray:
    """Padded entity -> incident-nets table for delta move scoring.

    Returns (E, K) int32 where K is the max nets on any entity; unused
    entries hold N (one past the last net) so out-of-range gathers and
    ``mode="drop"`` scatters ignore them.
    """
    n_nets = net_pins.shape[0]
    incident: List[List[int]] = [[] for _ in range(n_entities)]
    for i in range(n_nets):
        for e in net_pins[i][net_mask[i]]:
            incident[int(e)].append(i)
    k = max(1, max((len(l) for l in incident), default=1))
    table = np.full((n_entities, k), n_nets, np.int32)
    for e, l in enumerate(incident):
        table[e, :len(l)] = l
    return table


def _init_slots(p: PlacementProblem, rng: _random.Random) -> np.ndarray:
    """Random legal permutation: entity -> slot, classes kept separate."""
    pe_slots = list(range(p.n_pe_slots))
    io_slots = list(range(p.n_pe_slots, p.n_entities))
    rng.shuffle(pe_slots)
    rng.shuffle(io_slots)
    return np.asarray(pe_slots + io_slots, np.int32)


def _default_t0(p: PlacementProblem) -> float:
    return 0.5 * (p.spec.rows + p.spec.cols)


# ---------------------------------------------------------------------------
# Python reference chain (incremental delta evaluation)
# ---------------------------------------------------------------------------
def anneal_python(p: PlacementProblem, *, seed: int = 0, sweeps: int = 48,
                  t0: Optional[float] = None, t1: float = 0.02
                  ) -> Tuple[np.ndarray, float]:
    """Single annealing chain; returns (slot_of_entity, final HPWL)."""
    rng = _random.Random(seed)
    slot_of = _init_slots(p, rng)
    # maintained inverse permutation: occupant lookup is O(1) per move
    # instead of an O(E) nonzero scan
    ent_at_slot = np.empty_like(slot_of)
    ent_at_slot[slot_of] = np.arange(slot_of.shape[0], dtype=slot_of.dtype)
    pins = p.net_pins
    mask = p.net_mask
    xy = p.slot_xy

    def net_cost(i: int) -> float:
        xs = xy[slot_of[pins[i][mask[i]]]]
        if xs.size == 0:
            return 0.0
        return float(xs[:, 0].max() - xs[:, 0].min()
                     + xs[:, 1].max() - xs[:, 1].min())

    nets_of_ent: Dict[int, List[int]] = {}
    for i in range(pins.shape[0]):
        for e in pins[i][mask[i]]:
            nets_of_ent.setdefault(int(e), []).append(i)
    net_costs = [net_cost(i) for i in range(pins.shape[0])]
    cur = sum(net_costs)
    best = cur
    best_slot = slot_of.copy()

    movable: List[Tuple[int, int, int]] = []      # (lo_ent, n_cells, n_slots)
    if p.n_pe_cells:
        movable.append((0, p.n_pe_cells, p.n_pe_slots))
    if p.n_io_cells:
        movable.append((p.n_pe_slots, p.n_io_cells, p.n_io_slots))
    if not movable:
        return slot_of, 0.0
    n_real = p.n_pe_cells + p.n_io_cells
    steps = max(1, sweeps * n_real)
    t0 = _default_t0(p) if t0 is None else t0

    for step in range(steps):
        lo, n_cells, n_slots = movable[0] if (
            len(movable) == 1 or rng.random() < p.n_pe_cells / n_real
        ) else movable[-1]
        a = lo + rng.randrange(n_cells)
        slot_lo = 0 if lo == 0 else p.n_pe_slots
        t = slot_lo + rng.randrange(n_slots)
        b = int(ent_at_slot[t])
        if a == b:
            continue
        touched = sorted(set(nets_of_ent.get(a, []) + nets_of_ent.get(b, [])))
        old = sum(net_costs[i] for i in touched)
        slot_of[a], slot_of[b] = slot_of[b], slot_of[a]
        new_costs = {i: net_cost(i) for i in touched}
        delta = sum(new_costs.values()) - old
        temp = t0 * (t1 / t0) ** (step / steps)
        if delta <= 0 or rng.random() < math.exp(-delta / max(temp, 1e-9)):
            ent_at_slot[slot_of[a]], ent_at_slot[slot_of[b]] = a, b
            for i, c in new_costs.items():
                net_costs[i] = c
            cur += delta
            if cur < best:
                best, best_slot = cur, slot_of.copy()
        else:
            slot_of[a], slot_of[b] = slot_of[b], slot_of[a]
    return best_slot, float(best)


# ---------------------------------------------------------------------------
# device chains: streams on the host, K1 + K2 on the device
# ---------------------------------------------------------------------------
#: cost-curve snapshot points captured per chain when telemetry is on
CURVE_POINTS = 16

#: kernel input names, in :func:`repro_torch.kernels.pnr_cost.anneal_chains`
#: argument order
KERNEL_INPUTS = ("prob", "slot_xy", "net_pins", "net_mask", "ent_nets",
                 "temps", "active", "a", "t", "log_u", "slot0")


def _check_scoring(hpwl_backend: str, score_mode: str) -> None:
    # "pallas" named the reference's Pallas scoring kernels; both names
    # select the same scoring here, so configs from either package run
    if hpwl_backend not in ("jnp", "pallas"):
        raise ValueError(f"unknown hpwl_backend {hpwl_backend!r}")
    if score_mode not in ("delta", "full"):
        raise ValueError(f"unknown score_mode {score_mode!r}")


def _no_fixed_boxes(problems) -> None:
    if any(p.net_fix is not None for p in problems):
        raise NotImplementedError(
            "fixed-box (hierarchical) sub-problems are not ported yet; "
            "see ROADMAP.md, 'Hierarchical placement'")


_INPUT_DTYPES = (torch.int32, torch.float32, torch.int32, torch.bool,
                 torch.int32, torch.float32, torch.bool, torch.int32,
                 torch.int32, torch.float32, torch.int32)


def _inputs(*vals) -> Dict[str, torch.Tensor]:
    """Host tensors keyed by :data:`KERNEL_INPUTS` (values in that order)."""
    return {k: torch.as_tensor(v).to(d).contiguous()
            for k, v, d in zip(KERNEL_INPUTS, vals, _INPUT_DTYPES)}


def run_chains(inputs: Dict[str, torch.Tensor], device, *,
               full: bool = False, telemetry: bool = False):
    """K1 for every chain's starting per-net costs, then K2 for the sweep.

    ``inputs``: host tensors from :func:`flat_inputs` / :func:`batch_inputs`.
    Returns host tensors ``(best_slot, best, accepts, curve)`` as
    :func:`repro_torch.kernels.pnr_cost.anneal_chains` does.
    """
    from ..kernels.pnr_cost import anneal_chains, net_hpwl_rows

    d = {k: v.to(device) for k, v in inputs.items()}
    pnc0 = net_hpwl_rows(d["prob"], d["slot0"], d["slot_xy"], d["net_pins"],
                         d["net_mask"])
    out = anneal_chains(*(d[k] for k in KERNEL_INPUTS), pnc0, full=full,
                        telemetry=telemetry)
    return tuple(None if x is None else x.cpu() for x in out)


def flat_inputs(p: PlacementProblem, *, chains: int, seed: int, sweeps: int,
                t0: Optional[float] = None, t1: float = 0.02
                ) -> Dict[str, torch.Tensor]:
    """Kernel inputs of one problem's chains on the flat path (the
    reference's ``_build_annealer``): unpadded arrays, ``steps`` moves per
    chain, keys ``split(PRNGKey(seed), chains)``."""
    from .prng import chain_keys, flat_move_streams

    steps = max(1, sweeps * (p.n_pe_cells + p.n_io_cells))
    t0 = _default_t0(p) if t0 is None else t0
    rng = _random.Random(seed)
    init = np.stack([_init_slots(p, rng) for _ in range(chains)])
    a, t, log_u, temps, active, _ = flat_move_streams(
        chain_keys(seed, chains), steps, p.n_pe_cells, p.n_io_cells,
        p.n_pe_slots, p.n_io_slots, float(t0), float(t1))
    ent_nets = p.ent_nets if p.ent_nets is not None else net_incidence(
        p.net_pins, p.net_mask, p.n_entities)
    return _inputs(np.zeros(chains, np.int32), p.slot_xy[None],
                   p.net_pins[None], p.net_mask[None], ent_nets[None],
                   temps[:1], active[:1], a, t, log_u, init)


def anneal_jax(p: PlacementProblem, *, chains: int = 32, seed: int = 0,
               sweeps: int = 48, t0: Optional[float] = None,
               t1: float = 0.02, hpwl_backend: str = "jnp",
               score_mode: str = "delta", device="cuda"
               ) -> Tuple[np.ndarray, np.ndarray]:
    """C independent chains of one problem (the reference's flat
    ``_build_annealer`` path); returns (slot_of (C, E), costs (C,))."""
    _check_scoring(hpwl_backend, score_mode)
    _no_fixed_boxes([p])
    dev = resolve_device(device)
    if p.n_pe_cells + p.n_io_cells == 0:
        e = np.tile(np.arange(p.n_entities, dtype=np.int32), (chains, 1))
        return e, np.zeros((chains,), np.float32)
    inputs = flat_inputs(p, chains=chains, seed=seed, sweeps=sweeps, t0=t0,
                         t1=t1)
    best_slot, best, _, _ = run_chains(inputs, dev,
                                       full=score_mode == "full")
    return best_slot.numpy(), best.numpy()


def batch_signature(p: PlacementProblem, sweeps: int) -> Tuple[int, ...]:
    """Static shape key two problems must share to ride one dispatch."""
    steps = max(1, sweeps * (p.n_pe_cells + p.n_io_cells))
    return (_bucket(steps), _bucket(p.net_pins.shape[0]),
            _bucket(p.net_pins.shape[1]), _bucket(p.n_entities),
            _bucket(p.ent_nets.shape[1]))


def check_anneal_budget(p: PlacementProblem, chains: int, sweeps: int,
                        max_states: Optional[int], *,
                        metrics=None) -> None:
    """Refuse (pre-dispatch) an anneal whose state count exceeds budget.

    The annealing budget is deterministic and size-based — ``chains x
    sweeps x n_entities`` proposed states per problem — so exhaustion is
    a property of the problem, not of wall clock, and results stay
    bit-identical whenever the budget is *not* exhausted.  Raises
    :class:`repro.errors.BudgetExceeded` before any compilation or
    dispatch happens; no-op when ``max_states`` is None (the default).
    """
    if max_states is None:
        return
    states = chains * max(1, sweeps * (p.n_pe_cells + p.n_io_cells))
    if states > max_states:
        if metrics is not None:
            metrics.inc("pnr.budget_exhausted")
        from ..errors import BudgetExceeded
        raise BudgetExceeded(
            f"anneal needs {states} states "
            f"({chains} chains x {sweeps} sweeps x "
            f"{p.n_pe_cells + p.n_io_cells} cells > "
            f"anneal_max_states={max_states})",
            states=states, max_states=max_states, chains=chains,
            sweeps=sweeps, n_entities=p.n_entities)



def batch_inputs(problems: List[PlacementProblem], *, chains: int,
                 seed: int, sweeps: int, t0: Optional[float] = None,
                 t1: float = 0.02, nonces: Optional[List[int]] = None
                 ) -> Dict[str, torch.Tensor]:
    """Kernel inputs of the grouped path (the reference's
    ``_build_batch_annealer``): every problem padded to the shared
    :func:`batch_signature` buckets, problem ``i``'s chains keyed by
    ``split(fold_in(PRNGKey(seed), nonces[i]), chains)``."""
    from .prng import chain_keys, move_streams

    if nonces is None:
        nonces = list(range(len(problems)))
    if len(nonces) != len(problems):
        raise ValueError("nonces must match problems 1:1")
    sigs = {batch_signature(p, sweeps) for p in problems}
    if len(sigs) != 1:
        raise ValueError(f"problems span {len(sigs)} batch signatures; "
                         f"group by batch_signature() first")
    s_pad, n_pad, d_pad, e_pad, k_pad = next(iter(sigs))

    n_p = len(problems)
    net_pins = np.zeros((n_p, n_pad, d_pad), np.int32)
    net_mask = np.zeros((n_p, n_pad, d_pad), bool)
    slot_xy = np.zeros((n_p, e_pad, 2), np.float32)
    ent_nets = np.full((n_p, e_pad, k_pad), n_pad, np.int32)
    dims = np.zeros((n_p, 5), np.int32)
    t0s = np.zeros((n_p,), np.float32)
    init = np.tile(np.arange(e_pad, dtype=np.int32), (n_p, chains, 1))
    for i, p in enumerate(problems):
        n, d = p.net_pins.shape
        net_pins[i, :n, :d] = p.net_pins
        net_mask[i, :n, :d] = p.net_mask
        e = p.n_entities
        slot_xy[i, :e] = p.slot_xy
        en = np.where(p.ent_nets == n, n_pad, p.ent_nets)
        ent_nets[i, :e, :en.shape[1]] = en
        n_real = p.n_pe_cells + p.n_io_cells
        dims[i] = (p.n_pe_cells, p.n_io_cells, p.n_pe_slots, p.n_io_slots,
                   max(1, sweeps * n_real))
        t0s[i] = _default_t0(p) if t0 is None else t0
        rng = _random.Random(seed)
        for c in range(chains):
            init[i, c, :e] = _init_slots(p, rng)

    a, t, log_u, temps, active, _ = move_streams(
        chain_keys(seed, chains, nonces),
        torch.from_numpy(np.repeat(dims, chains, 0)),
        torch.from_numpy(np.repeat(t0s, chains)), float(t1), s_pad)
    # temperatures and step masks are per problem: every chain of a
    # problem shares its row
    return _inputs(np.repeat(np.arange(n_p, dtype=np.int32), chains),
                   slot_xy, net_pins, net_mask, ent_nets, temps[::chains],
                   active[::chains], a, t, log_u,
                   init.reshape(n_p * chains, e_pad))


def anneal_jax_batch(problems: List[PlacementProblem], *, chains: int = 16,
                     seed: int = 0, sweeps: int = 32,
                     t0: Optional[float] = None, t1: float = 0.02,
                     score_mode: str = "delta",
                     nonces: Optional[List[int]] = None,
                     telemetry: Optional[bool] = None,
                     metrics=None, max_states: Optional[int] = None,
                     device="cuda"
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Anneal many placement problems in one device dispatch.

    All problems must share one :func:`batch_signature`; every problem's
    arrays are padded to the signature's bucket shapes (masked nets score
    zero, dummy entities sit on dummy slots and are never proposed as
    moves) and all ``len(problems) x chains`` chains run as one launch of
    the annealing kernel, each chain reading its own problem's arrays.
    Returns per problem ``(slot_of (C, E), costs (C,))`` with E the
    problem's real entity count — the same contract as :func:`anneal_jax`.

    Each problem's chains draw from ``fold_in(PRNGKey(seed), nonce)`` with
    ``nonces[i]`` defaulting to ``i``.  Callers wanting placements that are
    reproducible *regardless of grouping* (the explore pipeline's memo
    contract) pass a content-derived nonce per problem; with bucket-shape
    padding the result then depends only on the problem itself, never on
    its groupmates.

    ``telemetry`` (default: :func:`repro_torch.obs.telemetry_enabled`)
    also reports per-chain accept counts and cost-curve snapshots;
    placements stay bit-identical.  Acceptance rates land in ``metrics``
    (histogram ``pnr.anneal.accept_rate``, cost curves as
    ``pnr.anneal.cost_curve.<nonce>`` gauges), defaulting to the global
    registry.
    """
    from ..obs import telemetry_enabled
    from ..obs.metrics import global_registry

    _check_scoring("jnp", score_mode)
    _no_fixed_boxes(problems)
    dev = resolve_device(device)
    if telemetry is None:
        telemetry = telemetry_enabled()
    if nonces is None:
        nonces = list(range(len(problems)))
    for p in problems:
        check_anneal_budget(p, chains, sweeps, max_states,
                            metrics=metrics or global_registry())
    inputs = batch_inputs(problems, chains=chains, seed=seed, sweeps=sweeps,
                          t0=t0, t1=t1, nonces=nonces)
    best_slot, best, accepts, curves = run_chains(
        inputs, dev, full=score_mode == "full", telemetry=bool(telemetry))
    n_p = len(problems)
    slots = best_slot.numpy().reshape(n_p, chains, -1)
    costs = best.numpy().reshape(n_p, chains)
    if telemetry:
        reg = metrics if metrics is not None else global_registry()
        accepts = accepts.numpy().reshape(n_p, chains)
        curves = curves.numpy().reshape(n_p, chains, CURVE_POINTS)
        for i, p in enumerate(problems):
            steps_i = max(1, sweeps * (p.n_pe_cells + p.n_io_cells))
            reg.observe("pnr.anneal.accept_rate",
                        float(accepts[i].mean()) / steps_i)
            best_chain = int(np.argmin(costs[i]))
            reg.set_gauge(f"pnr.anneal.cost_curve.{nonces[i] & 0x7FFFFFFF}",
                          [round(float(c), 3) for c in
                           curves[i, best_chain]])
    return [(slots[i, :, :p.n_entities], costs[i])
            for i, p in enumerate(problems)]


def place(netlist: Netlist, spec: FabricSpec, *, backend: str = "jax",
          chains: int = 32, sweeps: int = 48, seed: int = 0,
          t0: Optional[float] = None, t1: float = 0.02,
          hpwl_backend: str = "jnp", score_mode: str = "delta",
          max_states: Optional[int] = None, device="cuda") -> Placement:
    """Anneal and return the best chain's placement.

    ``max_states`` bounds the anneal state budget (chains x sweeps x
    entities) exactly like the batched path — the serial fallback must
    not silently out-spend the budget the grouped dispatch enforces.
    ``backend="jax"`` runs the annealing kernel on ``device``.
    """
    _check_scoring(hpwl_backend, score_mode)
    p = lower(netlist, spec)
    check_anneal_budget(p, chains, sweeps, max_states)

    if backend == "python":
        if hpwl_backend != "jnp":
            raise ValueError(
                "hpwl_backend applies to the jax annealer only; the python "
                "reference scores moves without the HPWL kernel")
        # the python reference is inherently incremental; score_mode only
        # selects between the jax engine's two scoring programs
        chain_results = [anneal_python(p, seed=seed + c, sweeps=sweeps,
                                       t0=t0, t1=t1)
                         for c in range(chains)]
        slots = np.stack([s for s, _ in chain_results])
        costs = np.asarray([c for _, c in chain_results], np.float32)
    elif backend == "jax":
        slots, costs = anneal_jax(p, chains=chains, seed=seed, sweeps=sweeps,
                                  t0=t0, t1=t1, hpwl_backend=hpwl_backend,
                                  score_mode=score_mode, device=device)
    else:
        raise ValueError(f"unknown backend {backend!r}")

    best = int(np.argmin(costs))
    slot_of = slots[best]
    coords: Dict[str, Coord] = {}
    for idx, name in enumerate(p.cell_names):
        ent = p.entity_of(idx)
        x, y = p.slot_xy[slot_of[ent]]
        coords[name] = (int(x), int(y))
    return Placement(coords=coords, cost=float(costs[best]), backend=backend,
                     chains=chains, sweeps=sweeps,
                     chain_costs=[float(c) for c in costs])
