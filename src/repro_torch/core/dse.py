"""End-to-end design-space-exploration primitives (paper Sec. IV, Fig. 6).

Given one or more application dataflow graphs:

1. mine frequent subgraphs per app (Sec. III-A),
2. rank by maximal-independent-set size (Sec. III-B),
3. build PE variants (Sec. V):
   * ``PE 1``  — baseline PE restricted to the ops the app uses,
   * ``PE k``  — PE 1 + the top (k-1) subgraphs merged in MIS order,
   * domain PE (``PE IP`` / ``PE ML``) — top subgraphs of *all* apps merged,
4. map every app onto every variant and evaluate area/energy/fmax.

The returned records are exactly what the paper's Figs. 8/10/11 plot.

The end-to-end drivers (``specialize_per_app`` / ``domain_pe`` /
``evaluate_variants``) are retained as thin, bit-identical shims over the
staged pipeline in :mod:`repro_torch.explore` — new code should build an
:class:`repro_torch.explore.ExploreConfig` and run an
:class:`repro_torch.explore.Explorer` instead of threading loose kwargs here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, TYPE_CHECKING, Union

from ..graphir.graph import Graph
from ..graphir.ops import NON_COMPUTE, unit_of
from .costmodel import AppCost
from .merge import add_pattern, baseline_datapath, is_pe_pattern, _PE_UNITS
from .mining import MinedSubgraph, MiningConfig, mine_frequent_subgraphs
from .mis import rank_by_mis
from .pe import Datapath

if TYPE_CHECKING:
    from ..fabric.arch import FabricSpec
    from ..fabric.cost import FabricCost
    from ..fabric.options import FabricOptions


@dataclass
class PEVariant:
    name: str
    datapath: Datapath
    merged_subgraphs: List[str] = field(default_factory=list)
    costs: Dict[str, AppCost] = field(default_factory=dict)   # per app
    fabric_costs: Dict[str, "FabricCost"] = field(default_factory=dict)
    # per app, filled when fabric-level evaluation is enabled


@dataclass
class DSEResult:
    apps: Dict[str, Graph]
    mined: Dict[str, List[MinedSubgraph]]
    variants: List[PEVariant]
    elapsed_s: float = 0.0

    def best_variant(self, app: str) -> PEVariant:
        """Lowest-energy variant for an app.

        Ranks by the *measured* ``sim_energy_per_op_pj`` when the time-
        domain simulation ran for a variant (``sim_ii > 0``) — so a skew-
        bound schedule's idle cycles penalize it — falling back to the
        static ``energy_per_op_pj`` estimate for variants the simulator
        never saw.
        """
        cands = [v for v in self.variants if app in v.costs]

        def energy(v: PEVariant) -> float:
            c = v.costs[app]
            return (c.sim_energy_per_op_pj if c.sim_ii > 0
                    else c.energy_per_op_pj)

        return min(cands, key=energy)

    def table(self) -> str:
        lines = []
        for v in self.variants:
            for app, c in sorted(v.costs.items()):
                lines.append(c.row())
        return "\n".join(lines)


def app_ops(app: Graph) -> Set[str]:
    """PE-implementable ops used by an application graph."""
    return {op for op in app.nodes.values()
            if op not in NON_COMPUTE and op != "const"
            and unit_of(op) in _PE_UNITS and op != "cmux"}


def mine_and_rank(app: Graph, cfg: Optional[MiningConfig] = None
                  ) -> List[MinedSubgraph]:
    mined = mine_frequent_subgraphs(app, cfg)
    mined = [m for m in mined if is_pe_pattern(m.pattern)]
    return rank_by_mis(mined)


def _dedup_keep_maximal(ranked: List[MinedSubgraph]) -> List[MinedSubgraph]:
    """Drop subgraphs fully contained in an earlier-ranked, larger subgraph
    with at-least-equal MIS utility (merging the bigger one subsumes them)."""
    from .isomorphism import find_embeddings
    kept: List[MinedSubgraph] = []
    for m in ranked:
        subsumed = False
        for k in kept:
            if (k.size >= m.size and k.mis_size >= m.mis_size
                    and find_embeddings(m.pattern, k.pattern,
                                        max_embeddings=4)):
                subsumed = True
                break
        if not subsumed:
            kept.append(m)
    return kept


def build_variants(app_name: str, app: Graph,
                   ranked: List[MinedSubgraph],
                   *, max_merge: int = 4,
                   rank_mode: str = "mis",
                   validate: bool = True) -> List[PEVariant]:
    """PE 1 .. PE (1+max_merge) for a single application.

    rank_mode:
      * ``"mis"`` — the paper's ordering: subgraphs merged in MIS-size order
        (Sec. III-C / Sec. V bullet list).
      * ``"utility"`` — beyond-paper: order by MIS x (ops fused - 1), i.e.
        the number of PE invocations each subgraph eliminates, and skip
        candidates whose marginal coverage is zero.  Recorded separately in
        EXPERIMENTS.md as an improvement over the reproduction baseline.
    """
    variants: List[PEVariant] = []
    ops = app_ops(app)
    dp = baseline_datapath(ops)
    variants.append(PEVariant(f"PE1", dp.copy()))
    usable = _dedup_keep_maximal(ranked)
    if rank_mode == "utility":
        usable = sorted(usable,
                        key=lambda m: (-m.mis_size * max(1, m.size - 1),
                                       -m.size, m.label))
    merged_names: List[str] = []
    cur = dp
    k = 0
    for m in usable:
        if k >= max_merge:
            break
        name = f"sg:{app_name}:{k}"
        nxt = cur.copy()
        add_pattern(nxt, m.pattern, name, validate=validate)
        if rank_mode == "utility":
            # marginal-gain check: does the new config actually get used?
            from .mapper import map_application
            trial = map_application(nxt, app, app_name)
            used = sum(1 for i in trial.instances if i.config == name)
            if used == 0:
                continue
        cur = nxt
        merged_names.append(name)
        variants.append(PEVariant(f"PE{k + 2}", cur.copy(),
                                  list(merged_names)))
        k += 1
    return variants


def _explorer_config(mode: str, mining: Optional[MiningConfig],
                     options: Optional["FabricOptions"], **kw):
    """Build the ExploreConfig a legacy driver call corresponds to.

    ``pnr_batch="serial"`` pins the one-dispatch-per-pair annealing loop,
    which is what makes the shims reproduce the pre-``repro_torch.explore``
    records bit-identically at equal seeds.
    """
    from ..explore.config import ExploreConfig
    return ExploreConfig(mode=mode, mining=mining or MiningConfig(),
                         fabric=options, pnr_batch="serial", **kw)


def evaluate_variants(variants: Sequence[PEVariant],
                      apps: Dict[str, Graph],
                      *, fabric: Optional[Union["FabricSpec",
                                                "FabricOptions"]] = None,
                      fabric_backend: Optional[str] = None,
                      fabric_chains: Optional[int] = None,
                      fabric_sweeps: Optional[int] = None,
                      fabric_seed: Optional[int] = None,
                      simulate: bool = False, device="cuda") -> None:
    """Deprecated shim: map + cost every (variant, app) pair in place.

    Delegates to :func:`repro_torch.explore.evaluate_pairs` (serial mode — the
    legacy loop, bit-identical at equal seeds).  The loose ``fabric_*``
    kwargs emit :class:`DeprecationWarning`; new code should run an
    :class:`repro_torch.explore.Explorer` (which also batches the annealing
    across pairs) or pass a full :class:`repro_torch.fabric.FabricOptions`.

    fabric: a :class:`repro_torch.fabric.FabricOptions` (or a bare ``FabricSpec``
    plus the legacy ``fabric_*`` kwargs, folded in automatically) — when
    given, each mapping is placed and routed on the fabric (auto-grown when
    the variant needs more tiles) and the array-accurate numbers are
    attached to the AppCost records (``fabric_*`` fields) and kept in
    ``variant.fabric_costs``.

    simulate: with a fabric, additionally modulo-schedule and cycle-
    accurately simulate every mapping, attaching the schedule (``sim_*``
    fields) and the golden check against the interpreter.

    device: where the placement anneals and the simulation steps ("cuda"
    by default, or "cpu").
    """
    from ..explore.pipeline import evaluate_pairs
    from ..fabric.options import FabricOptions

    options = FabricOptions.coerce(fabric, backend=fabric_backend,
                                   chains=fabric_chains,
                                   sweeps=fabric_sweeps, seed=fabric_seed,
                                   simulate=simulate)
    evaluate_pairs(variants, apps, options, pnr_batch="serial",
                   device=device)


def specialize_per_app(apps: Dict[str, Graph],
                       mining: Optional[MiningConfig] = None,
                       *, max_merge: int = 4,
                       rank_mode: str = "mis",
                       validate: bool = True,
                       fabric: Optional[Union["FabricSpec",
                                              "FabricOptions"]] = None,
                       fabric_backend: Optional[str] = None,
                       fabric_chains: Optional[int] = None,
                       fabric_sweeps: Optional[int] = None,
                       fabric_seed: Optional[int] = None,
                       simulate: bool = False,
                       device="cuda") -> Dict[str, DSEResult]:
    """Deprecated shim: per-application DSE (paper Sec. V-A camera sweep).

    Runs an :class:`repro_torch.explore.Explorer` in ``per_app`` mode with
    ``pnr_batch="serial"``, reproducing the pre-redesign records
    bit-identically at equal seeds.  New code should build an
    :class:`repro_torch.explore.ExploreConfig` directly — it memoizes every
    stage and batches the annealing across (variant, app) pairs.
    """
    from ..explore.pipeline import Explorer
    from ..fabric.options import FabricOptions

    options = FabricOptions.coerce(fabric, backend=fabric_backend,
                                   chains=fabric_chains,
                                   sweeps=fabric_sweeps, seed=fabric_seed,
                                   simulate=simulate)
    cfg = _explorer_config("per_app", mining, options, max_merge=max_merge,
                           rank_mode=rank_mode, validate=validate)
    return Explorer(apps, cfg, device=device).run().results


def domain_pe(apps: Dict[str, Graph],
              mining: Optional[MiningConfig] = None,
              *, per_app_subgraphs: int = 2,
              domain_name: str = "PE_DOM",
              validate: bool = True,
              fabric: Optional[Union["FabricSpec",
                                     "FabricOptions"]] = None,
              fabric_backend: Optional[str] = None,
              fabric_chains: Optional[int] = None,
              fabric_sweeps: Optional[int] = None,
              fabric_seed: Optional[int] = None,
              simulate: bool = False, device="cuda") -> DSEResult:
    """Deprecated shim: cross-application PE (paper's PE IP / PE ML).

    Runs an :class:`repro_torch.explore.Explorer` in ``domain`` mode with
    ``pnr_batch="serial"`` — bit-identical to the pre-redesign driver at
    equal seeds.  New code should use :class:`repro_torch.explore.ExploreConfig`.
    """
    from ..explore.pipeline import Explorer
    from ..fabric.options import FabricOptions

    options = FabricOptions.coerce(fabric, backend=fabric_backend,
                                   chains=fabric_chains,
                                   sweeps=fabric_sweeps, seed=fabric_seed,
                                   simulate=simulate)
    cfg = _explorer_config("domain", mining, options,
                           per_app_subgraphs=per_app_subgraphs,
                           domain_name=domain_name, validate=validate)
    return Explorer(apps, cfg, device=device).run().results[domain_name]
