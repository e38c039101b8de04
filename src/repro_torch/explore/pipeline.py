"""The staged exploration pipeline: mine -> rank -> merge -> map -> pnr.

:class:`Explorer` runs the paper's flow (Sec. IV, Fig. 6) as explicit,
individually invokable stages over one :class:`ExploreConfig`.  Every
stage is memoized by a *content key* — a hash of the application graph
plus exactly the upstream config fields that stage depends on — so
changing the annealing budget reuses every upstream artifact instead of
re-mining and re-merging:

    ex = Explorer(apps, cfg)                         # device="cuda"
    res = ex.run()                                   # full pipeline
    res2 = ex.with_config(fabric=replace(cfg.fabric, sweeps=64)).run()
    ex.stats["mine"]     # still the first run's count: zero re-mines

The ``pnr`` stage is batch-first: all (variant, app) mappings are
gathered, lowered, grouped by :func:`repro_torch.fabric.place.batch_signature`,
and annealed with chains spread across pairs in one launch of the
annealing kernel per group (``pnr_batch="grouped"``) on the Explorer's
``device``.  ``pnr_batch="serial"`` runs the legacy one-dispatch-per-pair
loop — it is what the deprecated ``specialize_per_app`` / ``domain_pe`` /
``evaluate_variants`` shims pin.  Both produce the records of the JAX
package's Explorer bit for bit.

The ``schedule`` and ``simulate`` stages (modulo scheduling and cycle-
accurate simulation) are not ported yet: a config with
``fabric.simulate=True`` raises :class:`NotImplementedError`.
"""

from __future__ import annotations

import hashlib
import json
import time
import zlib
from collections import Counter, defaultdict
from dataclasses import dataclass, replace as _dc_replace
from typing import Any, Callable, Dict, List, Optional, Tuple, TYPE_CHECKING

from .. import faultinject
from ..core.costmodel import AppCost, evaluate_mapping
from ..core.dse import (DSEResult, PEVariant, _dedup_keep_maximal, app_ops,
                        build_variants)
from ..core.mapper import Mapping, map_application
from ..core.merge import add_pattern, baseline_datapath, is_pe_pattern
from ..core.mining import MinedSubgraph, mine_frequent_subgraphs
from ..core.mis import rank_by_mis
from ..device import resolve_device
from ..errors import BudgetExceeded
from ..graphir.graph import Graph
from ..obs import event as obs_event, span
from ..obs.memprof import stage_memory
from ..obs.metrics import CounterView, MetricsRegistry
from .config import ExploreConfig
from .records import ExploreRecord, StageFailure

if TYPE_CHECKING:                              # runtime import stays lazy
    from ..fabric import PnRResult
    from ..fabric.options import FabricOptions

Pair = Tuple[str, str]                         # (pe_name, app_name)

#: sentinel for a unit of work that failed twice (batch + serial retry)
#: in isolate mode — never stored in the memo, never a real stage value
_FAILED = object()

#: the schedule/simulate stages wait for the simulator slice of the port
SIMULATE_NOT_PORTED = (
    "the schedule/simulate stages are not ported yet (ROADMAP.md, "
    "'Simulator': sim/{schedule,golden,cycle}.py and the cycle-stepper "
    "kernel K3); run with fabric.simulate=False")


# ---------------------------------------------------------------------------
# content keys
# ---------------------------------------------------------------------------
def _digest(*parts: Any) -> str:
    return hashlib.sha256(
        json.dumps(parts, sort_keys=True, default=repr).encode()
    ).hexdigest()[:16]


def graph_key(g: Graph) -> str:
    """Stable structural fingerprint of an application graph."""
    nodes = sorted((nid, op, sorted((g.attrs.get(nid) or {}).items()))
                   for nid, op in g.nodes.items())
    return _digest(nodes, sorted(g.edges), list(g.outputs))


def _mining_fields(cfg: ExploreConfig) -> Tuple:
    m = cfg.mining
    return (m.min_support, m.max_pattern_nodes, m.max_patterns_per_level,
            m.max_embeddings, m.max_ext_embeddings, m.time_budget_s,
            m.allow_macros)


def _pnr_fields(options: "FabricOptions", pnr_batch: str,
                pnr_mode: str = "flat") -> Tuple:
    s = options.spec
    spec_sig = None if s is None else (s.rows, s.cols, s.channel_width,
                                       s.io_capacity, s.hop_energy_pj,
                                       s.hop_delay_ns, s.latch_depth)
    sig = (spec_sig, options.backend, options.hpwl_backend,
           options.score_mode, options.chains, options.sweeps,
           options.seed, pnr_batch, options.anneal_max_states)
    # flat keys keep their pre-pnr_mode shape so existing memo stores
    # stay warm across the upgrade; hierarchical results key separately
    if pnr_mode != "flat":
        sig = sig + (pnr_mode,)
    return sig


def _pair_nonce(pe_name: str, app_name: str) -> int:
    """Content nonce for one (variant, app) pair: seeds the pair's golden
    test vectors so simulated results never depend on bucket grouping."""
    return zlib.crc32(f"{pe_name}:{app_name}".encode())



# ---------------------------------------------------------------------------
# per-pair primitives (shared by the Explorer stages and the legacy shims)
# ---------------------------------------------------------------------------
def _pnr_pair(pe_name, dp, mapping, app, options,
              pnr_mode: str = "flat", device="cuda") -> "PnRResult":
    from ..fabric import place_and_route
    return place_and_route(dp, mapping, app, options.spec,
                           backend=options.backend, chains=options.chains,
                           sweeps=options.sweeps, seed=options.seed,
                           pe_name=pe_name,
                           hpwl_backend=options.hpwl_backend,
                           score_mode=options.score_mode,
                           max_states=options.anneal_max_states,
                           pnr_mode=pnr_mode, device=device)


def pnr_grouped(items: List[Tuple[str, Any, Mapping, Graph, int]],
                options: "FabricOptions",
                stats: Optional[Counter] = None,
                isolate: bool = False, device="cuda") -> List["PnRResult"]:
    """Place-and-route many (variant, app) pairs, annealing each bucket-
    compatible group in ONE launch of the annealing kernel on ``device``.

    items: (pe_name, datapath, mapping, app, nonce) per pair; the nonce
    seeds the pair's chains so its placement is reproducible regardless of
    which pairs share its dispatch.  Routing and costing stay per-pair
    (they are cheap Python); only the annealing hot loop is batched.

    ``isolate=True``: a failing pair (fault-injection site ``pnr``, an
    over-budget anneal, a lowering/routing error) yields the Exception
    object at its index instead of killing the batch.  Content-nonce
    seeding makes every surviving pair's placement bit-identical however
    the failed pair reshapes its dispatch group.
    """
    from ..fabric import PnRResult
    from ..fabric.arch import Coord, FabricSpec
    from ..fabric.cost import evaluate_fabric
    from ..fabric.netlist import extract_netlist
    from ..fabric.place import (Placement, anneal_jax_batch,
                                batch_signature, check_anneal_budget, lower)
    from ..fabric.route import route_nets
    import numpy as np

    registry = getattr(stats, "registry", None)
    spec0 = options.spec or FabricSpec()
    lowered: List[Optional[Tuple]] = []
    errors: Dict[int, Exception] = {}
    for i, (pe_name, dp, mapping, app, nonce) in enumerate(items):
        try:
            faultinject.fire("pnr", pe=pe_name, app=mapping.app_name)
            netlist = extract_netlist(mapping, app, spec0)
            spec = spec0.fit(len(netlist.pe_cells), len(netlist.io_cells))
            prob = lower(netlist, spec)
            check_anneal_budget(prob, options.chains, options.sweeps,
                                options.anneal_max_states, metrics=registry)
            lowered.append((netlist, spec, prob))
        except Exception as e:
            if not isolate:
                raise
            lowered.append(None)
            errors[i] = e

    groups: Dict[Tuple, List[int]] = defaultdict(list)
    for i, low in enumerate(lowered):
        if low is not None:
            groups[batch_signature(low[2], options.sweeps)].append(i)

    annealed: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for sig, idxs in groups.items():
        try:
            with span("pnr.dispatch", bucket="x".join(map(str, sig)),
                      pairs=len(idxs)):
                out = anneal_jax_batch([lowered[i][2] for i in idxs],
                                       chains=options.chains,
                                       seed=options.seed,
                                       sweeps=options.sweeps,
                                       score_mode=options.score_mode,
                                       nonces=[items[i][4] for i in idxs],
                                       metrics=registry, device=device)
        except Exception as e:
            if not isolate:
                raise
            for i in idxs:       # whole-dispatch failure: every rider
                errors[i] = e    # retries on the serial path
            continue
        annealed.update(zip(idxs, out))
        if registry is not None:
            registry.observe("pnr.bucket_size", len(idxs))
        if stats is not None:
            stats["pnr_dispatch"] += 1

    results: List = []
    for i, (pe_name, dp, mapping, app, _) in enumerate(items):
        if i in errors:
            results.append(errors[i])
            continue
        netlist, spec, prob = lowered[i]
        slots, costs = annealed[i]
        try:
            best = int(np.argmin(costs))
            coords: Dict[str, Coord] = {}
            for idx, name in enumerate(prob.cell_names):
                x, y = prob.slot_xy[slots[best][prob.entity_of(idx)]]
                coords[name] = (int(x), int(y))
            with span("pnr.pair", pe=pe_name, app=mapping.app_name):
                placement = Placement(coords=coords, cost=float(costs[best]),
                                      backend="jax", chains=options.chains,
                                      sweeps=options.sweeps,
                                      chain_costs=[float(c) for c in costs])
                routes = route_nets(netlist, placement, spec)
                fc = evaluate_fabric(dp, mapping, netlist, placement, routes,
                                     spec, pe_name=pe_name)
            results.append(PnRResult(spec, netlist, placement, routes, fc))
        except Exception as e:
            if not isolate:
                raise
            results.append(e)
    return results


def evaluate_pairs(variants, apps: Dict[str, Graph],
                   options: Optional["FabricOptions"], *,
                   pnr_batch: str = "serial") -> None:
    """Map + cost every (variant, app) pair in place; optional array-level
    PnR and time-domain simulation.  This is the engine behind the
    deprecated :func:`repro.core.dse.evaluate_variants` shim; the serial
    mode reproduces the legacy loop bit-for-bit.
    """
    from ..fabric.cost import attach_fabric

    todo = []
    for v in variants:
        for app_name, app in apps.items():
            mapping = map_application(v.datapath, app, app_name)
            cost = evaluate_mapping(v.datapath, mapping, v.name)
            v.costs[app_name] = cost
            if options is not None:
                todo.append((v, app_name, app, mapping, cost))
    if options is None:
        return

    if pnr_batch == "grouped":
        items = [(v.name, v.datapath, mapping, app,
                  _pair_nonce(v.name, app_name))
                 for v, app_name, app, mapping, _ in todo]
        pnrs = pnr_grouped(items, options, device=device)
    else:
        pnrs = [_pnr_pair(v.name, v.datapath, mapping, app, options,
                          device=device)
                for v, app_name, app, mapping, _ in todo]

    for (v, app_name, app, mapping, cost), pnr in zip(todo, pnrs):
        v.fabric_costs[app_name] = pnr.cost
        attach_fabric(cost, pnr.cost)


# ---------------------------------------------------------------------------
# the Explorer
# ---------------------------------------------------------------------------
@dataclass
class ExploreResult:
    """Everything one pipeline run produced, plus the flat record view."""

    config: ExploreConfig
    config_key: str
    apps: Dict[str, Graph]
    results: Dict[str, DSEResult]    # per app, or {domain_name: result}
    elapsed_s: float
    sim_buckets: Dict[Pair, str] = None   # provenance per simulated pair
    metrics: Dict[str, Any] = None        # registry snapshot at run end
    failures: List[StageFailure] = None   # degraded pairs/apps (isolate
    # mode: each failed its batch group AND the serial retry)

    @property
    def clean(self) -> bool:
        return not self.failures

    def records(self) -> List[ExploreRecord]:
        buckets = self.sim_buckets or {}
        rows: List[ExploreRecord] = []
        for res in self.results.values():
            for app_name in sorted(res.apps):
                for v in res.variants:
                    if app_name not in v.costs:
                        continue
                    rows.append(ExploreRecord.from_cost(
                        v.costs[app_name], mode=self.config.mode,
                        config_key=self.config_key,
                        n_merged=len(v.merged_subgraphs),
                        sim_bucket=buckets.get((v.name, app_name), "")))
        return rows

    def to_jsonl(self, path: str) -> int:
        from .records import to_jsonl
        return to_jsonl(self.records(), path,
                        failures=self.failures or ())

    def table(self) -> str:
        return "\n".join(r.row() for res in self.results.values()
                         for v in res.variants
                         for r in [v.costs[a] for a in sorted(v.costs)])


class Explorer:
    """Staged, memoized DSE pipeline over one config.

    Stages (each individually invokable, each memoized by content key):

    ``mine()``      raw frequent subgraphs per app (Sec. III-A)
    ``rank()``      PE-pattern filter + MIS ranking (Sec. III-B)
    ``merge()``     PE variant datapaths (Sec. III-C / V)
    ``map()``       application covers per (variant, app) (Sec. IV)
    ``pnr()``       array place-and-route — batch-first across pairs
    ``run()``       everything the config asks for -> :class:`ExploreResult`

    ``with_config(...)`` derives a new Explorer over changed options that
    *shares the memo store*, so downstream-only changes (annealing budget)
    reuse all upstream artifacts.

    ``device`` (default ``"cuda"``) is where the pnr stage anneals; with
    no card the constructor raises unless ``device="cpu"`` is passed.
    The device is not part of any memo key: both devices compute the same
    placements bit for bit.
    """

    def __init__(self, apps: Dict[str, Graph], config: ExploreConfig, *,
                 store: Optional[Dict] = None,
                 stats: Optional[Counter] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 device="cuda") -> None:
        self.device = resolve_device(device)
        self.apps = dict(apps)
        self.config = config
        self._store: Dict[Tuple, Any] = {} if store is None else store
        # stats is a Counter-compatible view onto the metrics registry —
        # the legacy `ex.stats["pnr_dispatch"]` reads and `stats[k] += 1`
        # write-throughs all land in (and report from) the registry
        if metrics is None and isinstance(stats, CounterView):
            metrics = stats.registry
        self.metrics: MetricsRegistry = metrics or MetricsRegistry()
        self.stats: CounterView = self.metrics.view()
        if stats is not None and not isinstance(stats, CounterView):
            for k, v in stats.items():       # seed from a legacy Counter
                self.stats[k] += v
        self._app_keys = {name: graph_key(g) for name, g in apps.items()}
        self.failures: List[StageFailure] = []
        # memo keys that degraded to a StageFailure this run: stages
        # re-invoke their upstreams freely (schedule -> pnr -> map), so
        # without this a failed unit would be silently re-attempted
        # mid-run and the stage views would disagree about which pairs
        # exist.  Per-run only — never persisted, so a later run (or a
        # crash-resume against the same DiskStore) recomputes failures.
        self._failed: set = set()

    def with_config(self, **changes: Any) -> "Explorer":
        """New Explorer over a changed config, sharing the memo store."""
        return Explorer(self.apps, self.config.replace(**changes),
                        store=self._store, metrics=self.metrics,
                        device=self.device)

    def forget(self, *stages: str) -> int:
        """Drop memoized artifacts of the named stages ("pnr", "sched",
        "sim", ...); returns the number of entries evicted.

        The repeat-based benchmarks use this to re-run a stage cold N
        times from the same shared upstream artifacts — the memo would
        otherwise answer every repeat after the first from the store.
        """
        victims = [k for k in self._store
                   if isinstance(k, tuple) and k and k[0] in stages]
        for k in victims:
            del self._store[k]
        return len(victims)

    def _memo(self, key: Tuple, stage: str, thunk: Callable[[], Any],
              **attrs: Any) -> Any:
        if key not in self._store:
            self.metrics.inc(f"memo.miss.{stage}")
            with span(f"{stage}.work", **attrs):
                self._store[key] = thunk()
            self.stats[stage] += 1
        else:
            self.metrics.inc(f"memo.hit.{stage}")
        return self._store[key]

    # -- per-unit fault isolation ------------------------------------------
    def _isolating(self) -> bool:
        return self.config.on_error == "isolate"

    def _record_failure(self, stage: str, exc: BaseException, *,
                        pe: str = "", app: str = "",
                        retried: bool = False) -> StageFailure:
        f = StageFailure.from_exception(stage, exc, pe_name=pe, app=app,
                                        retried=retried)
        self.failures.append(f)
        self.metrics.inc(f"failures.{stage}")
        if isinstance(exc, BudgetExceeded):
            self.metrics.inc(f"budget_exhausted.{stage}")
        obs_event("stage.failure", stage=stage, pe=pe, app=app,
                  error=f.error_type)
        return f

    def _retry(self, stage: str, thunk: Callable[[], Any], *,
               pe: str = "", app: str = "") -> Any:
        """Serial retry after a first failure; second failure becomes a
        StageFailure row and the :data:`_FAILED` sentinel."""
        self.metrics.inc(f"isolate.retry.{stage}")
        try:
            faultinject.fire(f"{stage}.retry", pe=pe, app=app)
            return thunk()
        except Exception as e:
            self._record_failure(stage, e, pe=pe, app=app, retried=True)
            return _FAILED

    def _attempt(self, stage: str, thunk: Callable[[], Any], *,
                 pe: str = "", app: str = "") -> Any:
        """One unit of per-pair/per-app work: fire the stage's fault site,
        run; on failure (isolate mode) retry once, then degrade to a
        StageFailure + sentinel.  In ``on_error="raise"`` mode the first
        failure propagates (the legacy behavior)."""
        try:
            faultinject.fire(stage, pe=pe, app=app)
            return thunk()
        except Exception:
            if not self._isolating():
                raise
            return self._retry(stage, thunk, pe=pe, app=app)

    def _memo_iso(self, key: Tuple, stage: str, thunk: Callable[[], Any],
                  *, pe: str = "", app: str = "", **attrs: Any) -> Any:
        """:meth:`_memo` with fault isolation: a unit that fails twice is
        recorded and returns :data:`_FAILED` instead of raising; failures
        are never memoized, so a later run recomputes them."""
        if key in self._failed:              # degraded earlier this run
            return _FAILED
        if key in self._store:
            self.metrics.inc(f"memo.hit.{stage}")
            return self._store[key]
        self.metrics.inc(f"memo.miss.{stage}")
        with span(f"{stage}.work", **attrs):
            val = self._attempt(stage, thunk, pe=pe, app=app)
        if val is _FAILED:
            self._failed.add(key)
            return _FAILED
        self._store[key] = val
        self.stats[stage] += 1
        return val

    # -- stages ------------------------------------------------------------
    def mine(self) -> Dict[str, List[MinedSubgraph]]:
        """Mined subgraphs per app; a twice-failing app becomes a
        StageFailure and drops out of the run (isolate mode)."""
        cfg = self.config
        out = {}
        with span("mine"), stage_memory(self.metrics, "mine"):
            for name, app in self.apps.items():
                key = ("mine", self._app_keys[name], _mining_fields(cfg))
                v = self._memo_iso(
                    key, "mine",
                    lambda a=app: mine_frequent_subgraphs(a, cfg.mining),
                    app=name)
                if v is not _FAILED:
                    out[name] = v
        return out

    def rank(self) -> Dict[str, List[MinedSubgraph]]:
        mined = self.mine()
        out = {}
        with span("rank"), stage_memory(self.metrics, "rank"):
            for name in self.apps:
                if name not in mined:        # failed upstream
                    continue
                key = ("rank", self._app_keys[name],
                       _mining_fields(self.config))
                v = self._memo_iso(
                    key, "rank", lambda n=name: rank_by_mis(
                        [m for m in mined[n] if is_pe_pattern(m.pattern)]),
                    app=name)
                if v is not _FAILED:
                    out[name] = v
        return out

    def _merge_key(self, name: Optional[str] = None) -> Tuple:
        cfg = self.config
        if cfg.mode == "per_app":
            return ("merge", self._app_keys[name], _mining_fields(cfg),
                    cfg.max_merge, cfg.rank_mode, cfg.validate)
        return ("merge_domain", tuple(sorted(self._app_keys.items())),
                _mining_fields(cfg), cfg.per_app_subgraphs, cfg.domain_name,
                cfg.validate)

    def merge(self) -> Dict[str, List[PEVariant]]:
        """Variant templates per app name (one shared list in domain mode).

        The returned PEVariant objects are memoized templates; ``run()``
        wraps them in fresh containers before attaching costs.
        """
        ranked = self.rank()
        cfg = self.config
        with span("merge"), stage_memory(self.metrics, "merge"):
            if cfg.mode == "per_app":
                out = {}
                for name in self.apps:
                    if name not in ranked:   # failed upstream
                        continue
                    v = self._memo_iso(
                        self._merge_key(name), "merge",
                        lambda n=name: build_variants(
                            n, self.apps[n], ranked[n],
                            max_merge=cfg.max_merge,
                            rank_mode=cfg.rank_mode,
                            validate=cfg.validate),
                        app=name)
                    if v is not _FAILED:
                        out[name] = v
                return out
            variant = self._memo_iso(
                self._merge_key(), "merge",
                lambda: self._build_domain_variant(ranked),
                pe=cfg.domain_name, domain=cfg.domain_name)
        if variant is _FAILED:               # the whole domain degraded
            return {cfg.domain_name: []}
        return {cfg.domain_name: [variant]}

    def _build_domain_variant(self, ranked) -> PEVariant:
        """Cross-application PE (paper's PE IP / PE ML, Sec. V-B)."""
        cfg = self.config
        all_ops = set()
        for app in self.apps.values():
            all_ops |= app_ops(app)
        dp = baseline_datapath(all_ops)
        merged: List[str] = []
        seen_labels = set()
        for name, ranked_app in sorted(ranked.items()):
            usable = _dedup_keep_maximal(ranked_app)
            count = 0
            for m in usable:
                if count >= cfg.per_app_subgraphs:
                    break
                if m.label in seen_labels:
                    count += 1       # another app already contributed it
                    continue
                seen_labels.add(m.label)
                cfg_name = f"sg:{name}:{count}"
                add_pattern(dp, m.pattern, cfg_name, validate=cfg.validate)
                merged.append(cfg_name)
                count += 1
        return PEVariant(cfg.domain_name, dp, merged)

    def _pairs(self) -> List[Tuple[PEVariant, str, Tuple]]:
        """(variant template, app_name, map key) for every evaluated pair."""
        cfg = self.config
        variants = self.merge()
        out = []
        if cfg.mode == "per_app":
            for name in self.apps:
                if name not in variants:     # failed upstream
                    continue
                mk = self._merge_key(name)
                for v in variants[name]:
                    out.append((v, name, ("map", mk, v.name,
                                          self._app_keys[name])))
        else:
            mk = self._merge_key()
            for v in variants[cfg.domain_name]:
                for name in self.apps:
                    out.append((v, name, ("map", mk, v.name,
                                          self._app_keys[name])))
        return out

    def map(self) -> Dict[Pair, Mapping]:
        out = {}
        with span("map"), stage_memory(self.metrics, "map"):
            for v, app_name, key in self._pairs():
                m = self._memo_iso(
                    key, "map", lambda v=v, a=app_name: map_application(
                        v.datapath, self.apps[a], a),
                    pe=v.name, app=app_name)
                if m is not _FAILED:
                    out[(v.name, app_name)] = m
        return out

    def _cost(self, v: PEVariant, app_name: str, map_key: Tuple) -> AppCost:
        mapping = self._store[map_key]
        return self._memo(("cost",) + map_key[1:], "cost",
                          lambda: evaluate_mapping(v.datapath, mapping,
                                                   v.name),
                          pe=v.name, app=app_name)

    def pnr(self) -> Dict[Pair, "PnRResult"]:
        """Array-level place-and-route for every pair — batch-first.

        Gathers every pair missing from the memo, lowers all netlists,
        groups them by bucket signature, and anneals each group's chains
        in one kernel launch (``pnr_batch="grouped"``).  Non-"jax"
        backends and ``pnr_batch="serial"`` fall back to the per-pair
        loop.  ``pnr_mode="hierarchical"`` is not ported yet and raises.
        """
        from ..fabric import HIERARCHICAL_NOT_PORTED

        cfg = self.config
        options = cfg.fabric
        if options is None:
            raise ValueError("pnr stage requires config.fabric")
        if cfg.pnr_mode == "hierarchical":
            raise NotImplementedError(HIERARCHICAL_NOT_PORTED)
        mappings = self.map()
        sig = _pnr_fields(options, cfg.pnr_batch, cfg.pnr_mode)

        keys: Dict[Pair, Tuple] = {}
        misses = []
        for v, app_name, map_key in self._pairs():
            if (v.name, app_name) not in mappings:   # failed upstream
                continue
            key = ("pnr", map_key[1:], sig)
            if key in self._failed:          # degraded earlier this run
                continue
            keys[(v.name, app_name)] = key
            if key not in self._store:
                misses.append((v, app_name, key))
                self.metrics.inc("memo.miss.pnr")
            else:
                self.metrics.inc("memo.hit.pnr")

        grouped = (cfg.pnr_batch == "grouped" and options.backend == "jax"
                   and options.hpwl_backend == "jnp"
                   and cfg.pnr_mode == "flat")
        dev = self.device
        with span("pnr", pairs=len(keys), misses=len(misses)), \
                stage_memory(self.metrics, "pnr"):
            if misses and grouped:
                items = [(v.name, v.datapath, mappings[(v.name, a)],
                          self.apps[a], zlib.crc32(repr(key).encode()))
                         for v, a, key in misses]
                pnrs = pnr_grouped(items, options, self.stats,
                                   isolate=self._isolating(), device=dev)
                for (v, a, key), pnr in zip(misses, pnrs):
                    if isinstance(pnr, Exception):
                        # fell out of its batch group: one serial retry,
                        # then a StageFailure row — groupmates unaffected
                        pnr = self._retry(
                            "pnr", lambda v=v, a=a: _pnr_pair(
                                v.name, v.datapath, mappings[(v.name, a)],
                                self.apps[a], options, cfg.pnr_mode, dev),
                            pe=v.name, app=a)
                        if pnr is _FAILED:
                            self._failed.add(key)
                            continue
                        self.stats["pnr_dispatch"] += 1
                    self._store[key] = pnr
                    self.stats["pnr"] += 1
            elif misses:
                for v, a, key in misses:
                    with span("pnr.pair", pe=v.name, app=a):
                        pnr = self._attempt(
                            "pnr", lambda v=v, a=a: _pnr_pair(
                                v.name, v.datapath, mappings[(v.name, a)],
                                self.apps[a], options, cfg.pnr_mode, dev),
                            pe=v.name, app=a)
                    if pnr is _FAILED:
                        self._failed.add(key)
                        continue
                    self._store[key] = pnr
                    self.stats["pnr"] += 1
                    self.stats["pnr_dispatch"] += 1
        return {pair: self._store[key] for pair, key in keys.items()
                if key in self._store}

    def schedule(self) -> Dict[Pair, Any]:
        """Modulo scheduling — not ported yet."""
        raise NotImplementedError(SIMULATE_NOT_PORTED)

    def simulate(self) -> Dict[Pair, int]:
        """Cycle-accurate simulation — not ported yet."""
        raise NotImplementedError(SIMULATE_NOT_PORTED)

    # -- full pipeline -----------------------------------------------------
    def run(self) -> ExploreResult:
        cfg = self.config
        self.failures = []               # per-run; stages re-attempt what
        self._failed.clear()             # failed last time (never memoized)
        if cfg.simulate:
            self.schedule()              # raises: not ported yet
        t0 = time.monotonic()
        with span("explore.run", mode=cfg.mode):
            ranked = self.rank()
            variants = self.merge()
            self.map()
            pnrs = self.pnr() if cfg.fabric is not None else {}
        elapsed = time.monotonic() - t0

        def fresh(v: PEVariant, app_names) -> PEVariant:
            out = PEVariant(v.name, v.datapath, list(v.merged_subgraphs))
            for a in app_names:
                mk = ("map", self._merge_key(
                    a if cfg.mode == "per_app" else None), v.name,
                    self._app_keys[a])
                if mk not in self._store:    # pair failed the map stage
                    continue
                cost = _dc_replace(self._cost(v, a, mk))
                if (v.name, a) in pnrs:
                    from ..fabric.cost import attach_fabric
                    out.fabric_costs[a] = pnrs[(v.name, a)].cost
                    attach_fabric(cost, pnrs[(v.name, a)].cost)
                out.costs[a] = cost
            return out

        # every DSEResult carries the whole run's elapsed time: stages are
        # batched across apps, so per-app wall time is not separable (the
        # legacy driver timed each app's serial loop individually)
        results: Dict[str, DSEResult] = {}
        if cfg.mode == "per_app":
            for name, app in self.apps.items():
                if name not in variants:     # app degraded upstream
                    continue
                results[name] = DSEResult(
                    {name: app}, {name: ranked.get(name, [])},
                    [fresh(v, [name]) for v in variants[name]], elapsed)
        else:
            results[cfg.domain_name] = DSEResult(
                dict(self.apps), ranked,
                [fresh(v, sorted(self.apps)) for v in
                 variants[cfg.domain_name]], elapsed)
        return ExploreResult(cfg, _digest(cfg.to_dict()), dict(self.apps),
                             results, elapsed, {},
                             self.metrics.to_dict(), list(self.failures))

