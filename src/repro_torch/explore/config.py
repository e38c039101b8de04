"""One frozen config object for a whole exploration.

The paper's flow (Sec. IV, Fig. 6) is a fixed pipeline — mine -> rank ->
merge -> map -> evaluate — but the original driver threaded one keyword
argument per subsystem through three layers.  :class:`ExploreConfig`
bundles every knob (mining budget, merge/rank options, fabric
place-and-route, time-domain simulation) into a single dataclass with a
JSON round trip, so an exploration is reproducible from one blob::

    cfg = ExploreConfig(mode="per_app", mining=MiningConfig(min_support=3),
                        fabric=FabricOptions(spec=FabricSpec(rows=8, cols=8),
                                             simulate=True))
    json.dump(cfg.to_dict(), open("explore.json", "w"))
    cfg2 = ExploreConfig.from_dict(json.load(open("explore.json")))
    assert cfg2 == cfg
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field, fields, replace
from typing import Any, Dict, Optional

from ..core.mining import MiningConfig
from ..fabric.options import FabricOptions

#: bump when a field is added/renamed/retyped; from_dict rejects unknown
#: versions so stale blobs fail loudly instead of silently defaulting
#: (2: added sim_batch — batch-first schedule/simulate stages)
#: (3: added on_error — per-pair fault isolation policy)
#: (4: added pnr_mode — flat vs hierarchical placement)
CONFIG_SCHEMA = 4

MODES = ("per_app", "domain")
PNR_BATCH_MODES = ("grouped", "serial")
PNR_MODES = ("flat", "hierarchical")
SIM_BATCH_MODES = ("grouped", "serial")
ON_ERROR_MODES = ("isolate", "raise")


class ConfigFormatError(ValueError):
    """An ExploreConfig blob that can't be parsed — reported as a
    one-line error by the CLI, never a stack trace."""


@dataclass(frozen=True)
class ExploreConfig:
    """Everything one DSE run needs, in one place.

    mode              — "per_app" (PE1..PE(1+max_merge) per application,
                        paper Sec. V-A) | "domain" (one cross-application
                        PE IP / PE ML, Sec. V-B).
    mining            — frequent-subgraph mining budget (Sec. III-A).
    max_merge         — subgraphs merged per app in per_app mode.
    rank_mode         — "mis" (paper order) | "utility" (beyond-paper).
    validate          — prove each merged config executes its pattern.
    per_app_subgraphs — subgraphs each app contributes in domain mode.
    domain_name       — the domain variant's PE name.
    fabric            — array-level evaluation (place-and-route and, with
                        ``fabric.simulate``, modulo scheduling + cycle-
                        accurate simulation); None = per-tile model only.
    pnr_batch         — "grouped": all (variant, app) placements of one
                        bucket signature anneal in one JAX dispatch
                        (:func:`repro_torch.fabric.place.anneal_jax_batch`);
                        "serial": one dispatch per pair (the legacy loop —
                        bit-identical to the pre-``repro_torch.explore`` driver).
    pnr_mode          — "flat": single-level anneal over the whole array
                        (the default; bit-identical to every build before
                        this field existed); "hierarchical": two-level
                        cluster -> detail -> deblock flow
                        (:func:`repro_torch.fabric.place.place_hierarchical`)
                        for mega-fabrics.  Hierarchical pairs run on the
                        serial dispatch path (each placement is already
                        internally batched across its clusters), so
                        ``pnr_batch="grouped"`` is ignored for them.
    sim_batch         — "grouped": modulo scheduling runs its slot-conflict
                        scans in lockstep across pairs sharing a fabric
                        signature, and all simulations of one bucket
                        signature ride ONE vmapped ``lax.scan``
                        (:func:`repro_torch.sim.simulate_batch`); "serial": the
                        per-pair schedule + one-compile-per-program loop.
                        Both modes produce bit-identical schedules and
                        simulated outputs.  (Distinct from
                        ``FabricOptions.sim_batch``, the *input batch
                        size* fed to each simulation.)
    on_error          — "isolate": a failing (variant, app) pair falls
                        out of its batch group, is retried once on the
                        serial path, and on second failure becomes a
                        structured StageFailure row while groupmates
                        complete (the pow2-bucket independence invariant
                        makes this safe); "raise": legacy behavior, the
                        first failure propagates and kills the run.
    """

    mode: str = "per_app"
    mining: MiningConfig = field(default_factory=MiningConfig)
    max_merge: int = 4
    rank_mode: str = "mis"
    validate: bool = True
    per_app_subgraphs: int = 2
    domain_name: str = "PE_DOM"
    fabric: Optional[FabricOptions] = None
    pnr_batch: str = "grouped"
    pnr_mode: str = "flat"
    sim_batch: str = "grouped"
    on_error: str = "isolate"

    def __post_init__(self) -> None:
        if self.pnr_mode not in PNR_MODES:
            raise ValueError(f"pnr_mode must be one of {PNR_MODES}, "
                             f"got {self.pnr_mode!r}")
        if self.on_error not in ON_ERROR_MODES:
            raise ValueError(f"on_error must be one of {ON_ERROR_MODES}, "
                             f"got {self.on_error!r}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.pnr_batch not in PNR_BATCH_MODES:
            raise ValueError(f"pnr_batch must be one of {PNR_BATCH_MODES}, "
                             f"got {self.pnr_batch!r}")
        if self.sim_batch not in SIM_BATCH_MODES:
            raise ValueError(f"sim_batch must be one of {SIM_BATCH_MODES}, "
                             f"got {self.sim_batch!r}")
        if self.rank_mode not in ("mis", "utility"):
            raise ValueError(f"unknown rank_mode {self.rank_mode!r}")
        if self.simulate and self.fabric is None:
            raise ValueError("simulation requires a fabric")

    @property
    def simulate(self) -> bool:
        return self.fabric is not None and self.fabric.simulate

    def replace(self, **changes: Any) -> "ExploreConfig":
        return replace(self, **changes)

    # -- JSON round trip ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["mining"] = asdict(self.mining)
        d["fabric"] = None if self.fabric is None else self.fabric.to_dict()
        d["schema"] = CONFIG_SCHEMA
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ExploreConfig":
        if not isinstance(d, dict):
            raise ConfigFormatError(
                f"ExploreConfig blob must be an object, got "
                f"{type(d).__name__}")
        d = dict(d)
        schema = d.pop("schema", CONFIG_SCHEMA)
        if schema != CONFIG_SCHEMA:
            raise ConfigFormatError(
                f"ExploreConfig schema {schema!r} not supported (this build "
                f"reads schema {CONFIG_SCHEMA}) — regenerate the blob with "
                f"ExploreConfig.to_dict() from a matching build")
        known = {f.name for f in fields(ExploreConfig)}
        unknown = set(d) - known
        if unknown:
            raise ConfigFormatError(
                f"unknown ExploreConfig fields {sorted(unknown)} — "
                f"known fields are {sorted(known)}")
        for name, want in (("mode", str), ("max_merge", int),
                           ("rank_mode", str), ("validate", bool),
                           ("per_app_subgraphs", int), ("domain_name", str),
                           ("pnr_batch", str), ("pnr_mode", str),
                           ("sim_batch", str), ("on_error", str)):
            if name in d and (not isinstance(d[name], want)
                              or (want is int and isinstance(d[name], bool))):
                raise ConfigFormatError(
                    f"ExploreConfig field {name!r} must be "
                    f"{want.__name__}, got {type(d[name]).__name__} "
                    f"({d[name]!r})")
        mining = d.pop("mining", None)
        fabric = d.pop("fabric", None)
        if mining is not None and not isinstance(mining, dict):
            raise ConfigFormatError(
                f"ExploreConfig field 'mining' must be an object, got "
                f"{type(mining).__name__}")
        if fabric is not None and not isinstance(fabric, dict):
            raise ConfigFormatError(
                f"ExploreConfig field 'fabric' must be an object or null, "
                f"got {type(fabric).__name__}")
        try:
            return ExploreConfig(
                mining=MiningConfig(**mining) if mining else MiningConfig(),
                fabric=(None if fabric is None
                        else FabricOptions.from_dict(fabric)),
                **d)
        except (TypeError, ValueError) as e:
            if isinstance(e, ConfigFormatError):
                raise
            raise ConfigFormatError(f"bad ExploreConfig blob: {e}")
