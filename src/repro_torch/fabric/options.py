"""Bundled fabric/simulation options for DSE sweeps.

``core.dse`` grew one ``fabric_*`` kwarg per place-and-route knob; with the
time-domain subsystem adding scheduler/simulator knobs, the loose kwargs
are folded into one :class:`FabricOptions` record.  The legacy kwargs are
still accepted by the DSE entry points and folded into an options object,
so existing call sites keep working.
"""

from __future__ import annotations

import warnings
from dataclasses import asdict, dataclass, fields, replace
from typing import Any, Dict, Optional

from .arch import FabricSpec


@dataclass(frozen=True)
class FabricOptions:
    """Everything array-level evaluation needs, in one place.

    spec           — the target array (auto-grown per variant when needed).
    backend        — annealing engine: "jax" (batched chains; the name of
                     the device annealer, kept so configs and records
                     equal the JAX package's) | "python".
    hpwl_backend   — placement cost kernel of the JAX package: "jnp" |
                     "pallas".  Both select the same scoring kernels here;
                     the field stays so config blobs and memo keys match.
    score_mode     — move scoring: "delta" (incremental — rescore only the
                     nets the swap touches; the default and the only mode
                     that scales past ~32x32) | "full" (recompute every
                     net per move; debug fallback — bit-identical
                     placements at equal seeds).
    chains/sweeps/seed — annealing budget and determinism.
    simulate       — run the modulo scheduler + cycle-accurate simulator on
                     every (variant, app) mapping and attach measured
                     throughput (``sim_*`` fields) to the AppCost records.
    sim_iterations/sim_batch — pipelined iterations x input batches fed to
                     the simulator (also drives the golden check).
    sim_backend    — tile-step dispatch of the JAX package: "jax" |
                     "pallas" (the simulate stage is not ported yet).
    sim_verify     — bit-compare simulated outputs against graphir.interp
                     and record the result (raises on mismatch).

    Budgets (all deterministic, all default-off / legacy-default so
    results are bit-identical unless a budget is actually exhausted; on
    exhaustion the stage raises :class:`repro_torch.errors.BudgetExceeded`
    instead of looping or hanging):

    sched_max_ii        — cap on the modulo scheduler's II search (None =
                          the legacy mii + n_ops + 1 bound).
    sched_budget_factor — scheduler eviction budget multiplier (budget =
                          factor * n_ops + 64 evictions per II; 8 is the
                          legacy constant).
    anneal_max_states   — cap on chains x sweeps x n_entities per anneal
                          problem, checked *before* dispatch (None = off).
    sim_max_cycles      — cap on total simulated cycles per program,
                          checked before dispatch (None = off).
    """

    spec: Optional[FabricSpec] = None
    backend: str = "jax"
    hpwl_backend: str = "jnp"
    score_mode: str = "delta"
    chains: int = 16
    sweeps: int = 32
    seed: int = 0
    simulate: bool = False
    sim_iterations: int = 3
    sim_batch: int = 2
    sim_backend: str = "jax"
    sim_verify: bool = True
    sched_max_ii: Optional[int] = None
    sched_budget_factor: int = 8
    anneal_max_states: Optional[int] = None
    sim_max_cycles: Optional[int] = None

    def with_spec(self, spec: FabricSpec) -> "FabricOptions":
        return replace(self, spec=spec)

    def input_seed(self, nonce: int) -> int:
        """RNG seed for one pair's golden-check test vectors.

        Folding a content-derived nonce (hash of the (variant, app) pair)
        into the configured seed makes every pair's vectors — and so its
        simulated outputs — a function of the pair alone: the same whether
        the pair simulates per-pair, shares a batched dispatch, or rides a
        differently-composed bucket (the same contract
        :func:`repro_torch.fabric.place.anneal_jax_batch` keeps for placements).
        """
        return (self.seed ^ (nonce & 0x7FFFFFFF)) & 0x7FFFFFFF

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready dict; inverse of :meth:`from_dict`."""
        d = asdict(self)
        d["spec"] = None if self.spec is None else asdict(self.spec)
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "FabricOptions":
        d = dict(d)
        spec = d.pop("spec", None)
        known = {f.name for f in fields(FabricOptions)} - {"spec"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FabricOptions fields {sorted(unknown)}")
        return FabricOptions(
            spec=None if spec is None else FabricSpec(**spec), **d)

    @staticmethod
    def coerce(fabric, *, backend: Optional[str] = None,
               chains: Optional[int] = None, sweeps: Optional[int] = None,
               seed: Optional[int] = None,
               simulate: bool = False) -> Optional["FabricOptions"]:
        """Normalize the legacy ``fabric=FabricSpec(...)`` + ``fabric_*``
        kwarg style (and plain None) into a FabricOptions or None.

        Legacy kwargs left at None fall back to the FabricOptions field
        defaults; passing any of them alongside a FabricOptions object is
        an error rather than a silent discard.
        """
        legacy = {"fabric_backend": backend, "fabric_chains": chains,
                  "fabric_sweeps": sweeps, "fabric_seed": seed}
        if fabric is None:
            if simulate:
                raise ValueError("simulate=True requires a fabric "
                                 "(pass FabricOptions or FabricSpec)")
            return None
        if isinstance(fabric, FabricOptions):
            overridden = [k for k, v in legacy.items() if v is not None]
            if overridden:
                raise ValueError(
                    f"legacy kwargs {overridden} are ignored when passing a "
                    f"FabricOptions — set those fields on the options object")
            return replace(fabric, simulate=fabric.simulate or simulate)
        if isinstance(fabric, FabricSpec):
            passed = [k for k, v in legacy.items() if v is not None]
            if passed:
                warnings.warn(
                    f"the loose {passed} kwargs are deprecated; pass "
                    f"fabric=FabricOptions(spec=..., ...) (or use "
                    f"repro_torch.explore.ExploreConfig) instead",
                    DeprecationWarning, stacklevel=3)
            defaults = FabricOptions()
            return FabricOptions(
                spec=fabric,
                backend=defaults.backend if backend is None else backend,
                chains=defaults.chains if chains is None else chains,
                sweeps=defaults.sweeps if sweeps is None else sweeps,
                seed=defaults.seed if seed is None else seed,
                simulate=simulate)
        raise TypeError(f"fabric must be FabricSpec or FabricOptions, "
                        f"got {type(fabric).__name__}")
