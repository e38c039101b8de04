"""Shared exception taxonomy for failure-tolerant pipelines.

Every subsystem that can exhaust a budget or hit an injected fault
raises one of these, so the exploration pipeline's per-pair isolation
layer (:mod:`repro_torch.explore.pipeline`) can classify a failure into a
structured :class:`repro_torch.explore.records.StageFailure` row without
string-matching messages.  They live at the package root because both
low-level subsystems (``fabric``, ``sim``) and the pipeline above them
need the same types without circular imports.
"""

from __future__ import annotations

from typing import Any, Dict

__all__ = ["BudgetExceeded", "InjectedFault", "StoreCorruption"]


class BudgetExceeded(RuntimeError):
    """An explicit stage budget ran out — graceful degradation, not a hang.

    Raised instead of looping forever (scheduler II search / eviction
    budget) or instead of launching work known to be over budget (anneal
    state budget, simulate cycle cap).  ``budget`` carries the budget
    state at exhaustion for the failure row.
    """

    def __init__(self, message: str, **budget: Any) -> None:
        super().__init__(message)
        self.budget: Dict[str, Any] = dict(budget)


class InjectedFault(RuntimeError):
    """A deliberately injected failure (:mod:`repro_torch.faultinject`)."""


class StoreCorruption(ValueError):
    """A persistent-store entry failed its checksum / decode — the entry
    is quarantined and recomputed, never trusted."""
