"""Deprecated import path for the LM demo engine.

``repro_torch.serve`` names the exploration serving subsystem (async
front-end + cross-request continuous batching over the Explorer); the
token-decode demo lives in :mod:`repro_torch.serve.lm_engine`.
Importing through this path keeps working but warns
``DeprecationWarning``.
"""

from __future__ import annotations

import warnings

warnings.warn(
    "repro_torch.serve.engine is deprecated: the LM demo moved to "
    "repro_torch.serve.lm_engine; repro_torch.serve now names the "
    "exploration serving subsystem (ExploreService / ContinuousBatcher)",
    DeprecationWarning, stacklevel=2)

from .lm_engine import Request, ServeEngine  # noqa: E402,F401

__all__ = ["Request", "ServeEngine"]
