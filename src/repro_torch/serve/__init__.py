"""Explorer-as-a-service: async front-end + cross-request batching.

Many concurrent clients submit app-graph exploration requests (in-
process coroutines, or newline-delimited JSON over a socket / stdio);
the service deduplicates them against the Explorer's content-keyed memo
store — repeat requests answer from cache in milliseconds without
launching a kernel — and continuously batches the rest: pending
(variant, app) pairs from *different* requests are grouped by pow2
bucket signature and flushed through the batch-first
pnr/schedule/simulate stages together when a batch fills or the
max-wait deadline expires, so strangers share the annealing kernel's
(K2) and the cycle stepper's (K3) launches on the card.

Bit-identity guarantee: a request's records are byte-identical whether
it is served solo, batched with strangers, or answered from cache —
the pipeline's content-key memoization and content-nonce seeding make
results independent of dispatch grouping (``python -m repro_torch.serve
--smoke`` asserts this end to end).

Entry points::

    from repro_torch.serve import ExploreService
    async with ExploreService(store="memo/") as svc:      # device="cuda"
        resp = await svc.explore("r1", apps, config)

    python -m repro_torch.serve --port 7341 --store memo/   # NDJSON server
    python -m repro_torch.serve --smoke                     # self check

The token-decode LM demo lives in :mod:`repro_torch.serve.lm_engine`; the
package-level ``ServeEngine`` / ``Request`` names (and
``repro_torch.serve.engine``) still resolve but warn
``DeprecationWarning``, as the JAX package's do.
"""

from .batcher import ContinuousBatcher, QueueFull
from .frontend import ExploreService
from .protocol import (PROTOCOL_SCHEMA, ProtocolError, ServeRequest,
                       ServeResponse, encode_request, parse_request_line,
                       request_key)

__all__ = [
    "ContinuousBatcher", "QueueFull",
    "ExploreService",
    "PROTOCOL_SCHEMA", "ProtocolError", "ServeRequest", "ServeResponse",
    "encode_request", "parse_request_line", "request_key",
    # deprecated LM-demo names, resolved lazily with a warning:
    "Request", "ServeEngine",
]


def __getattr__(name):
    if name in ("Request", "ServeEngine"):
        import warnings
        warnings.warn(
            f"repro_torch.serve.{name} is deprecated: the LM demo moved to "
            f"repro_torch.serve.lm_engine (repro_torch.serve now names the "
            f"exploration serving subsystem)",
            DeprecationWarning, stacklevel=2)
        from . import lm_engine
        return getattr(lm_engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
