"""Cross-request continuous batching over the exploration pipeline.

Many concurrent clients submit :class:`~repro_torch.serve.protocol.
ServeRequest` objects; the :class:`ContinuousBatcher` coalesces them so
the expensive device stages run as few kernel launches as the union of
their work allows:

* **response cache** — a request whose content key (config digest +
  app fingerprints) was already answered returns in microseconds,
  without touching the queue or the card;
* **in-flight coalescing** — identical requests arriving while the
  first is queued/executing await the same future and share one
  computation;
* **admission queue** — bounded (``queue_limit`` tickets); a full
  queue makes ``submit`` wait (backpressure) or raise
  :class:`QueueFull` when ``block=False``;
* **continuous batching** — pending tickets with the same config are
  merged into one :class:`~repro_torch.explore.Explorer` run over the
  union of their apps when enough work accumulates (``max_batch_apps``)
  or the oldest ticket's ``max_wait_s`` deadline expires.  The
  Explorer's batch-first pnr/schedule/simulate stages then group the
  merged (variant, app) pairs by pow2 bucket signature, so strangers'
  pairs share one launch of the annealing kernel (K2) per pnr bucket
  and one of the cycle stepper (K3) per sim bucket.

The whole scheme is sound because of the pipeline's content-key +
content-nonce discipline: in ``per_app`` mode every stage artifact of an
app depends only on that app's graph and the config, and every pair's
anneal chains / golden inputs are seeded from its own content nonce —
so a request's records are **byte-identical** whether it runs solo,
batched with strangers, or is answered from cache.  ``domain`` mode
merges *across* apps, so domain tickets never share a batch: each
flushes as its own solo Explorer run.

Failure containment: batches run with ``on_error="isolate"`` (the
service normalizes configs at admission), so a poisoned pair degrades to
its own :class:`~repro_torch.explore.records.StageFailure` rows without
touching batchmates.  A catastrophic batch error (the Explorer itself
raising) re-runs each ticket solo before giving up on any of them.

The device is resolved once, when the batcher is built (``device``,
default ``"cuda"``): without a card that raises there, never later in
the worker thread, where a batch error would become per-request error
replies.  ``device="cpu"`` runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..device import resolve_device
from ..explore import ExploreResult, Explorer
from ..explore.pipeline import graph_key
from ..explore.records import ExploreRecord, StageFailure
from ..obs import event as obs_event, span
from ..obs.metrics import MetricsRegistry
from .protocol import ServeRequest

__all__ = ["ContinuousBatcher", "QueueFull", "ticket_records",
           "ticket_failures"]


class QueueFull(RuntimeError):
    """Admission queue at ``queue_limit`` and ``block=False``."""


def ticket_records(result: ExploreResult,
                   request: ServeRequest) -> List[ExploreRecord]:
    """One ticket's record rows out of a (possibly merged) run — in
    exactly the order ``Explorer(request.apps, request.config).run().
    records()`` would produce them, which is what the bit-identity
    guarantee is asserted on.

    ``per_app`` mode: a solo run's results dict iterates the request's
    apps in insertion order with one single-app DSEResult each, so we
    walk ``request.apps`` and pick each app's result out of the merged
    run.  ``domain`` tickets always run solo (their merge is cross-app),
    so the run's own view already matches.
    """
    if result.config.mode != "per_app":
        return result.records()
    buckets = result.sim_buckets or {}
    rows: List[ExploreRecord] = []
    for app_name in request.apps:
        res = result.results.get(app_name)
        if res is None:                      # app degraded upstream
            continue
        for v in res.variants:
            if app_name not in v.costs:
                continue
            rows.append(ExploreRecord.from_cost(
                v.costs[app_name], mode=result.config.mode,
                config_key=result.config_key,
                n_merged=len(v.merged_subgraphs),
                sim_bucket=buckets.get((v.name, app_name), "")))
    return rows


def ticket_failures(result: ExploreResult,
                    request: ServeRequest) -> List[StageFailure]:
    """The merged run's StageFailure rows that belong to one ticket."""
    if result.config.mode != "per_app":
        return list(result.failures or ())
    return [f for f in (result.failures or ())
            if f.app in request.apps]


@dataclass
class _Ticket:
    """One admitted request waiting for (or riding) a batch."""

    request: ServeRequest
    key: Tuple
    group: str                       # batch group: the config digest
    solo: bool                       # domain mode: never share a batch
    future: "asyncio.Future[Tuple[list, list]]"
    enqueued: float                  # loop.time() at admission
    app_keys: Dict[str, str] = field(default_factory=dict)


class ContinuousBatcher:
    """Admission queue + flush loop + batch executor.

    ``await submit(request)`` is the whole client API; ``start()`` /
    ``aclose()`` bracket the flush loop (or use ``async with``).  The
    batch itself runs in a worker thread (``run_in_executor``) so the
    event loop keeps admitting clients while the card works; batches are
    serialized — one Explorer run at a time — which is the right shape
    for a single accelerator, keeps the shared memo store single-writer
    within this process and the kernels' launch counters exact.
    """

    def __init__(self, store: Optional[Dict] = None, *,
                 max_batch_apps: int = 8, max_wait_s: float = 0.05,
                 queue_limit: int = 32, cache_limit: int = 256,
                 metrics: Optional[MetricsRegistry] = None,
                 device="cuda") -> None:
        self.device = resolve_device(device)
        if max_batch_apps < 1:
            raise ValueError("max_batch_apps must be >= 1")
        if queue_limit < 1:
            raise ValueError("queue_limit must be >= 1")
        self._store: Dict = {} if store is None else store
        self.metrics = metrics or MetricsRegistry()
        self.max_batch_apps = max_batch_apps
        self.max_wait_s = max_wait_s
        self.queue_limit = queue_limit
        self.cache_limit = cache_limit
        self._pending: List[_Ticket] = []
        self._inflight: Dict[Tuple, asyncio.Future] = {}
        self._cache: Dict[Tuple, Tuple[list, list]] = {}
        self._depth = 0                       # admitted, not yet flushed
        self._slots: Optional[asyncio.Semaphore] = None
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._stopping = False

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "ContinuousBatcher":
        if self._task is not None:
            return self
        self._stopping = False
        self._slots = asyncio.Semaphore(self.queue_limit)
        self._wake = asyncio.Event()
        self._task = asyncio.ensure_future(self._run())
        return self

    async def aclose(self) -> None:
        """Flush everything still queued, then stop the loop."""
        if self._task is None:
            return
        self._stopping = True
        self._wake.set()
        try:
            await self._task
        finally:
            self._task = None

    async def __aenter__(self) -> "ContinuousBatcher":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    @property
    def queue_depth(self) -> int:
        return self._depth

    # -- client API --------------------------------------------------------
    async def submit(self, request: ServeRequest, *,
                     block: bool = True) -> Tuple[list, list, bool]:
        """One exploration: returns ``(records, failures, cached)`` where
        records/failures are plain row dicts.  Raises :class:`QueueFull`
        when the admission queue is full and ``block=False``; otherwise a
        full queue just delays admission (backpressure).
        """
        if self._task is None:
            raise RuntimeError("batcher is not started")
        self.metrics.inc("serve.requests")
        key = request.key()

        hit = self._cache.get(key)
        if hit is not None:
            self.metrics.inc("serve.cache_hit")
            obs_event("serve.cache_hit", rid=request.rid)
            return hit[0], hit[1], True

        fut = self._inflight.get(key)
        if fut is not None:                   # identical request in flight
            self.metrics.inc("serve.coalesced")
            records, failures = await asyncio.shield(fut)
            return records, failures, False

        if not block and self._depth >= self.queue_limit:
            self.metrics.inc("serve.rejected")
            raise QueueFull(
                f"admission queue full ({self.queue_limit} tickets)")
        await self._slots.acquire()
        self._depth += 1
        self.metrics.set_gauge("serve.queue_depth", self._depth)

        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        cfg = request.config
        ticket = _Ticket(
            request=request, key=key,
            group=key[0], solo=(cfg.mode != "per_app"),
            future=fut, enqueued=loop.time(),
            app_keys={n: graph_key(g) for n, g in request.apps.items()})
        self._inflight[key] = fut
        self._pending.append(ticket)
        self._wake.set()
        records, failures = await asyncio.shield(fut)
        return records, failures, False

    # -- flush loop --------------------------------------------------------
    async def _run(self) -> None:
        loop = asyncio.get_event_loop()
        while True:
            if not self._pending:
                if self._stopping:
                    return
                self._wake.clear()
                if self._pending:             # raced with a submit
                    continue
                await self._wake.wait()
                continue
            now = loop.time()
            batch = self._select_batch(now)
            if batch is None:
                oldest = min(t.enqueued for t in self._pending)
                delay = max(0.0, oldest + self.max_wait_s - now)
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), delay)
                except asyncio.TimeoutError:
                    pass
                continue
            await self._flush(batch, loop)

    def _select_batch(self, now: float) -> Optional[List[_Ticket]]:
        """The next batch to flush, or None if nothing is ready yet.

        A config group is ready when its pending apps reach
        ``max_batch_apps``, when its oldest ticket has waited
        ``max_wait_s``, or when the batcher is draining.  Tickets whose
        app *names* collide with a different graph already in the batch
        are deferred to a later flush (same name + same graph is fine —
        that's sharing, the point of batching).
        """
        ready: Dict[str, List[_Ticket]] = {}
        napps: Dict[str, int] = {}
        for t in self._pending:
            g = t.key if t.solo else t.group  # solo tickets: own group
            ready.setdefault(g, []).append(t)
            napps[g] = napps.get(g, 0) + len(t.request.apps)
        pick = None
        for g, tickets in ready.items():
            if (self._stopping or napps[g] >= self.max_batch_apps
                    or now - tickets[0].enqueued >= self.max_wait_s):
                if pick is None or tickets[0].enqueued < pick[0].enqueued:
                    pick = tickets
        if pick is None:
            return None

        batch: List[_Ticket] = []
        apps: Dict[str, str] = {}             # name -> graph fingerprint
        for t in pick:
            if batch and len(apps) >= self.max_batch_apps:
                break
            if any(apps.get(n, k) != k for n, k in t.app_keys.items()):
                self.metrics.inc("serve.deferred_conflict")
                continue                      # same name, different graph
            batch.append(t)
            apps.update(t.app_keys)
        return batch or None

    async def _flush(self, batch: List[_Ticket], loop) -> None:
        now = loop.time()
        for t in batch:
            self._pending.remove(t)
            self._depth -= 1
            self._slots.release()
            self.metrics.observe("serve.time_in_queue_ms",
                                 (now - t.enqueued) * 1e3)
        self.metrics.set_gauge("serve.queue_depth", self._depth)
        self.metrics.inc("serve.batches")
        self.metrics.observe("serve.batch_tickets", len(batch))
        napps = len({(n, k) for t in batch for n, k in t.app_keys.items()})
        self.metrics.observe("serve.batch_apps", napps)

        try:
            outs = await loop.run_in_executor(
                None, self._run_batch, batch)
        except Exception as e:
            if len(batch) == 1:
                self._resolve_error(batch[0], e)
                return
            # catastrophic merged-run failure: contain by re-running each
            # ticket alone so one poisoned request can't take down the rest
            self.metrics.inc("serve.batch_degraded")
            obs_event("serve.batch_degraded", tickets=len(batch),
                      error=type(e).__name__)
            for t in batch:
                try:
                    out = await loop.run_in_executor(
                        None, self._run_batch, [t])
                except Exception as solo_e:
                    self._resolve_error(t, solo_e)
                else:
                    self._resolve(t, out[0])
            return
        for t, out in zip(batch, outs):
            self._resolve(t, out)

    def _resolve(self, t: _Ticket, out: Tuple[list, list]) -> None:
        self._inflight.pop(t.key, None)
        self._cache[t.key] = out
        while len(self._cache) > self.cache_limit:   # FIFO eviction
            self._cache.pop(next(iter(self._cache)))
        if not t.future.done():
            t.future.set_result(out)

    def _resolve_error(self, t: _Ticket, exc: BaseException) -> None:
        self._inflight.pop(t.key, None)
        self.metrics.inc("serve.request_errors")
        if not t.future.done():
            t.future.set_exception(exc)

    # -- the batch itself (worker thread) ----------------------------------
    def _run_batch(self, batch: List[_Ticket]) -> List[Tuple[list, list]]:
        merged: Dict[str, Any] = {}
        for t in batch:
            merged.update(t.request.apps)
        cfg = batch[0].request.config         # group key = config digest
        ex = Explorer(merged, cfg, store=self._store, metrics=self.metrics,
                      device=self.device)
        with span("serve.batch", tickets=len(batch), apps=len(merged)):
            result = ex.run()
        return [([r.to_dict() for r in ticket_records(result, t.request)],
                 [f.to_dict() for f in ticket_failures(result, t.request)])
                for t in batch]
