"""Async front-end for explorer-as-a-service.

:class:`ExploreService` wraps a :class:`~repro_torch.serve.batcher.
ContinuousBatcher` with the two client surfaces:

* **in-process** — ``await service.explore(apps, config)`` (or
  ``submit_request`` with a pre-built :class:`ServeRequest`) from any
  number of concurrent asyncio clients;
* **wire** — newline-delimited JSON over a TCP socket
  (``serve_tcp``) or stdio (``serve_stdio``): one request object per
  line in, one response object per line out, connections multiplexed
  onto the same batcher so strangers on different sockets still share
  dispatches.

Admission normalizes every request's config to ``on_error="isolate"``
(the Explorer's fault containment): one client's poisoned graph
degrades to StageFailure rows in *that client's* response, never an
exception in a batchmate's.  Persistent stores (``store=`` a directory
path) ride :class:`~repro_torch.explore.ThreadSafeStore` over
:class:`~repro_torch.explore.DiskStore`, so cache warmth survives
restarts and the store file locking keeps concurrent server processes
safe.  ``device`` (default ``"cuda"``; raises without a card) is where
the batches anneal and simulate; ``device="cpu"`` runs the kernels'
plain PyTorch versions.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
from typing import Any, Dict, Optional, Union

from ..explore import ExploreConfig
from ..graphir.graph import Graph
from ..obs import event as obs_event
from ..obs.metrics import MetricsRegistry
from .batcher import ContinuousBatcher, QueueFull
from .protocol import (ProtocolError, ServeRequest, ServeResponse,
                       parse_request_line)

__all__ = ["ExploreService"]


def _open_store(store: Union[None, str, Dict]) -> Optional[Dict]:
    if store is None or isinstance(store, dict):
        return store
    from ..explore import DiskStore, ThreadSafeStore
    return ThreadSafeStore(DiskStore(store))


class ExploreService:
    """The serving subsystem's front door.

    ::

        async with ExploreService(store="memo/") as svc:
            resp = await svc.explore("r1", apps, config)

    or as a server: ``await svc.serve_tcp("127.0.0.1", 7341)``.
    """

    def __init__(self, store: Union[None, str, Dict] = None, *,
                 max_batch_apps: int = 8, max_wait_ms: float = 50.0,
                 queue_limit: int = 32,
                 metrics: Optional[MetricsRegistry] = None,
                 device="cuda") -> None:
        self.metrics = metrics or MetricsRegistry()
        self.batcher = ContinuousBatcher(
            _open_store(store), max_batch_apps=max_batch_apps,
            max_wait_s=max_wait_ms / 1e3, queue_limit=queue_limit,
            metrics=self.metrics, device=device)

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "ExploreService":
        await self.batcher.start()
        return self

    async def aclose(self) -> None:
        await self.batcher.aclose()

    async def __aenter__(self) -> "ExploreService":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    # -- in-process API ----------------------------------------------------
    async def explore(self, rid: str, apps: Dict[str, Graph],
                      config: ExploreConfig, *,
                      block: bool = True) -> ServeResponse:
        return await self.submit_request(
            ServeRequest(rid=rid, apps=dict(apps), config=config),
            block=block)

    async def submit_request(self, request: ServeRequest, *,
                             block: bool = True) -> ServeResponse:
        """One request through admission -> batcher -> response.

        Everything that can go wrong becomes an ``ok: false`` response
        (except :class:`QueueFull` with ``block=False``, which raises so
        callers can shed load explicitly).
        """
        t0 = time.perf_counter()
        if request.config.on_error != "isolate":
            # a batched stranger must never fail-fast its batchmates;
            # note this changes the config (and record config_key) the
            # request is served under — serving always runs isolated
            request = ServeRequest(
                rid=request.rid, apps=request.apps,
                config=request.config.replace(on_error="isolate"))
        try:
            records, failures, cached = await self.batcher.submit(
                request, block=block)
        except QueueFull:
            raise
        except Exception as e:
            self.metrics.observe("serve.request_ms",
                                 (time.perf_counter() - t0) * 1e3)
            obs_event("serve.request_failed", rid=request.rid,
                      error=type(e).__name__)
            return ServeResponse(rid=request.rid, ok=False,
                                 error=f"{type(e).__name__}: {e}")
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        self.metrics.observe("serve.request_ms", elapsed_ms)
        if cached:
            self.metrics.observe("serve.cache_hit_ms", elapsed_ms)
        obs_event("serve.request_done", rid=request.rid, cached=cached,
                  records=len(records), failures=len(failures))
        return ServeResponse(rid=request.rid, ok=True, records=records,
                             failures=failures, cached=cached,
                             elapsed_ms=elapsed_ms)

    # -- wire protocol -----------------------------------------------------
    async def handle_line(self, line: Union[str, bytes]) -> Dict[str, Any]:
        """One NDJSON request line -> one response object (a dict)."""
        try:
            obj = json.loads(line)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            self.metrics.inc("serve.protocol_errors")
            return ServeResponse(rid="", ok=False,
                                 error=f"bad JSON: {e}").to_dict()
        try:
            request = parse_request_line(obj)
        except ProtocolError as e:
            self.metrics.inc("serve.protocol_errors")
            rid = obj.get("id", "") if isinstance(obj, dict) else ""
            return ServeResponse(rid=str(rid), ok=False,
                                 error=str(e)).to_dict()
        resp = await self.submit_request(request)
        return resp.to_dict()

    async def _serve_stream(self, reader: asyncio.StreamReader,
                            write_line) -> None:
        """Shared connection loop: requests on a connection run
        concurrently (that's the point of batching), responses are
        serialized through ``write_lock`` in completion order."""
        write_lock = asyncio.Lock()
        tasks = set()

        async def one(line: bytes) -> None:
            d = await self.handle_line(line)
            async with write_lock:
                await write_line(json.dumps(d) + "\n")

        self.metrics.inc("serve.connections")
        while True:
            line = await reader.readline()
            if not line:
                break
            if not line.strip():
                continue
            t = asyncio.ensure_future(one(line))
            tasks.add(t)
            t.add_done_callback(tasks.discard)
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)

    async def serve_connection(self, reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter) -> None:
        async def write_line(s: str) -> None:
            writer.write(s.encode())
            await writer.drain()

        try:
            await self._serve_stream(reader, write_line)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def serve_tcp(self, host: str = "127.0.0.1",
                        port: int = 7341) -> asyncio.AbstractServer:
        """Start (and return) the TCP server; callers own its lifetime:
        ``server.close(); await server.wait_closed()``."""
        server = await asyncio.start_server(self.serve_connection,
                                            host, port)
        return server

    async def serve_stdio(self) -> None:
        """NDJSON over stdin/stdout until EOF (one-shot pipelines)."""
        loop = asyncio.get_event_loop()
        reader = asyncio.StreamReader()
        await loop.connect_read_pipe(
            lambda: asyncio.StreamReaderProtocol(reader), sys.stdin)

        async def write_line(s: str) -> None:
            sys.stdout.write(s)
            sys.stdout.flush()

        await self._serve_stream(reader, write_line)
