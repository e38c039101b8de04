"""CLI for explorer-as-a-service.

::

    python -m repro_torch.serve --smoke                  # CI self-check
    python -m repro_torch.serve --port 7341 --store memo/
    python -m repro_torch.serve --stdio < requests.jsonl

``--device`` picks where served batches anneal and simulate: ``cuda``
(the default; fails without a card) or ``cpu`` (the kernels' plain
PyTorch versions); ``--smoke-device`` does the same for ``--smoke``.

The smoke is the serving layer's load-bearing CI assertion: it serves
the same requests solo, batched with strangers, from cache, and over
the wire protocol, and requires the records to be **byte-identical**
in all four paths — while the batched path performs strictly fewer
dispatches than the solo runs summed (on the card: fewer launches of
the annealing kernel and the cycle stepper, too), and a cache hit
launches no kernel.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from typing import Dict, List

from ..graphir.graph import Graph
from .frontend import ExploreService
from .protocol import encode_request


def _smoke_requests():
    """Four overlapping client requests over three small apps (the
    explore smoke's Fig. 3 convolution plus two MAC/add kernels)."""
    from ..explore.__main__ import _smoke_case
    from ..graphir import trace_scalar

    apps, cfg = _smoke_case()
    conv = apps["conv"]

    def fir4(i0, i1, i2, i3, w0, w1, w2, w3):
        return ((i0 * w0) + (i1 * w1)) + ((i2 * w2) + (i3 * w3))

    def blur4(a, b, c, d, w):
        return (((a + b) + (c + d)) * w)

    fir = trace_scalar(fir4, ["i0", "i1", "i2", "i3",
                              "w0", "w1", "w2", "w3"])
    blur = trace_scalar(blur4, ["a", "b", "c", "d", "w"])
    cfg = cfg.replace(on_error="isolate")   # what the service runs under
    clients = [
        ("r1", {"conv": conv}),
        ("r2", {"conv": conv, "fir": fir}),
        ("r3", {"fir": fir, "blur": blur}),
        ("r4", {"conv": conv, "blur": blur}),
    ]
    return clients, cfg


def kernel_launches() -> int:
    """Launches of the annealing kernel (K2) and the cycle stepper (K3)
    so far in this process (CPU tensors run the plain versions and count
    none)."""
    from ..kernels import pnr_cost, sim_step
    return (pnr_cost.anneal_chains.launches
            + sim_step.simulate_batch_stepper.launches)


def _solo_lines(apps: Dict[str, Graph], cfg, device) -> tuple:
    """Ground truth: one fresh solo Explorer run -> (record line bytes,
    dispatch count, kernel launches)."""
    from ..explore import Explorer
    ex = Explorer(apps, cfg, device=device)
    before = kernel_launches()
    res = ex.run()
    assert not res.failures, f"solo run degraded: {res.failures}"
    lines = [json.dumps(r.to_dict()) for r in res.records()]
    return (lines, ex.stats["pnr_dispatch"] + ex.stats["sim_dispatch"],
            kernel_launches() - before)


async def _smoke_async(device) -> int:
    clients, cfg = _smoke_requests()
    on_card = device == "cuda"

    solo: Dict[str, List[str]] = {}
    solo_dispatches = solo_launches = 0
    for rid, apps in clients:
        solo[rid], n, k = _solo_lines(apps, cfg, device)
        solo_dispatches += n
        solo_launches += k
        assert solo[rid], f"solo {rid} produced no records"

    async with ExploreService(max_batch_apps=4, max_wait_ms=100,
                              queue_limit=16, device=device) as svc:
        # -- N concurrent clients, batched across requests ---------------
        before = kernel_launches()
        resps = await asyncio.gather(*[
            svc.explore(rid, apps, cfg) for rid, apps in clients])
        served_launches = kernel_launches() - before
        for (rid, _apps), resp in zip(clients, resps):
            assert resp.ok, f"{rid} failed: {resp.error}"
            assert not resp.cached, f"{rid} unexpectedly cached"
            assert resp.record_lines() == solo[rid], \
                f"bit-identity violated for {rid}: batched != solo"
            assert not resp.failures, f"{rid} degraded: {resp.failures}"
        stats = svc.metrics.view()
        served_dispatches = (stats["pnr_dispatch"] + stats["sim_dispatch"])
        assert served_dispatches < solo_dispatches, (
            f"no cross-request amortization: served {served_dispatches} "
            f"dispatches vs {solo_dispatches} solo")
        if on_card:
            assert 0 < served_launches < solo_launches, (
                f"no cross-request amortization on the card: served "
                f"{served_launches} kernel launches vs {solo_launches} solo")
        n_apps = len({n for _rid, apps in clients for n in apps})
        assert stats["mine"] == n_apps, (
            f"expected {n_apps} unique mines across all requests, "
            f"got {stats['mine']}")

        # -- cache hit: same content, new rid, zero new dispatches --------
        rid2, apps2 = clients[1]
        before = kernel_launches()
        resp = await svc.explore("r2-again", apps2, cfg)
        assert resp.ok and resp.cached, "repeat request missed the cache"
        assert resp.record_lines() == solo[rid2], \
            "bit-identity violated: cached != solo"
        after = stats["pnr_dispatch"] + stats["sim_dispatch"]
        assert after == served_dispatches, "cache hit launched a kernel"
        assert kernel_launches() == before, "cache hit launched a kernel"
        assert resp.elapsed_ms < 1000, \
            f"cache hit took {resp.elapsed_ms:.1f} ms"

        # -- wire protocol round trip -------------------------------------
        server = await svc.serve_tcp("127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write((json.dumps(
            encode_request("wire-1", apps2, cfg)) + "\n").encode())
        writer.write(b'{"this is": "not a request"}\n')
        await writer.drain()
        writer.write_eof()
        line1 = json.loads(await reader.readline())
        line2 = json.loads(await reader.readline())
        by_ok = {d["ok"]: d for d in (line1, line2)}
        assert set(by_ok) == {True, False}, f"unexpected replies: {by_ok}"
        assert by_ok[True]["id"] == "wire-1" and by_ok[True]["cached"]
        assert [json.dumps(r) for r in by_ok[True]["records"]] \
            == solo[rid2], "bit-identity violated: wire != solo"
        writer.close()
        await writer.wait_closed()
        server.close()
        await server.wait_closed()

        cache_ms = svc.metrics.histogram("serve.cache_hit_ms")
        print(f"# serve smoke OK: {len(clients)} clients bit-identical "
              f"(solo == batched == cached == wire), "
              f"{served_dispatches} batched dispatches vs "
              f"{solo_dispatches} solo, {stats['mine']}/"
              f"{sum(len(a) for _r, a in clients)} apps mined, "
              f"cache hits {cache_ms.count} "
              f"(mean {cache_ms.mean:.2f} ms)"
              + (f", K2 + K3 launches {served_launches} batched vs "
                 f"{solo_launches} solo" if on_card else "")
              + f" [device={device}]")
    return 0


async def _serve_async(args) -> int:
    svc = ExploreService(store=args.store,
                         max_batch_apps=args.max_batch_apps,
                         max_wait_ms=args.max_wait_ms,
                         queue_limit=args.queue_limit,
                         device=args.device)
    async with svc:
        if args.stdio:
            await svc.serve_stdio()
            return 0
        server = await svc.serve_tcp(args.host, args.port)
        port = server.sockets[0].getsockname()[1]
        print(f"# repro_torch.serve listening on {args.host}:{port} "
              f"(max_batch_apps={args.max_batch_apps}, "
              f"max_wait_ms={args.max_wait_ms}, "
              f"queue_limit={args.queue_limit}, "
              f"store={args.store or 'in-memory'}, "
              f"device={args.device})", flush=True)
        async with server:
            await server.serve_forever()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="Exploration serving: NDJSON front-end with "
                    "cross-request continuous batching")
    ap.add_argument("--smoke", action="store_true",
                    help="fast end-to-end self check (CI): bit-identity "
                         "solo == batched == cached == wire")
    ap.add_argument("--stdio", action="store_true",
                    help="serve NDJSON on stdin/stdout until EOF")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7341,
                    help="TCP port (0 picks a free one)")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="persistent DiskStore directory (default: "
                         "in-memory, cache dies with the process)")
    ap.add_argument("--max-batch-apps", type=int, default=8,
                    help="flush a batch once this many distinct apps "
                         "are pending (default 8)")
    ap.add_argument("--max-wait-ms", type=float, default=50.0,
                    help="flush the oldest ticket after this long even "
                         "if the batch is not full (default 50)")
    ap.add_argument("--queue-limit", type=int, default=32,
                    help="bounded admission queue: tickets beyond this "
                         "wait at the door (default 32)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where served batches anneal and simulate "
                         "(default cuda)")
    ap.add_argument("--smoke-device", default="cuda", choices=("cuda", "cpu"),
                    help="where --smoke anneals and simulates (default cuda)")
    args = ap.parse_args(argv)
    try:
        if args.smoke:
            return asyncio.run(_smoke_async(args.smoke_device))
        return asyncio.run(_serve_async(args))
    except KeyboardInterrupt:
        return 130
    except AssertionError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except (ValueError, RuntimeError, OSError) as e:
        # a missing card and an unusable address or store land here: one
        # structured line, never an unhandled traceback
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
