"""Explorer-as-a-service in the port: batching, caching, backpressure,
containment, and parity with the JAX package's service.

Each ``test_*`` twin below mirrors the JAX package's
``tests/test_serve_batching.py`` case of the same name on the port, with
``device="cpu"`` (the kernels' plain versions) and the same margins;
``test_service_matches_reference`` serves the same four overlapping
requests through both packages' services and requires equal records,
failure rows, dispatch and mine counts and request keys.  Tolerance
everywhere: equal (records are byte-identical).  Serving on the card is
held in ``tests/test_torch_serve_gpu.py``.
"""

import asyncio
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core.mining import MiningConfig as RMining
from repro.explore import ExploreConfig as RConfig
from repro.fabric import FabricOptions as ROptions, FabricSpec as RSpec
from repro.graphir import trace_scalar as r_trace_scalar
from repro.serve import ExploreService as RService, request_key as r_key
from repro_torch import faultinject
from repro_torch.core.mining import MiningConfig
from repro_torch.explore import ExploreConfig, Explorer
from repro_torch.fabric import FabricOptions, FabricSpec
from repro_torch.graphir import trace_scalar
from repro_torch.serve import (ExploreService, ProtocolError, QueueFull,
                               encode_request, parse_request_line,
                               request_key)

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def armed(*specs: str):
    """Arm the port's ``site:kind:nth`` fault specs for the duration of a
    with-block (the state is process-global: always disarmed after)."""
    faultinject.disarm_all()
    for s in specs:
        faultinject.arm(s)
    try:
        yield
    finally:
        faultinject.disarm_all()


def conv4(i0, i1, i2, i3, w0, w1, w2, w3, c):
    return (((i0 * w0) + (i1 * w1)) + (i2 * w2)) + (i3 * w3) + c


def fir4(i0, i1, i2, i3, w0, w1, w2, w3):
    return ((i0 * w0) + (i1 * w1)) + ((i2 * w2) + (i3 * w3))


def blur4(a, b, c, d, w):
    return ((a + b) + (c + d)) * w


def _conv(trace=trace_scalar):
    return trace(conv4, ["i0", "i1", "i2", "i3",
                         "w0", "w1", "w2", "w3", "c"])


def _fir(trace=trace_scalar):
    return trace(fir4, ["i0", "i1", "i2", "i3", "w0", "w1", "w2", "w3"])


def _blur(trace=trace_scalar):
    return trace(blur4, ["a", "b", "c", "d", "w"])


#: mine..map only — no fabric, no device: cheap scheduling-behavior cases
LIGHT_CFG = ExploreConfig(
    mode="per_app", mining=MiningConfig(min_support=2, max_pattern_nodes=5),
    max_merge=2)

#: the full pipeline on a 4x4 fabric — the amortization/bit-identity case
FABRIC_CFG = LIGHT_CFG.replace(
    fabric=FabricOptions(spec=FabricSpec(rows=4, cols=4),
                         chains=2, sweeps=4, simulate=True))

#: the JAX package's FABRIC_CFG
R_FABRIC_CFG = RConfig(
    mode="per_app", mining=RMining(min_support=2, max_pattern_nodes=5),
    max_merge=2,
    fabric=ROptions(spec=RSpec(rows=4, cols=4), chains=2, sweeps=4,
                    simulate=True))


def _service(**kw):
    return ExploreService(device="cpu", **kw)


def _solo_lines(apps, cfg):
    res = Explorer(apps, cfg, device="cpu").run()
    return [json.dumps(r.to_dict()) for r in res.records()]


def _dispatches(stats):
    return stats["pnr_dispatch"] + stats["sim_dispatch"]


# ---------------------------------------------------------------------------
# bit-identity + cross-request amortization (the tentpole guarantee)
# ---------------------------------------------------------------------------
def test_concurrent_clients_bit_identical_and_amortized():
    conv, fir, blur = _conv(), _fir(), _blur()
    clients = [("r1", {"conv": conv}),
               ("r2", {"conv": conv, "fir": fir}),
               ("r3", {"fir": fir, "blur": blur})]
    solo = {}
    solo_dispatches = 0
    for rid, apps in clients:
        ex = Explorer(apps, FABRIC_CFG, device="cpu")
        res = ex.run()
        solo[rid] = [json.dumps(r.to_dict()) for r in res.records()]
        solo_dispatches += _dispatches(ex.stats)
    union_ex = Explorer({"conv": conv, "fir": fir, "blur": blur},
                        FABRIC_CFG, device="cpu")
    union_ex.run()
    union_dispatches = _dispatches(union_ex.stats)

    async def go():
        async with _service(max_batch_apps=3, max_wait_ms=200,
                            queue_limit=8) as svc:
            resps = await asyncio.gather(*[
                svc.explore(rid, apps, FABRIC_CFG)
                for rid, apps in clients])
            return resps, svc.metrics

    resps, metrics = asyncio.run(go())
    for (rid, _apps), resp in zip(clients, resps):
        assert resp.ok, f"{rid}: {resp.error}"
        assert resp.record_lines() == solo[rid], \
            f"{rid}: batched records != solo records"
        assert not resp.failures
    stats = metrics.view()
    served = _dispatches(stats)
    # all three clients ride ONE union run: same dispatch count as a
    # single client exploring the union, strictly fewer than solo x3
    assert served == union_dispatches
    assert served < solo_dispatches
    assert stats["mine"] == 3                 # each unique app mined once
    assert metrics.counter("serve.batches") == 1
    assert metrics.histogram("serve.batch_apps").vmax == 3


def test_cache_hit_fast_path():
    conv = _conv()

    async def go():
        async with _service(max_batch_apps=4, max_wait_ms=10) as svc:
            first = await svc.explore("r1", {"conv": conv}, FABRIC_CFG)
            before = _dispatches(svc.metrics.view())
            again = await svc.explore("r2", {"conv": conv}, FABRIC_CFG)
            after = _dispatches(svc.metrics.view())
            return first, again, before, after, svc.metrics

    first, again, before, after, metrics = asyncio.run(go())
    assert first.ok and not first.cached
    assert again.ok and again.cached
    assert again.record_lines() == first.record_lines()
    assert after == before                    # zero device work on the hit
    assert metrics.counter("serve.cache_hit") == 1
    hist = metrics.histogram("serve.cache_hit_ms")
    assert hist.count == 1
    assert hist.vmax < 1000                   # ms, vs seconds for a run


def test_identical_inflight_requests_coalesce():
    conv = _conv()

    async def go():
        async with _service(max_batch_apps=4, max_wait_ms=50) as svc:
            r1, r2 = await asyncio.gather(
                svc.explore("r1", {"conv": conv}, LIGHT_CFG),
                svc.explore("r2", {"conv": conv}, LIGHT_CFG))
            return r1, r2, svc.metrics

    r1, r2, metrics = asyncio.run(go())
    assert r1.ok and r2.ok
    assert r1.record_lines() == r2.record_lines()
    assert metrics.counter("serve.coalesced") == 1
    assert metrics.counter("mine") == 1       # one computation for both


# ---------------------------------------------------------------------------
# scheduler behavior (no fabric: cheap)
# ---------------------------------------------------------------------------
def test_deadline_flush_without_full_batch():
    conv = _conv()

    async def go():
        async with _service(max_batch_apps=100, max_wait_ms=40) as svc:
            t0 = asyncio.get_event_loop().time()
            resp = await svc.explore("r1", {"conv": conv}, LIGHT_CFG)
            waited = asyncio.get_event_loop().time() - t0
            return resp, waited, svc.metrics

    resp, waited, metrics = asyncio.run(go())
    assert resp.ok and resp.records
    # the batch never filled (100 apps) — the deadline flushed it
    assert metrics.counter("serve.batches") == 1
    assert waited >= 0.03                     # sat out most of max_wait
    q = metrics.histogram("serve.time_in_queue_ms")
    assert q.count == 1 and q.vmax >= 30


def test_bounded_queue_backpressure():
    conv, fir = _conv(), _fir()

    async def go():
        # max_wait so long nothing flushes on its own: r1 parks in the
        # queue, filling it
        async with _service(max_batch_apps=100, max_wait_ms=60_000,
                            queue_limit=1) as svc:
            t1 = asyncio.ensure_future(
                svc.explore("r1", {"conv": conv}, LIGHT_CFG))
            await asyncio.sleep(0.05)         # let r1 into the queue
            assert svc.batcher.queue_depth == 1
            with pytest.raises(QueueFull):
                await svc.explore("r2", {"fir": fir}, LIGHT_CFG,
                                  block=False)
            rejected = svc.metrics.counter("serve.rejected")
            gauge = svc.metrics.gauge("serve.queue_depth")
            # draining on close flushes the parked ticket
            return t1, rejected, gauge, svc

    async def run():
        t1, rejected, gauge, svc = await go()
        r1 = await t1
        return r1, rejected, gauge, svc.metrics

    r1, rejected, gauge, metrics = asyncio.run(run())
    assert r1.ok and r1.records               # backpressured, not dropped
    assert rejected == 1
    assert gauge == 1                         # depth never exceeded limit
    assert metrics.gauge("serve.queue_depth") == 0   # drained


def test_blocking_submit_waits_out_full_queue():
    conv, fir = _conv(), _fir()

    async def go():
        async with _service(max_batch_apps=1, max_wait_ms=10,
                            queue_limit=1) as svc:
            resps = await asyncio.gather(*[
                svc.explore(f"r{i}", apps, LIGHT_CFG)
                for i, apps in enumerate(
                    [{"conv": conv}, {"fir": fir},
                     {"conv": conv, "fir": fir}])])
            return resps

    resps = asyncio.run(go())
    assert all(r.ok and r.records for r in resps)


def test_same_app_name_different_graph_defers_not_merges():
    conv, fir = _conv(), _fir()
    solo_conv = _solo_lines({"x": conv}, LIGHT_CFG)
    solo_fir = _solo_lines({"x": fir}, LIGHT_CFG)
    assert solo_conv != solo_fir

    async def go():
        async with _service(max_batch_apps=4, max_wait_ms=30) as svc:
            r1, r2 = await asyncio.gather(
                svc.explore("r1", {"x": conv}, LIGHT_CFG),
                svc.explore("r2", {"x": fir}, LIGHT_CFG))
            return r1, r2, svc.metrics

    r1, r2, metrics = asyncio.run(go())
    assert r1.ok and r2.ok
    assert r1.record_lines() == solo_conv
    assert r2.record_lines() == solo_fir
    assert metrics.counter("serve.deferred_conflict") >= 1
    assert metrics.counter("serve.batches") == 2


# ---------------------------------------------------------------------------
# fault containment: a poisoned request degrades ALONE
# ---------------------------------------------------------------------------
def test_poisoned_request_degrades_alone():
    conv, fir, blur = _conv(), _fir(), _blur()
    solo_r1 = _solo_lines({"conv": conv}, LIGHT_CFG)
    solo_r3 = _solo_lines({"fir": fir}, LIGHT_CFG)

    async def go():
        async with _service(max_batch_apps=3, max_wait_ms=100) as svc:
            # ctx-scoped injection: only the app named "poison" fails
            # (twice — the isolate retry path too), everyone else is
            # untouched even inside the same merged batch
            with armed("mine:exc:0+:app=poison",
                       "mine.retry:exc:0+:app=poison"):
                r1, r2, r3 = await asyncio.gather(
                    svc.explore("r1", {"conv": conv}, LIGHT_CFG),
                    svc.explore("r2", {"poison": blur}, LIGHT_CFG),
                    svc.explore("r3", {"fir": fir}, LIGHT_CFG))
            return r1, r2, r3, svc.metrics

    r1, r2, r3, metrics = asyncio.run(go())
    # the poisoned request: ok (not an exception), but degraded —
    # zero records, one structured StageFailure row naming its app
    assert r2.ok
    assert r2.records == []
    assert len(r2.failures) == 1
    assert r2.failures[0]["stage"] == "mine"
    assert r2.failures[0]["app"] == "poison"
    assert r2.failures[0]["error_type"] == "InjectedFault"
    # batchmates: healthy and bit-identical to their no-fault solo runs
    assert r1.ok and r1.record_lines() == solo_r1 and not r1.failures
    assert r3.ok and r3.record_lines() == solo_r3 and not r3.failures
    assert metrics.counter("serve.batches") == 1   # they DID share a batch


# ---------------------------------------------------------------------------
# wire protocol (no service needed)
# ---------------------------------------------------------------------------
def test_protocol_round_trip_and_request_key():
    conv, fir = _conv(), _fir()
    apps = {"conv": conv, "fir": fir}
    line = encode_request("r9", apps, LIGHT_CFG)
    req = parse_request_line(json.loads(json.dumps(line)))
    assert req.rid == "r9"
    assert sorted(req.apps) == ["conv", "fir"]
    assert req.config == LIGHT_CFG
    # decoded graphs are structurally identical: same request key
    assert req.key() == request_key(apps, LIGHT_CFG)
    # key is insertion-order independent but content sensitive
    assert request_key({"fir": fir, "conv": conv}, LIGHT_CFG) == req.key()
    assert request_key({"conv": conv}, LIGHT_CFG) != req.key()


def test_protocol_rejects_malformed_requests():
    conv = _conv()
    good = encode_request("r1", {"conv": conv}, LIGHT_CFG)
    for breakage in [
            lambda d: d.pop("id"),
            lambda d: d.update(id=7),
            lambda d: d.pop("config"),
            lambda d: d.update(op="decode"),
            lambda d: d.pop("apps"),
            lambda d: d.update(apps={"conv": {"nodes": "nope"}}),
            lambda d: d.update(suite="no-such-suite")]:
        bad = json.loads(json.dumps(good))
        breakage(bad)
        with pytest.raises(ProtocolError):
            parse_request_line(bad)


def test_malformed_line_gets_error_response_not_crash():
    async def go():
        async with _service(max_wait_ms=10) as svc:
            bad_json = await svc.handle_line(b"{oops")
            bad_req = await svc.handle_line(json.dumps(
                {"id": "rX", "op": "explore"}))
            return bad_json, bad_req, svc.metrics

    bad_json, bad_req, metrics = asyncio.run(go())
    assert bad_json["ok"] is False and "bad JSON" in bad_json["error"]
    assert bad_req["ok"] is False and bad_req["id"] == "rX"
    assert metrics.counter("serve.protocol_errors") == 2
    assert metrics.counter("serve.requests") == 0   # never admitted


def test_serve_request_normalized_to_isolate():
    conv = _conv()
    raising = LIGHT_CFG.replace(on_error="raise")

    async def go():
        async with _service(max_wait_ms=10) as svc:
            with armed("mine:exc:0+:app=conv",
                       "mine.retry:exc:0+:app=conv"):
                resp = await svc.explore("r1", {"conv": conv}, raising)
            return resp

    resp = asyncio.run(go())
    # on_error="raise" would have thrown; the service isolates instead
    assert resp.ok
    assert resp.records == []
    assert resp.failures and resp.failures[0]["app"] == "conv"


# ---------------------------------------------------------------------------
# the port against the JAX package's service
# ---------------------------------------------------------------------------
def _four_clients(trace):
    conv, fir, blur = _conv(trace), _fir(trace), _blur(trace)
    return [("r1", {"conv": conv}),
            ("r2", {"conv": conv, "fir": fir}),
            ("r3", {"fir": fir, "blur": blur}),
            ("r4", {"conv": conv, "blur": blur})]


def _serve_four(service, clients, cfg):
    async def go():
        async with service as svc:
            resps = await asyncio.gather(*[
                svc.explore(rid, apps, cfg) for rid, apps in clients])
            return resps, svc.metrics.view()
    return asyncio.run(go())


def test_service_matches_reference():
    r_clients = _four_clients(r_trace_scalar)
    t_clients = _four_clients(trace_scalar)
    kw = dict(max_batch_apps=4, max_wait_ms=100, queue_limit=16)
    want, r_stats = _serve_four(RService(**kw), r_clients, R_FABRIC_CFG)
    got, t_stats = _serve_four(ExploreService(device="cpu", **kw),
                               t_clients, FABRIC_CFG)
    for w, g in zip(want, got):
        assert w.ok and g.ok and (w.cached, g.cached) == (False, False)
        assert g.records == w.records and g.records
        assert g.failures == w.failures
        assert g.record_lines() == w.record_lines()
    for name in ("pnr_dispatch", "sim_dispatch", "mine",
                 "serve.batches", "serve.requests"):
        assert t_stats[name] == r_stats[name], name
    for (_rid, ra), (_tid, ta) in zip(r_clients, t_clients):
        assert request_key(ta, FABRIC_CFG) == r_key(ra, R_FABRIC_CFG)


def test_serve_smoke_cli_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.serve",
                          "--smoke", "--smoke-device", "cpu"],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "serve smoke OK" in out.stdout
    # the JAX package's smoke prints the same counts on these requests
    assert "5 batched dispatches vs 17 solo, 3/7 apps mined" in out.stdout
