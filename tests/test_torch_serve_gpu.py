"""Serving on the card: bit-identity of served records.

Run on a machine with an NVIDIA Hopper card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_serve_gpu.py``.
The test decides inside itself whether a card exists and skips with a
reason when none does; the file imports nothing of the JAX package, so
it also runs where JAX is not installed.  Tolerance: equal (records are
byte-identical).
"""

import asyncio
import json

import pytest
import torch

from repro_torch.core.mining import MiningConfig
from repro_torch.explore import ExploreConfig, Explorer
from repro_torch.fabric import FabricOptions, FabricSpec
from repro_torch.graphir import trace_scalar
from repro_torch.serve import ExploreService
from repro_torch.serve.__main__ import kernel_launches

pytestmark = pytest.mark.gpu

#: the JAX package's serve tests' full-pipeline case: a 4x4 fabric
FABRIC_CFG = ExploreConfig(
    mode="per_app", mining=MiningConfig(min_support=2, max_pattern_nodes=5),
    max_merge=2,
    fabric=FabricOptions(spec=FabricSpec(rows=4, cols=4), chains=2,
                         sweeps=4, simulate=True))


def _clients():
    def conv4(i0, i1, i2, i3, w0, w1, w2, w3, c):
        return (((i0 * w0) + (i1 * w1)) + (i2 * w2)) + (i3 * w3) + c

    def fir4(i0, i1, i2, i3, w0, w1, w2, w3):
        return ((i0 * w0) + (i1 * w1)) + ((i2 * w2) + (i3 * w3))

    def blur4(a, b, c, d, w):
        return ((a + b) + (c + d)) * w

    conv = trace_scalar(conv4, ["i0", "i1", "i2", "i3",
                                "w0", "w1", "w2", "w3", "c"])
    fir = trace_scalar(fir4, ["i0", "i1", "i2", "i3",
                              "w0", "w1", "w2", "w3"])
    blur = trace_scalar(blur4, ["a", "b", "c", "d", "w"])
    return [("r1", {"conv": conv}),
            ("r2", {"conv": conv, "fir": fir}),
            ("r3", {"fir": fir, "blur": blur}),
            ("r4", {"conv": conv, "blur": blur})]


def _lines(apps, device):
    res = Explorer(apps, FABRIC_CFG, device=device).run()
    assert not res.failures
    return [json.dumps(r.to_dict()) for r in res.records()]


def test_served_on_card_bit_identical_to_solo_and_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (none on this host)")
    clients = _clients()
    solo, solo_launches = {}, 0
    for rid, apps in clients:
        before = kernel_launches()
        solo[rid] = _lines(apps, "cuda")
        solo_launches += kernel_launches() - before
        assert solo[rid] == _lines(apps, "cpu")

    async def serve():
        async with ExploreService(max_batch_apps=4, max_wait_ms=100,
                                  queue_limit=16) as svc:
            resps = await asyncio.gather(*[
                svc.explore(rid, apps, FABRIC_CFG) for rid, apps in clients])
            return resps, svc.metrics.view()

    before = kernel_launches()
    resps, stats = asyncio.run(serve())
    served = kernel_launches() - before
    for (rid, _apps), resp in zip(clients, resps):
        assert resp.ok and not resp.cached and not resp.failures
        assert resp.record_lines() == solo[rid]
    assert 0 < served < solo_launches
    assert stats["serve.batch_degraded"] == 0
