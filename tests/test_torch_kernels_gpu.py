"""The CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA Hopper card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.
Each test decides inside itself whether a card exists and skips with a
reason when none does.  Tolerance: bit equality — the kernels do the
plain versions' integer-valued float32 arithmetic.
"""

import numpy as np
import pytest
import torch

from repro_torch.fabric import (FabricSpec, anneal_jax_batch,
                                batch_signature, lower, synthetic_netlist)
from repro_torch.kernels import pnr_cost

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (none on this host)")


def _problems():
    out = []
    for rows, cols, seed in ((4, 4, 0), (6, 6, 1), (17, 18, 2)):
        spec = FabricSpec(rows=rows, cols=cols)
        out.append(lower(synthetic_netlist(spec, seed=seed), spec))
    return out


def test_k1_matches_plain():
    _need_card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for p in _problems():
        e = p.n_entities
        slots = np.stack([rng.permutation(e) for _ in range(5)])
        args = [torch.zeros(5, dtype=torch.int32),
                torch.as_tensor(slots, dtype=torch.int32),
                torch.as_tensor(p.slot_xy)[None],
                torch.as_tensor(p.net_pins)[None],
                torch.as_tensor(p.net_mask)[None]]
        before = pnr_cost.net_hpwl_rows.launches
        got = pnr_cost.net_hpwl_rows(*[a.to(dev).contiguous() for a in args])
        torch.cuda.synchronize()
        assert pnr_cost.net_hpwl_rows.launches == before + 1
        assert torch.equal(got.cpu(), pnr_cost.net_hpwl_rows_plain(*args))


@pytest.mark.parametrize("score_mode", ["delta", "full"])
@pytest.mark.parametrize("telemetry", [False, True])
def test_k2_annealer_matches_plain(score_mode, telemetry):
    _need_card()
    for p in _problems():
        kw = dict(chains=4, seed=3, sweeps=4, score_mode=score_mode,
                  telemetry=telemetry, nonces=[11])
        before = pnr_cost.anneal_chains.launches
        got = anneal_jax_batch([p], device="cuda", **kw)
        assert pnr_cost.anneal_chains.launches == before + 1
        want = anneal_jax_batch([p], device="cpu", **kw)
        for (gs, gc), (ws, wc) in zip(got, want):
            assert np.array_equal(gs, ws), batch_signature(p, 4)
            assert np.array_equal(gc, wc), batch_signature(p, 4)


def test_wrapper_rejects_bad_inputs():
    _need_card()
    dev = torch.device("cuda")
    slot_of = torch.arange(4, dtype=torch.int64, device=dev)[None]
    with pytest.raises(TypeError):
        pnr_cost.net_hpwl_rows(
            torch.zeros(1, dtype=torch.int32, device=dev), slot_of,
            torch.zeros((1, 4, 2), device=dev),
            torch.zeros((1, 1, 2), dtype=torch.int32, device=dev),
            torch.ones((1, 1, 2), dtype=torch.bool, device=dev))
