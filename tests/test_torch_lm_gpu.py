"""The LM substrate on the card against the port's own CPU run.

Run on a machine with an NVIDIA Hopper card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_lm_gpu.py``.
Each test decides inside itself whether a card exists and skips with a
reason when none does; the file imports nothing of the JAX package.
Tolerance: rtol = atol = 1e-4 in float32 (K6 is 3xTF32, cuBLAS float32
products are not TF32), greedy tokens equal.  ``chip_smoke.py`` phase 10
runs :func:`card_vs_cpu` on every arch too.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention
from repro_torch.models import decode_step, forward, init_params, prefill
from repro_torch.serve.lm_engine import Request, ServeEngine

pytestmark = pytest.mark.gpu

ARCHS = ["llama3.2-1b", "deepseek-coder-33b", "gemma2-27b", "gemma3-27b",
         "musicgen-large", "llama-3.2-vision-90b"]
TOL = 1e-4


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (none on this host)")


def _both(cfg, seed=0, dev="cuda"):
    return [init_params(cfg, torch.Generator().manual_seed(seed),
                        device="cpu").to(d) for d in ("cpu", dev)]


def _inputs(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        toks = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    else:
        toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    enc = (rng.normal(size=(b, cfg.encoder_len, cfg.d_model))
           .astype(np.float32) if cfg.n_cross_layers else None)
    return toks, enc


def card_vs_cpu(arch, dev="cuda"):
    """``arch`` at ``.reduced()`` in float32 on the card and on the CPU
    from one set of weights: forward, prefill and 4 decode steps; the
    prompt (20) is longer than the reduced window (16), so local layers
    mask.  Asserts every logit and cache leaf finite and within
    :data:`TOL`, and K6 launched once a self-attention layer in forward
    and in prefill and never in decode; returns the largest
    |card - CPU|."""
    cfg = get_config(arch).reduced()
    cpu, card = _both(cfg, dev=dev)
    toks, enc = _inputs(cfg)
    kw = dict(enc=enc, compute_dtype=torch.float32)
    worst = 0.0

    def close(got, want, what):
        nonlocal worst
        got, want = got.float().cpu(), want.float()
        assert bool(torch.isfinite(got).all()), what
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=f"{arch}: {what}")
        worst = max(worst, float((got - want).abs().max()))

    flash_attention.launches = 0
    close(forward(card, cfg, toks, **kw), forward(cpu, cfg, toks, **kw),
          "forward")
    lc, cc = prefill(card, cfg, toks[:, :20], smax=32, **kw)
    lh, ch = prefill(cpu, cfg, toks[:, :20], smax=32, **kw)
    assert flash_attention.launches == 2 * cfg.n_self_layers
    close(lc, lh, "prefill")
    for key in ("k", "v", "cross_k", "cross_v"):
        if key in ch:
            close(cc[key], ch[key], f"prefill cache {key}")
    for t in range(20, 24):
        lc, cc = decode_step(card, cfg, toks[:, t], cc,
                             compute_dtype=torch.float32)
        lh, ch = decode_step(cpu, cfg, toks[:, t], ch,
                             compute_dtype=torch.float32)
        close(lc, lh, f"decode step {t}")
    assert flash_attention.launches == 2 * cfg.n_self_layers
    return worst


@pytest.mark.parametrize("arch", ARCHS)
def test_card_equals_cpu(arch):
    _need_card()
    card_vs_cpu(arch)


def test_served_run_card_equals_cpu():
    """A 2-slot served run of 4 requests: K6 once a layer a prefill,
    tokens equal to the CPU run's."""
    _need_card()
    cfg = get_config("llama3.2-1b").reduced(n_layers=2, d_model=128,
                                            d_ff=256, vocab=512)
    cpu, card = _both(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 32, dtype=np.int32)
               for _ in range(4)]
    outs = []
    for params, dev in ((card, "cuda"), (cpu, "cpu")):
        eng = ServeEngine(cfg, params, slots=2, smax=64,
                          compute_dtype=torch.float32, device=dev)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid, p, max_new=8))
        flash_attention.launches = 0
        outs.append(eng.run())
        if dev == "cuda":
            assert flash_attention.launches == 4 * cfg.n_layers
    assert outs[0] == outs[1]
    assert all(len(t) == 8 for t in outs[0].values())
