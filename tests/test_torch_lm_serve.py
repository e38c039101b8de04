"""The port's LM demo engine (``repro_torch.serve.lm_engine``) and its
launcher against the JAX package's on the CPU.

Both engines get the same parameters (``params_from_reference``) and the
same requests; at float32 compute their greedy tokens are equal.  The
JAX demo keeps one ``cache["len"]`` for every slot, set by the last
refill, so it is right only when every prompt has one length and every
request one ``max_new``: the port keeps that fault, and
``test_uniform_len_fault_kept`` shows it.  The Mamba mixer reads no
position, so falcon-mamba is served right at mixed lengths
(``test_mamba_engine_mixed_prompt_lengths``).  The MoE MLP is row-local,
so a slot's tokens do not depend on what the other slots hold
(``test_moe_engine_matches_reference``).
"""

import importlib
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_config
from repro.models import init_params as r_init_params
from repro.serve.lm_engine import Request as RRequest
from repro.serve.lm_engine import ServeEngine as RServeEngine
from repro_torch.configs import get_config
from repro_torch.models import params_from_reference
from repro_torch.serve.lm_engine import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]


def _engines(slots, smax, arch="llama3.2-1b", dtype="float32", **reduce):
    rcfg = r_config(arch).reduced(**reduce)
    cfg = get_config(arch).reduced(**reduce)
    params = r_init_params(rcfg, jax.random.PRNGKey(0))
    tp = params_from_reference(cfg, jax.tree.map(np.asarray, params),
                               device="cpu")
    ref = RServeEngine(rcfg, params, slots=slots, smax=smax,
                       compute_dtype=getattr(jnp, dtype))
    port = ServeEngine(cfg, tp, slots=slots, smax=smax,
                       compute_dtype=getattr(torch, dtype), device="cpu")
    return cfg, ref, port


def _serve(eng, req_cls, prompts, max_new):
    for rid, p in enumerate(prompts):
        eng.submit(req_cls(rid, p, max_new=max_new))
    return eng.run(max_steps=64)


def test_serve_engine_batched_requests():
    """Twin of tests/test_serve_sharding.py's engine test, tokens equal to
    the JAX engine's."""
    cfg, ref, port = _engines(2, 48, n_layers=1, d_model=32, d_ff=64,
                              vocab=64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 8, dtype=np.int32)
               for _ in range(4)]
    outs = _serve(port, Request, prompts, 5)
    assert len(outs) == 4
    for rid, toks in outs.items():
        assert len(toks) == 5
        assert all(0 <= t < cfg.vocab for t in toks)
    assert outs == _serve(ref, RRequest, prompts, 5)
    assert all(r.done for r in port.all_requests)


def test_uniform_len_fault_kept():
    """Prompts of two lengths in two slots: the second refill sets the one
    ``len`` to its prompt's length, so slot 0 decodes at the wrong
    positions.  The port's tokens equal the JAX engine's, and request 0's
    differ from its run alone."""
    cfg, ref, port = _engines(2, 48)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (12, 5)]
    port.submit(Request(0, prompts[0], max_new=6))
    port.submit(Request(1, prompts[1], max_new=6))
    port._refill()
    assert int(port.cache["len"]) == 5            # not 12 for slot 0
    outs = port.run()
    assert outs == _serve(ref, RRequest, prompts, 6)
    _, _, alone = _engines(2, 48)
    assert _serve(alone, Request, prompts[:1], 6)[0] != outs[0]


def test_mamba_engine_mixed_prompt_lengths():
    """falcon-mamba at reduced widths, 2 slots, prompts of four lengths
    and four ``max_new``: the port's tokens equal the JAX engine's, and
    each request's equal its run alone (no position is read, so the one
    ``len`` does not bind)."""
    cfg, ref, port = _engines(2, 48, arch="falcon-mamba-7b")
    rng = np.random.default_rng(2)
    lens, news = (12, 5, 9, 7), (5, 3, 6, 4)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in lens]
    for rid, (p, m) in enumerate(zip(prompts, news)):
        port.submit(Request(rid, p, max_new=m))
        ref.submit(RRequest(rid, p, max_new=m))
    outs = port.run()
    assert outs == ref.run()
    assert [len(outs[r]) for r in range(4)] == list(news)
    for rid, (p, m) in enumerate(zip(prompts, news)):
        _, _, alone = _engines(2, 48, arch="falcon-mamba-7b")
        alone.submit(Request(rid, p, max_new=m))
        assert alone.run() == {rid: outs[rid]}, rid


def test_moe_engine_matches_reference():
    """qwen2-moe at reduced widths, 2 slots, 4 prompts of one length: after
    the first refill every spliced cache leaf equals the JAX engine's
    (k and v, float32 at 1e-4), and the served tokens are the JAX
    engine's; each request's tokens equal its run alone."""
    cfg, ref, port = _engines(2, 32, arch="qwen2-moe-a2.7b")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, 8, dtype=np.int32)
               for _ in range(4)]
    for rid, p in enumerate(prompts):
        port.submit(Request(rid, p, max_new=5))
        ref.submit(RRequest(rid, p, max_new=5))
    port._refill()
    ref._refill()
    assert sorted(port.cache) == sorted(ref.cache) == ["k", "len", "v"]
    for key in ("k", "v"):
        np.testing.assert_allclose(port.cache[key].numpy(),
                                   np.asarray(ref.cache[key]), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    assert int(port.cache["len"]) == int(ref.cache["len"]) == 8
    outs = port.run()
    assert outs == ref.run()
    assert all(len(t) == 5 for t in outs.values())
    for rid in (0, 3):
        _, _, alone = _engines(2, 32, arch="qwen2-moe-a2.7b")
        alone.submit(Request(rid, prompts[rid], max_new=5))
        assert alone.run() == {rid: outs[rid]}, rid


def test_hymba_cache_dtypes_follow_reference_engine():
    """hymba in bfloat16: the engine's cache leaves have the JAX engine's
    dtypes after a refill (the float32 conv window spliced into the
    bfloat16 cache ``init_cache`` made) and after a decode step (the
    window the mixer returned, float32)."""
    cfg, ref, port = _engines(2, 32, arch="hymba-1.5b", dtype="bfloat16")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, 6,
                                               dtype=np.int32)

    def dtypes(cache):
        return {k: str(v.dtype).replace("torch.", "")
                for k, v in cache.items()}
    for eng, req in ((port, Request), (ref, RRequest)):
        eng.submit(req(0, prompt, max_new=3))
        eng._refill()
    assert dtypes(port.cache) == dtypes(ref.cache)
    assert dtypes(port.cache)["ssm_conv"] == "bfloat16"
    port.step()
    ref.step()
    assert dtypes(port.cache) == dtypes(ref.cache)
    assert dtypes(port.cache)["ssm_conv"] == "float32"


def test_deprecated_names_warn():
    import repro_torch.serve as serve
    with pytest.warns(DeprecationWarning, match="lm_engine"):
        assert serve.ServeEngine is ServeEngine
    with pytest.warns(DeprecationWarning, match="lm_engine"):
        assert serve.Request is Request
    sys.modules.pop("repro_torch.serve.engine", None)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        mod = importlib.import_module("repro_torch.serve.engine")
    assert mod.ServeEngine is ServeEngine
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        from repro_torch.serve import ExploreService  # noqa: F401


def _launch_cpu(*flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--device", "cpu", *flags], capture_output=True,
                          text=True, env=env, timeout=300)


def test_launch_serve_cpu():
    """``python -m repro_torch.launch.serve`` at the JAX launcher's
    defaults, on the CPU."""
    out = _launch_cpu()
    assert out.returncode == 0, out.stderr
    assert "served 8 requests, 128 tokens" in out.stdout
    assert out.stdout.count("  req ") == 8


def test_launch_serve_mamba_cpu():
    """The launcher serving falcon-mamba (its reduced widths), on the
    CPU."""
    out = _launch_cpu("--arch", "falcon-mamba-7b")
    assert out.returncode == 0, out.stderr
    assert "served 8 requests, 128 tokens" in out.stdout
    assert out.stdout.count("  req ") == 8


def test_launch_serve_moe_cpu():
    """The launcher serving qwen2-moe (its reduced widths), on the CPU."""
    out = _launch_cpu("--arch", "qwen2-moe-a2.7b")
    assert out.returncode == 0, out.stderr
    assert "served 8 requests, 128 tokens" in out.stdout
    assert out.stdout.count("  req ") == 8
