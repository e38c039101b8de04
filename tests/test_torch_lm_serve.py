"""The port's LM demo engine (``repro_torch.serve.lm_engine``) and its
launcher against the JAX package's on the CPU.

Both engines get the same parameters (``params_from_reference``) and the
same requests; at float32 compute their greedy tokens are equal.  The
JAX demo keeps one ``cache["len"]`` for every slot, set by the last
refill, so it is right only when every prompt has one length and every
request one ``max_new``: the port keeps that fault, and
``test_uniform_len_fault_kept`` shows it.
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


def _engines(slots, smax, **reduce):
    rcfg = r_config("llama3.2-1b").reduced(**reduce)
    cfg = get_config("llama3.2-1b").reduced(**reduce)
    params = r_init_params(rcfg, jax.random.PRNGKey(0))
    tp = params_from_reference(cfg, jax.tree.map(np.asarray, params),
                               device="cpu")
    ref = RServeEngine(rcfg, params, slots=slots, smax=smax,
                       compute_dtype=jnp.float32)
    port = ServeEngine(cfg, tp, slots=slots, smax=smax,
                       compute_dtype=torch.float32, device="cpu")
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


def test_launch_serve_cpu():
    """``python -m repro_torch.launch.serve`` at the JAX launcher's
    defaults, on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--device", "cpu"], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 8 requests, 128 tokens" in out.stdout
    assert out.stdout.count("  req ") == 8
