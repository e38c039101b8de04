"""The port's GPipe schedule (``repro_torch.sharding.pipeline``) against
the JAX package's on the CPU.

``stage_split`` is held equal to the JAX package's.  ``gpipe`` runs on 4
gloo ranks (spawned processes, ``tests/torch_ranks.py``) with the JAX
test's setting (tests/test_serve_sharding.py::test_gpipe_subprocess: L
8, D 16, ``tanh(h @ w)``, 6 microbatches; the weights and inputs here
from numpy with a seed) and must be within 1e-5 of the sequential
reference on every rank; it must refuse an input that requires a
gradient (it carries none)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sharding.pipeline import stage_split as r_stage_split
from repro_torch.sharding.pipeline import stage_split
from torch_ranks import gpipe_rank, run_ranks

L, D, N_MICRO, MB = 8, 16, 6, 4


@pytest.mark.parametrize("n_stages", [1, 2, 4, 8])
def test_stage_split_equals_reference(n_stages):
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(L, D, D)).astype(np.float32),
            "b": {"c": rng.normal(size=(L, 3)).astype(np.float32)}}
    want = r_stage_split(jax.tree.map(jnp.asarray, tree), n_stages)
    got = stage_split({"w": torch.from_numpy(tree["w"]),
                       "b": {"c": torch.from_numpy(tree["b"]["c"])}},
                      n_stages)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"]["c"].numpy(),
                                  np.asarray(want["b"]["c"]))


def test_stage_split_refuses_uneven():
    with pytest.raises(ValueError, match="do not split"):
        stage_split(torch.zeros(6, 2), 4)


#: name -> (ranks, None for the WORLD group or the ("pod", "data") mesh
#: whose pod axis carries the stages: 2 pipelines of 2 stages on ranks
#: {0, 2} and {1, 3})
GPIPE_CASES = {"world2": (2, None), "world4": (4, None),
               "mesh2x2": (4, (2, 2))}


@pytest.mark.parametrize("case", sorted(GPIPE_CASES))
def test_gpipe_equals_sequential_reference(case, tmp_path):
    world, mesh_shape = GPIPE_CASES[case]
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(L, D, D)) * 0.1).astype(np.float32)
    x = rng.normal(size=(N_MICRO, MB, D)).astype(np.float32)
    got = run_ranks(gpipe_rank, world, tmp_path, ws, x, mesh_shape)
    # the JAX test's reference: every layer in turn on each microbatch
    wj = jnp.asarray(ws)

    def ref_one(xm):
        h = xm
        for i in range(L):
            h = jnp.tanh(h @ wj[i])
        return h
    ref = np.stack([np.asarray(ref_one(jnp.asarray(x[i])))
                    for i in range(N_MICRO)])
    for r in got:
        assert r["refused"]
        assert r["y"].shape == (N_MICRO, MB, D)
        assert float(np.abs(r["y"].numpy() - ref).max()) < 1e-5
        # every rank holds its pipeline's last stage's outputs, and the
        # pipelines agree, bit for bit
        assert torch.equal(r["y"], got[-1]["y"])


#: reduced widths for the rehearsal of chip_smoke.py's phase 16
PHASE16_WIDTHS = {"llama3.2-1b": dict(n_layers=2, d_model=64, d_ff=128,
                                      vocab=256),
                  "qwen2-moe-a2.7b": dict(n_layers=2, d_model=64,
                                          vocab=256)}


def test_chip_smoke_distribution_phase_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 16 end to end on the CPU at reduced
    widths (gloo in place of NCCL, 4 spawned ranks, 64 tokens a row):
    every check it makes on the card passes, with K6's plain version
    counted where the card counts K6's launches."""
    import time
    from pathlib import Path
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    import repro_torch.configs as configs
    import repro_torch.models.transformer as transformer
    from repro_torch.kernels import flash_attention

    real_config, real_attention = configs.get_config, transformer.attention
    monkeypatch.setattr(configs, "get_config", lambda a: real_config(
        a).reduced(**PHASE16_WIDTHS[a]))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "TR_SEQ", 64)

    def host_ms(fn, reps):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) / reps * 1e3
    monkeypatch.setattr(cs, "cuda_ms", host_ms)

    def counted(*a, **kw):
        flash_attention.launches += 1
        return real_attention(*a, **kw)
    monkeypatch.setattr(transformer, "attention", counted)

    def traced(run):
        n = flash_attention.launches
        out = run()
        return out, {"flash_attention_kernel":
                     [0.0] * (flash_attention.launches - n)}, 0.0
    monkeypatch.setattr(cs, "device_kernels", traced)
    assert cs.distribution_phase(torch.device("cpu"), "cpu") == {
        "dist_train_launches": 2, "dist_gpipe_launches": 8}
    assert not torch.distributed.is_initialized()
