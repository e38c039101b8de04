"""The Mamba mixer's causal conv on ``DTensor``s: a shard a rank through
``kernels.sharded.conv_dtensor``, so ``F.pad`` and the taps see local
tensors whatever ``DTensor``'s redistribution planner would make of a
padded sequence shard (torch 2.11's fails on falcon-mamba-7b's
``train_4k`` dry-run cell).  Held on 4 gloo ranks against one rank of
the port at 1e-5; imports no JAX (the one-rank reference is the port's,
which ``tests/test_torch_ssm.py`` holds to the JAX package)."""

import numpy as np
import pytest
import torch

import test_torch_ssm as ssm_tests
from repro_torch.models.config import SSMConfig
from repro_torch.models.ssm import mamba_mixer
from torch_ranks import mamba_conv_rank, run_ranks

TOL = 1e-5
SSM_FIELDS = dict(d_state=8, d_conv=4, expand=2)


def _one_rank(x, params, state):
    """What every rank must return, on one rank with plain tensors."""
    px = torch.from_numpy(x).requires_grad_()
    pp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    ps = {k: torch.from_numpy(v).requires_grad_() for k, v in state.items()}
    out = {}
    with torch.enable_grad():
        loss = 0.0
        for name, st in (("fresh", None), ("state", ps)):
            y, new = mamba_mixer(px, pp, SSMConfig(**SSM_FIELDS), state=st,
                                 return_state=True)
            out[name] = [y, new["conv"], new["h"]]
            for i, t in enumerate(out[name]):
                loss = loss + (t * (i + 1.5)).mean()
        out["grads"] = torch.autograd.grad(
            loss, [px, *pp.values(), ps["conv"], ps["h"]])
    return out


@pytest.mark.parametrize("x_spec", [("data", "model", None),
                                    ("data", None, None)],
                         ids=["seq_over_model", "batch_only"])
def test_conv_local_on_dtensors_equals_one_rank(tmp_path, x_spec):
    """On a (2, 2) mesh with x's sequence sharded over ``model`` (the
    layout under which a pad needs the neighbouring shard's rows) or with
    only its batch sharded (the dry run's layout), every tensor ``F.pad``
    pads is a local tensor, not a ``DTensor``, half the batch and, as
    conv_w's channels are over ``model``, half the channels (the conv is
    not run whole on every ``model`` rank); the mixer's outputs, new conv
    window and SSM state, from no state and from a cached one, and the
    gradients of x, every param and the state equal one rank's within
    1e-5 on each of 4 gloo ranks."""
    assert SSM_FIELDS == dict(d_state=ssm_tests.SSM.d_state,
                              d_conv=ssm_tests.SSM.d_conv,
                              expand=ssm_tests.SSM.expand)
    params = ssm_tests._mixer_params()
    state = ssm_tests._state(4)
    x = np.random.default_rng(3).normal(
        size=(4, 8, ssm_tests.D_MODEL)).astype(np.float32)
    want = _one_rank(x, params, state)
    got = run_ranks(mamba_conv_rank, 4, tmp_path, x, params, state,
                    SSM_FIELDS, x_spec)
    d_inner = SSM_FIELDS["expand"] * ssm_tests.D_MODEL
    for r in got:
        assert r["padded"], r["padded"]
        for kind, shape in r["padded"]:
            assert kind == "Tensor", r["padded"]
            assert (shape[0], shape[2]) == (x.shape[0] // 2, d_inner // 2), \
                r["padded"]
        for name in ("fresh", "state"):
            for g, w in zip(r[name], want[name]):
                np.testing.assert_allclose(g.numpy(), w.detach().numpy(),
                                           rtol=TOL, atol=TOL, err_msg=name)
        assert len(r["grads"]) == len(want["grads"])
        for g, w in zip(r["grads"], want["grads"]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL,
                                       atol=TOL, err_msg="grad")
