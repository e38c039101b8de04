"""Runs a function on local ranks of a gloo process group, for the CPU
parity tests of the port's distribution layer.

Not a test module — imported by test_torch_sharding.py,
test_torch_compression.py and test_torch_pipeline.py.  Each rank is a
spawned process that joins a group through a ``FileStore`` under the
test's ``tmp_path`` (no TCP port, so tests on several workers never
collide), runs ``fn(rank, world, *args)`` and saves what it returns.
This module and the rank bodies import neither JAX nor the JAX package,
so the spawned ranks load neither: the tests compute the JAX references
in their own process.
"""

import datetime
import multiprocessing as mp
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

#: seconds for a group's collectives and for all ranks to finish; a rank
#: still running then fails the test
TIMEOUT_S = 240


def _rank_main(fn, rank, world, store_path, out_dir, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def run_ranks(fn, world, tmp_path, *args, timeout=TIMEOUT_S):
    """``[fn(rank, world, *args) for each rank]``, each run in its own
    process on a gloo group of ``world`` ranks.  Fails (never skips) when
    a rank raises or has not finished within ``timeout`` seconds."""
    out_dir = tmp_path / f"ranks_{fn.__name__}"
    out_dir.mkdir()
    store = str(tmp_path / f"store_{fn.__name__}")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, str(out_dir), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(out_dir / f"{r}.err").read_text() for r in range(world)
              if (out_dir / f"{r}.err").exists()]
    assert not errors, errors[0]
    assert not hung, f"ranks {hung} had not finished after {timeout} s"
    assert [p.exitcode for p in procs] == [0] * world
    return [torch.load(out_dir / f"{r}.pt", weights_only=False)
            for r in range(world)]


def stacked(tree) -> dict:
    """``{JAX leaf name: numpy array}`` of a port tree, a layer leaf's
    copies stacked (L, ...) as the JAX package holds them."""
    from repro_torch.models.tree import leaves
    out, layered = {}, set()
    for leaf in leaves(tree):
        out.setdefault(leaf.name, []).append(
            leaf.value.detach().cpu().numpy())
        if leaf.index is not None:
            layered.add(leaf.name)
    return {k: np.stack(v) if k in layered else v[0]
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def distribute_rank(rank, world, arch, widths, shape, names, axis_size):
    """Every leaf of a reduced ``arch``'s params distributed on a mesh of
    ``shape`` ``names``: this rank's coordinate and local shards."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.tree import leaves
    from repro_torch.sharding import distribute_params

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    cfg = get_config(arch).reduced(**widths)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    dparams = distribute_params(params, cfg, mesh, axis_size=axis_size)
    local = [(leaf.name, leaf.index, leaf.value.to_local().clone(),
              [(type(p).__name__, getattr(p, "dim", None))
               for p in leaf.value.placements])
             for leaf in leaves(dparams)]
    return {"coord": mesh.get_coordinate(), "local": local}


def psum_rank(rank, world, x, axes):
    """``compressed_psum`` of this rank's shard ``x[rank]``: over the one
    WORLD group (``axes`` None), or over the groups of ``axes`` of a mesh
    of ``x.shape[:len(axes)]``."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.sharding.compression import compressed_psum, dp_groups

    if axes is None:
        groups = dist.group.WORLD
        mine = x[rank]
    else:
        shape = x.shape[:len(axes)]
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        groups = dp_groups(mesh, axes)
        mine = x[tuple(mesh.get_coordinate())]
    return compressed_psum(torch.from_numpy(np.ascontiguousarray(mine)),
                           groups)


def grad_transform_rank(rank, world, arch, widths, batch, seq):
    """One float32 train step of a reduced ``arch`` with the compressed
    all-reduce over the ``data`` axis of a (world, 1) mesh, on this rank's
    own batch: the gradients before and after the transform, stacked."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.sharding import param_pspecs
    from repro_torch.sharding.compression import \
        make_compressed_grad_transform
    from repro_torch.train import AdamWConfig, build_train_step, \
        init_opt_state

    mesh = init_device_mesh("cpu", (world, 1),
                            mesh_dim_names=("data", "model"))
    cfg = get_config(arch).reduced(**widths)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    transform = make_compressed_grad_transform(
        mesh, ("data",), param_pspecs(cfg, axis_size=1))
    seen = {}

    def capture(grads):
        seen["raw"] = stacked(grads)
        out = transform(grads)
        seen["reduced"] = stacked(out)
        return out
    opt_cfg = AdamWConfig()
    step = build_train_step(cfg, opt_cfg, compute_dtype=torch.float32,
                            grad_transform=capture)
    rng = np.random.default_rng(100 + rank)
    toks = rng.integers(0, cfg.vocab, (batch, seq))
    step(params, init_opt_state(params, opt_cfg),
         {"inputs": toks, "targets": toks})
    return seen


def gpipe_rank(rank, world, ws, x, mesh_shape):
    """``gpipe`` of ``tanh(h @ w)`` layers over the WORLD group, or over
    the ``pod`` axis of a ("pod", "data") mesh of ``mesh_shape`` (each
    data rank its own pipeline); also whether it refuses an input that
    requires a gradient."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.sharding.pipeline import gpipe, stage_split

    def stage_fn(params, h):
        for w in params:
            h = torch.tanh(h @ w)
        return h
    if mesh_shape is None:
        apply, n_stages = gpipe(stage_fn, dist.group.WORLD), world
    else:
        mesh = init_device_mesh("cpu", mesh_shape,
                                mesh_dim_names=("pod", "data"))
        apply, n_stages = gpipe(stage_fn, mesh, axis="pod"), mesh_shape[0]
    stages = stage_split(torch.from_numpy(ws), n_stages)
    y = apply(stages, torch.from_numpy(x))
    try:
        apply(stages, torch.from_numpy(x).requires_grad_())
        refused = False
    except RuntimeError:
        refused = True
    return {"y": y, "refused": refused}


def moe_rank(rank, world, shape, x, params, moe_fields):
    """``moe_mlp_shardmap`` of the whole batch ``x`` on a ("data",
    "model") mesh of ``shape``, batch over ``data``."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models.config import MoEConfig
    from repro_torch.models.moe import moe_mlp_shardmap

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    return moe_mlp_shardmap(torch.from_numpy(x), p, MoEConfig(**moe_fields),
                            mesh, ("data",))


def dtensor_forward_rank(rank, world, arch, widths, toks, mesh_shape,
                         seq_shards):
    """A reduced ``arch``'s float32 forward with its params distributed on
    a ("data", "model") mesh of ``mesh_shape`` (``axis_size`` the model
    axis), the tokens batch-sharded and ``activation_shard_fn``'s callback
    threaded through, once for each ``seq_shard`` of ``seq_shards``: the
    whole logits, the placements the callback gave the residual stream,
    and the loss with the tokens as targets and its gradients, whole."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    from repro_torch.models.perf_flags import reset_flags, set_flags
    from repro_torch.sharding import (PartitionSpec, activation_shard_fn,
                                      distribute_params, to_placements)
    from repro_torch.train.steps import _grad_leaves, lm_loss

    mesh = init_device_mesh("cpu", mesh_shape,
                            mesh_dim_names=("data", "model"))
    cfg = get_config(arch).reduced(**widths)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    dparams = distribute_params(params, cfg, mesh, axis_size=mesh_shape[1])
    out = []
    for seq_shard in seq_shards:
        set_flags(seq_shard=seq_shard)
        try:
            seen = []
            shard = activation_shard_fn(mesh, cfg, multi_pod=False)

            def spy(x, name):
                y = shard(x, name)
                if name == "hidden":
                    seen.append([(type(p).__name__, getattr(p, "dim", None))
                                 for p in y.placements])
                return y
            with implicit_replication():
                tok = distribute_tensor(
                    torch.from_numpy(toks), mesh,
                    to_placements(mesh, PartitionSpec("data", None)))
                logits = forward(dparams, cfg, tok,
                                 compute_dtype=torch.float32, shard=spy)
                # the loss (the target logits picked a vocab shard a rank)
                # and its gradients through the constrained cotangents
                leafy, inputs = _grad_leaves(dparams)
                with torch.enable_grad():
                    loss, _ = lm_loss(leafy, cfg,
                                      {"inputs": tok, "targets": tok},
                                      compute_dtype=torch.float32,
                                      shard=shard)
                    grads = torch.autograd.grad(loss, inputs)
            out.append({"logits": logits.full_tensor(), "hidden": seen,
                        "loss": loss.detach().full_tensor(),
                        "grads": [g.full_tensor() for g in grads]})
        finally:
            reset_flags()
    return out


class _PadSpy:
    """``torch.nn.functional`` with ``pad`` recording the type and the
    shape of the tensor it pads."""

    def __init__(self, real):
        self.real, self.padded = real, []

    def __getattr__(self, name):
        return getattr(self.real, name)

    def pad(self, x, *args, **kw):
        self.padded.append((type(x).__name__, tuple(x.shape)))
        return self.real.pad(x, *args, **kw)


def mamba_conv_rank(rank, world, x, params, state, ssm_fields, x_spec):
    """``mamba_mixer``'s prefill on a (2, 2) ("data", "model") mesh: x
    (B, S, d) placed by ``x_spec`` (a tuple of mesh axis names or None a
    dim), the params placed by ``sharding.specs``' rules (conv_w's
    channels over ``model``), once from no state and once from ``state``
    (its batch over ``data``, its channels over ``model``); the outputs,
    new states and the gradients of a weighted sum of their means (x, every
    param, the state), whole, and the type and the shape of every tensor
    ``F.pad`` padded."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models import ssm
    from repro_torch.models.config import SSMConfig
    from repro_torch.sharding import PartitionSpec as P, to_placements
    from repro_torch.sharding.specs import _rule

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))

    def place(a, spec):
        return distribute_tensor(torch.from_numpy(a), mesh,
                                 to_placements(mesh, spec)).requires_grad_()
    px = place(x, P(*x_spec))
    pp = {k: place(v, P(*_rule(f"ssm_{k}", v.shape, None, 2)))
          for k, v in params.items()}
    ps = {"conv": place(state["conv"], P("data", None, "model")),
          "h": place(state["h"], P("data", "model", None))}
    spy = _PadSpy(ssm.F)
    ssm.F = spy
    try:
        out = {}
        with torch.enable_grad():
            loss = 0.0
            for name, st in (("fresh", None), ("state", ps)):
                y, new = ssm.mamba_mixer(px, pp, SSMConfig(**ssm_fields),
                                         state=st, return_state=True)
                out[name] = [t.full_tensor().detach()
                             for t in (y, new["conv"], new["h"])]
                for i, t in enumerate((y, new["conv"], new["h"])):
                    loss = loss + (t * (i + 1.5)).mean()
            leaves = [px, *pp.values(), ps["conv"], ps["h"]]
            grads = torch.autograd.grad(loss, leaves)
    finally:
        ssm.F = spy.real
    out["grads"] = [g.full_tensor() for g in grads]
    out["padded"] = spy.padded
    return out
