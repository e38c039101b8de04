"""The port's sharding rules and mesh (``repro_torch.sharding.specs``,
``repro_torch.launch.mesh``) against the JAX package's on the CPU.

Specs are held equal leaf for leaf, as ``tuple()`` of each partition
spec, for all ten configurations at full width.  ``distribute_params``
runs on 8 gloo ranks (spawned processes, ``tests/torch_ranks.py``) on a
(2, 4) mesh: every rank's local shard must be the slice of the full leaf
that its spec and the rank's coordinate name.  The production mesh is
built on a fake process group of 256 (and 512) ranks.  ``moe_mlp_shardmap``
runs on 8 gloo ranks on a (2, 4) mesh (4 experts' ranks, the batch over
2 data ranks) and is held at 1e-5 to the JAX package's on a one-device
(1, 1) mesh applied to each data rank's half of the batch: its capacity
counts the local batch's tokens, flattened."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as r_config
from repro.configs import list_archs as r_archs
from repro.sharding import batch_pspecs as r_batch_pspecs
from repro.sharding import cache_pspecs as r_cache_pspecs
from repro.sharding import param_pspecs as r_param_pspecs
from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import init_params, param_shapes
from repro_torch.sharding import (PartitionSpec, batch_pspecs, cache_pspecs,
                                  param_pspecs)
from torch_ranks import distribute_rank, moe_rank, run_ranks

#: the (arch, batch) pairs of tests/test_serve_sharding.py's cache test
CACHE_CASES = [("llama3.2-1b", 128), ("falcon-mamba-7b", 128),
               ("hymba-1.5b", 1), ("gemma3-27b", 1),
               ("llama-3.2-vision-90b", 128)]


def _flat(tree, path=()):
    """``{path: tuple(spec)}`` of a nested dict of specs (either
    package's)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tuple(tree)}


def test_archs_are_the_reference_ten():
    assert len(r_archs()) == 10


@pytest.mark.parametrize("arch", r_archs())
def test_param_pspecs_equal_reference(arch):
    want = _flat(r_param_pspecs(r_config(arch)))
    got = param_pspecs(get_config(arch))
    assert _flat(got) == want
    assert all(isinstance(s, PartitionSpec) for s in
               _flat_specs(got))


def _flat_specs(tree):
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _flat_specs(v)]
    return [tree]


@pytest.mark.parametrize("axis_size", [4, 8])
def test_param_pspecs_equal_reference_at_axis_size(axis_size):
    for arch in ("qwen2-moe-a2.7b", "hymba-1.5b"):
        assert _flat(param_pspecs(get_config(arch), axis_size=axis_size)) \
            == _flat(r_param_pspecs(r_config(arch), axis_size=axis_size))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,batch", CACHE_CASES)
def test_batch_and_cache_pspecs_equal_reference(arch, batch, multi_pod):
    cfg, rcfg = get_config(arch), r_config(arch)
    assert _flat(batch_pspecs(cfg, multi_pod=multi_pod, batch=batch)) == \
        _flat(r_batch_pspecs(rcfg, multi_pod=multi_pod, batch=batch))
    assert _flat(cache_pspecs(cfg, multi_pod=multi_pod, batch=batch)) == \
        _flat(r_cache_pspecs(rcfg, multi_pod=multi_pod, batch=batch))


def test_partition_spec_canonical_as_jax():
    from jax.sharding import PartitionSpec as JP
    for dims in [(("pod", "data"), None), ((), None), (("data",),),
                 ("model",), (["a", "b"], None)]:
        assert tuple(PartitionSpec(*dims)) == tuple(JP(*dims))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-moe-235b-a22b",
                                  "falcon-mamba-7b", "gemma3-27b",
                                  "llama-3.2-vision-90b"])
def test_param_pspecs_structure_and_divisibility(arch):
    cfg = get_config(arch)
    shapes = _flat_shapes(param_shapes(cfg))
    specs = _flat(param_pspecs(cfg))
    assert set(shapes) == set(specs)
    for key, shape in shapes.items():
        spec = specs[key]
        assert len(spec) <= len(shape)
        for dim, axis in zip(shape, spec):
            if axis == "model":
                assert dim % 16 == 0, (key, shape, spec)


def _flat_shapes(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_shapes(v, path + (k,)))
        return out
    return {path: tree}


#: reduced configurations whose sharded dims divide by 4: attention and a
#: dense MLP, the expert stacks, the SSM rules
DIST_CASES = {
    "llama3.2-1b": dict(n_layers=2, d_model=32, d_ff=64, vocab=64),
    "qwen2-moe-a2.7b": dict(n_layers=2, d_model=32, vocab=64),
    "falcon-mamba-7b": dict(n_layers=2, d_model=32, vocab=64),
}


def _expected_shard(full, spec, coord, names, sizes):
    """The slice of ``full`` that a rank at ``coord`` holds under
    ``spec``: each sharded dim cut into equal parts, axes major first."""
    index = []
    for d, entry in enumerate(spec):
        axes = () if entry is None else \
            (entry if isinstance(entry, tuple) else (entry,))
        part, n = 0, 1
        for a in axes:
            i = names.index(a)
            part = part * sizes[i] + coord[i]
            n *= sizes[i]
        step = full.shape[d] // n
        index.append(slice(part * step, (part + 1) * step))
    return full[tuple(index)]


@pytest.mark.parametrize("arch", sorted(DIST_CASES))
def test_distribute_params_local_shards(arch, tmp_path):
    shape, names, axis_size = (2, 4), ("data", "model"), 4
    got = run_ranks(distribute_rank, 8, tmp_path, arch, DIST_CASES[arch],
                    shape, names, axis_size)
    cfg = get_config(arch).reduced(**DIST_CASES[arch])
    full = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    from repro_torch.models.tree import leaves
    specs = param_pspecs(cfg, axis_size=axis_size)
    coords = sorted(tuple(r["coord"]) for r in got)
    assert coords == [(i, j) for i in range(2) for j in range(4)]
    sharded = 0
    for r in got:
        for (name, index, local, placements), leaf in zip(r["local"],
                                                          leaves(full)):
            assert (name, index) == (leaf.name, leaf.index)
            spec = specs
            for key in leaf.path:
                spec = spec[key]
            if index is not None:
                spec = spec[1:]
            want = _expected_shard(leaf.value, spec, r["coord"], names,
                                   shape)
            assert torch.equal(local, want), (name, index, r["coord"])
            on_model = ("Shard", spec.index("model")) if "model" in spec \
                else ("Replicate", None)
            assert placements == [("Replicate", None), on_model]
            sharded += "model" in spec
    assert sharded > 0


# ---------------------------------------------------------------------------
# the production mesh
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_world():
    """A fake process group of the given size in this process (no
    communication), destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(n):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def test_to_placements(fake_world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding import to_placements
    fake_world(8)
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    got = to_placements(mesh, {"a": PartitionSpec(("pod", "data"), None,
                                                  "model"),
                               "b": {"c": PartitionSpec(None, "data")},
                               "d": PartitionSpec()})
    assert got == {"a": (Shard(0), Shard(0), Shard(2)),
                   "b": {"c": (Replicate(), Shard(1), Replicate())},
                   "d": (Replicate(),) * 3}
    # JAX's order is major first; a dim over the axes in another order,
    # or an axis named twice, has no DTensor placement
    with pytest.raises(ValueError, match="not in the mesh's order"):
        to_placements(mesh, PartitionSpec(("data", "pod")))
    with pytest.raises(ValueError, match="named twice"):
        to_placements(mesh, PartitionSpec("model", "model"))


def test_production_mesh_needs_256_ranks(fake_world):
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        tmesh.make_production_mesh(device_type="cpu")
    fake_world(255)
    with pytest.raises(RuntimeError, match="need 256 ranks for mesh "
                                           r"\(16, 16\), have 255"):
        tmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape(fake_world, multi_pod):
    from repro.launch.mesh import make_production_mesh as r_make
    n = 512 if multi_pod else 256
    fake_world(n)
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    want_axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    assert mesh.mesh_dim_names == want_axes
    assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
    assert math.prod(mesh.shape) == n
    assert tuple(mesh.get_coordinate()) == (0,) * len(want_axes)
    # the JAX package's mesh has these shape and axes; it refuses here,
    # where JAX sees one CPU device
    with pytest.raises(RuntimeError, match=f"need {n} devices"):
        r_make(multi_pod=multi_pod)


def test_mesh_constants_are_the_h100s():
    assert tmesh.PEAK_FLOPS_BF16 == 989e12
    assert tmesh.HBM_BW == 3.35e12
    assert tmesh.HBM_BYTES == 80 * 10 ** 9
    assert tmesh.LINK_BW == 450e9
    assert not hasattr(tmesh, "ICI_BW")


# ---------------------------------------------------------------------------
# expert parallelism: moe_mlp_shardmap
# ---------------------------------------------------------------------------

#: name -> (MoEConfig fields, shared experts); tests/test_distributed_
#: subprocess.py's setting (8 experts, top 2, d_expert 16, d 32, x (4, 16,
#: 32)) at a capacity factor where entries drop, with shared experts, with
#: padded experts (6 pad to 8), and at 8.0 where none drop
MOE_CASES = {
    "drops": (dict(n_experts=8, top_k=2, d_expert=16,
                   capacity_factor=0.5), False),
    "drops_shared": (dict(n_experts=8, top_k=2, d_expert=16,
                          capacity_factor=0.5, n_shared=2, d_shared=24),
                     True),
    "padded": (dict(n_experts=6, top_k=2, d_expert=16,
                    capacity_factor=0.5), False),
    "no_drop": (dict(n_experts=8, top_k=2, d_expert=16,
                     capacity_factor=8.0), False),
}


def _moe_inputs(fields, shared):
    from repro.models.config import MoEConfig as RMoEConfig
    e, d, f = RMoEConfig(**fields).n_experts_padded, 32, fields["d_expert"]
    rng = np.random.default_rng(0)
    params = {
        "w_router": rng.normal(size=(d, e)) * .5,
        "wg": rng.normal(size=(e, d, f)) * .2,
        "wu": rng.normal(size=(e, d, f)) * .2,
        "wd": rng.normal(size=(e, f, d)) * .2,
    }
    if shared:
        ds = fields["d_shared"]
        params.update(sg=rng.normal(size=(d, ds)) * .2,
                      su=rng.normal(size=(d, ds)) * .2,
                      sd=rng.normal(size=(ds, d)) * .2,
                      shared_gate=rng.normal(size=(d,)) * .5)
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.normal(size=(4, 16, d)).astype(np.float32)
    return x, params


def _jax_shardmap(x, params, fields):
    """The JAX package's ``moe_mlp_shardmap`` on a one-device (1, 1)
    mesh."""
    from repro.models.config import MoEConfig as RMoEConfig
    from repro.models.moe import moe_mlp_shardmap as r_shardmap
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    return np.asarray(jax.jit(lambda v: r_shardmap(
        v, p, RMoEConfig(**fields), mesh, ("data",)))(jnp.asarray(x)))


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_mlp_shardmap_equals_reference(case, tmp_path):
    from repro.models.config import MoEConfig as RMoEConfig
    from repro.models.moe import moe_mlp as r_moe_mlp
    fields, shared = MOE_CASES[case]
    x, params = _moe_inputs(fields, shared)
    got = run_ranks(moe_rank, 8, tmp_path, (2, 4), x, params, fields)
    # each data rank's half, capacity counted over its 2 x 16 tokens
    want = np.concatenate([_jax_shardmap(x[:2], params, fields),
                           _jax_shardmap(x[2:], params, fields)])
    for y in got:
        assert y.shape == x.shape and y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    dense = np.asarray(r_moe_mlp(jnp.asarray(x), p, RMoEConfig(**fields)))
    if fields["capacity_factor"] >= 8.0:
        # nothing drops: the dense path's result, as the JAX test holds
        np.testing.assert_allclose(got[0].numpy(), dense, rtol=1e-4,
                                   atol=1e-4)
    else:
        # entries drop, and the capacity rule differs from moe_mlp's
        assert np.abs(want - dense).max() > 1e-2
