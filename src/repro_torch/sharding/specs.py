"""Sharding rules: parameter / batch / cache partition specs.

The port of the JAX package's ``repro.sharding.specs``, rule for rule.
Mesh axes (see ``launch/mesh.py``): single-pod ``("data", "model")`` =
(16, 16); multi-pod ``("pod", "data", "model")`` = (2, 16, 16).  ``pod``
acts as an extra data-parallel axis by default (PP over pod is the
optional ``sharding/pipeline.py`` strategy).

Policy (Megatron-style TP16 x DP16(x2)):
* attention qkv/out projections and MLP in/out: column/row-sharded over
  ``model`` — dims are guarded for divisibility by 16; non-divisible dims
  (e.g. hymba's 32001 vocab) stay replicated;
* MoE expert stacks: expert dim over ``model`` (expert parallelism);
* SSM: d_inner over ``model``;
* embeddings: vocab over ``model``; lm_head column-sharded;
* batch dims over ``(pod,) data``;
* decode KV caches: batch over data; kv-heads over ``model`` when divisible,
  otherwise the cache *sequence* dim goes over ``model``;
* long-context (batch=1): cache sequence over data (+model if kv heads
  don't shard) — context parallelism.

A spec is a :class:`PartitionSpec`: per dim of the leaf, an axis name, a
tuple of axis names, or None (replicated), as ``jax.sharding.
PartitionSpec`` holds them; ``tuple(spec)`` equals ``tuple()`` of the JAX
package's.  The trees are keyed and stacked as the JAX package's
(``param_shapes``: layer leaves (L, ...)).  :func:`to_placements` turns a
spec into ``torch.distributed.tensor`` placements on a ``DeviceMesh`` and
:func:`distribute_params` shards the port's per-layer leaves by the
trailing part of their stacked spec.  :func:`activation_shard_fn` is the
``shard`` callback the models take: it redistributes a ``DTensor``
activation to the spec its name has in the JAX package's table, the MoE
buffers' specs rewritten for the port's (E, B*C, .) layout.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

from ..kernels.sharded import constrain
from ..models.config import ArchConfig
from ..models.perf_flags import get_flags
from ..models.transformer import param_shapes
from ..models.tree import leaves, rebuild

__all__ = ["MODEL_AXIS", "PartitionSpec", "activation_shard_fn",
           "batch_axes", "batch_pspecs", "cache_pspecs", "distribute_params",
           "param_pspecs", "to_placements"]

MODEL_AXIS = "model"


def _canonical(entry):
    """A dim's entry as ``jax.sharding.PartitionSpec`` keeps it: a list
    becomes a tuple, one axis in a tuple the axis, no axis None."""
    if isinstance(entry, (list, tuple)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """Per dim of a tensor: the mesh axis (or tuple of axes, major first)
    it is sharded over, or None where it is replicated."""

    def __new__(cls, *dims):
        return super().__new__(cls, (_canonical(d) for d in dims))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def batch_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def _div(n: int, by: int) -> bool:
    return n % by == 0


def _model_if(n: int, axis_size: int = 16) -> Optional[str]:
    return MODEL_AXIS if _div(n, axis_size) else None


# per-key rules applied to the trailing dims (leading stacked dims -> None)
def _rule(key: str, shape: Tuple[int, ...], cfg: ArchConfig,
          axis_size: int) -> Tuple[Optional[Any], ...]:
    nd = len(shape)
    m = lambda n: _model_if(n, axis_size)
    if key == "embed":
        return (m(shape[0]), None)
    if key == "lm_head":
        return (None, m(shape[1]))
    if key == "final_norm":
        return (None,)
    if key in ("wq", "wk", "wv"):
        return (None, m(shape[-1]))
    if key == "wo":
        return (m(shape[-2]), None)
    if key in ("wg", "wu"):
        if nd == 3:                      # (E, D, Fe): expert parallel
            return (m(shape[0]), None, None)
        return (None, m(shape[-1]))
    if key == "wd":
        if nd == 3:
            return (m(shape[0]), None, None)
        return (m(shape[-2]), None)
    if key == "wi" or key in ("sg", "su"):
        return (None, m(shape[-1]))
    if key in ("wom", "sd"):
        return (m(shape[-2]), None)
    if key == "w_router":
        return (None, None)
    if key.startswith("ssm_"):
        sub = key[len("ssm_"):]
        if sub == "in_proj":
            return (None, m(shape[-1]))
        if sub == "conv_w":
            return (None, m(shape[-1]))
        if sub in ("conv_b", "dt_bias", "D"):
            return (m(shape[-1]),)
        if sub in ("x_proj", "A_log", "out_proj"):
            return (m(shape[-2]), None)
        if sub == "dt_proj":
            return (None, m(shape[-1]))
    # norms, gates, anything else: replicated
    return tuple(None for _ in range(nd))


def param_pspecs(cfg: ArchConfig, *, axis_size: int = 16) -> Any:
    """PartitionSpec tree mirroring ``param_shapes(cfg)``."""
    shapes = param_shapes(cfg)

    def walk(tree, stacked: int):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = walk(val, stacked)
            else:
                trailing = _rule(key, val[stacked:], cfg, axis_size)
                out[key] = P(*((None,) * stacked + tuple(trailing)))
        return out

    specs: Dict[str, Any] = {}
    for key, val in shapes.items():
        if key in ("layers", "cross_layers"):
            specs[key] = walk(val, stacked=1)
        elif isinstance(val, dict):
            specs[key] = walk(val, stacked=0)
        else:
            specs[key] = P(*_rule(key, val, cfg, axis_size))
    return specs


def batch_pspecs(cfg: ArchConfig, *, multi_pod: bool, batch: int) -> Any:
    bp = batch_axes(multi_pod)
    bsize = 16 * (2 if multi_pod else 1)
    baxis = bp if _div(batch, bsize) else (bp[-1] if _div(batch, 16) else None)
    specs = {"inputs": P(baxis, None, None) if cfg.input_mode == "embeddings"
             else P(baxis, None),
             "targets": P(baxis, None)}
    if cfg.n_cross_layers:
        specs["enc"] = P(baxis, None, None)
    return specs


def cache_pspecs(cfg: ArchConfig, *, multi_pod: bool, batch: int,
                 axis_size: int = 16) -> Dict[str, Any]:
    bp = batch_axes(multi_pod)
    dp_size = 16 * (2 if multi_pod else 1)
    if _div(batch, dp_size):
        baxis: Any = bp
    elif _div(batch, 16):
        baxis = bp[-1]
    else:
        baxis = None
    kv_sharded = cfg.n_kv and _div(cfg.n_kv, axis_size)
    specs: Dict[str, Any] = {"len": P()}
    if cfg.mixer in ("attn", "hymba"):
        if baxis is not None:
            seq_ax = None if kv_sharded else MODEL_AXIS
            head_ax = MODEL_AXIS if kv_sharded else None
            specs["k"] = P(None, baxis, seq_ax, head_ax, None)
        else:
            # long-context, batch 1: context parallelism over data(+pod)
            head_ax = MODEL_AXIS if kv_sharded else None
            specs["k"] = P(None, None, bp, head_ax, None)
        specs["v"] = specs["k"]
    if cfg.mixer in ("mamba", "hymba"):
        di = cfg.ssm.expand * cfg.d_model
        di_ax = _model_if(di, axis_size)
        specs["ssm_conv"] = P(None, baxis, None, di_ax)
        specs["ssm_h"] = P(None, baxis, di_ax, None)
    if cfg.n_cross_layers:
        head_ax = MODEL_AXIS if kv_sharded else None
        specs["cross_k"] = P(None, baxis, None, head_ax, None)
        specs["cross_v"] = specs["cross_k"]
    return specs


def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes one dim's entry of a spec names, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def iter_specs(tree: Any, path: Tuple[str, ...] = ()):
    """(path of keys, spec) of every spec in a tree of them."""
    if isinstance(tree, PartitionSpec):
        yield path, tree
        return
    for k, v in tree.items():
        yield from iter_specs(v, path + (k,))


def to_placements(mesh, tree: Any) -> Any:
    """PartitionSpec (or tree of them) -> placements, one per mesh dim:
    ``Shard(d)`` where the spec puts that mesh axis on dim ``d``, else
    ``Replicate()``.  A dim over several axes takes them major first, in
    the mesh's order, as the JAX package's ``NamedSharding`` does."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names

    def one(spec):
        where = {}
        for d, entry in enumerate(spec):
            axes = axes_of(entry)
            if [names.index(a) for a in axes] != \
                    sorted(names.index(a) for a in axes):
                raise ValueError(f"{spec}: the axes of dim {d} are not in "
                                 f"the mesh's order {names}")
            for a in axes:
                if a in where:
                    raise ValueError(f"{spec}: axis {a!r} named twice")
                where[a] = d
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in names)

    def walk(t):
        if isinstance(t, PartitionSpec):
            return one(t)
        return {k: walk(v) for k, v in t.items()}
    return walk(tree)


def distribute_params(params, cfg: ArchConfig, mesh, *,
                      axis_size: int = 16):
    """The port's parameter tree (a ``DecoderLM``) with every leaf a
    ``DTensor`` on ``mesh``: a layer's leaf takes the trailing part of its
    stacked spec (the stacked dim is never sharded).  Every rank passes
    the same full tree (rank 0's values are the ones scattered).  A dim
    that does not divide by the ranks it is sharded over raises, where
    ``DTensor`` would split it unevenly and the JAX package refuses."""
    from torch.distributed.tensor import distribute_tensor

    specs = param_pspecs(cfg, axis_size=axis_size)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = []
    for leaf in leaves(params):
        spec = specs
        for key in leaf.path:
            spec = spec[key]
        if leaf.index is not None:
            spec = P(*spec[1:])
        shape = tuple(leaf.value.shape)
        for d, entry in enumerate(spec):
            ranks = 1
            for a in axes_of(entry):
                ranks *= sizes[a]
            if shape[d] % ranks:
                raise ValueError(
                    f"{leaf.name}: dim {d} of {shape} does not divide "
                    f"over {entry} ({ranks} ranks)")
        out.append(distribute_tensor(leaf.value.detach(), mesh,
                                     to_placements(mesh, spec)))
    return rebuild(params, out)


def activation_shard_fn(mesh, cfg: ArchConfig, *, multi_pod: bool):
    """The ``shard(x, name)`` callback threaded through the model code: a
    ``DTensor`` ``x`` redistributed on ``mesh`` to the spec of ``name``
    (unknown names and plain tensors are returned as they are).  The JAX
    package's table, ``seq_shard`` read from the perf flags when the
    callback is made, with the MoE buffers laid out as the port lays them
    out, (E, B*C, d|f) for the JAX package's (B, E, C, d|f): the batch
    axes on the B*C dim (a row's C entries are contiguous in it), the
    dispatch buffer expert-replicated across ``model`` as the JAX
    package's is, the experts' hidden activations expert-sharded."""
    bp = batch_axes(multi_pod)
    vocab_ax = _model_if(cfg.vocab)
    seq_ax = MODEL_AXIS if get_flags().seq_shard else None
    table = {
        "hidden": P(bp, seq_ax, None),
        "logits": P(bp, None, vocab_ax),
        "moe_buf": P(None, bp, None),
        "moe_h": P(MODEL_AXIS, bp, None),
    }
    placements = to_placements(mesh, table)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def shard(x, name):
        from torch.distributed.tensor import DTensor, Replicate
        if name not in placements or not isinstance(x, DTensor):
            return x
        # a dim that does not divide over its ranks stays whole (JAX pads
        # it; DTensor would split it unevenly, which its views refuse):
        # a decode step's one position under seq_shard
        pl = list(placements[name])
        for d, entry in enumerate(table[name]):
            ranks = math.prod(sizes[a] for a in axes_of(entry))
            if x.shape[d] % ranks:
                pl = [Replicate() if getattr(p, "dim", None) == d else p
                      for p in pl]
        return constrain(x, pl)

    return shard
