"""Gradient compression: int8-quantized data-parallel all-reduce.

The port of the JAX package's ``repro.sharding.compression`` on
``torch.distributed``.  :func:`make_compressed_grad_transform` gives the
``grad_transform`` hook of ``train/steps.py::build_train_step``: every
gradient leaf is all-reduced over the data-parallel ranks as int8 values
with one float32 scale a block of :data:`BLOCK` elements, shared by all
ranks (the largest block maximum of any rank).

The values on the wire are summed as int32 (8 ranks' int8 values
overflow an int8 sum), so the second all-reduce moves 4 bytes an element,
as many as float32 would: the JAX package's docstring claims 1 byte, and
its code sums int32 too.  No error-feedback residual is carried, as the
JAX code carries none.

The operations keep the JAX package's order so that the results are the
same bits: pad to a multiple of 256, the block max of ``abs``, MAX over
the ranks, ``scale = max(shared_max / 127, 1e-12)``, round half to even,
clamp to +-127, int8, SUM as int32, then ``q * scale / n``.  Every
quotient is a true division by a tensor: PyTorch's CUDA kernels multiply
by the reciprocal of a Python-scalar divisor, which can round ``x / 127``
one ulp away and move a quantized value.
"""

from __future__ import annotations

import itertools
from typing import Any, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.tree import leaves, rebuild
from .specs import axes_of, iter_specs

__all__ = ["BLOCK", "compressed_psum", "dp_groups",
           "make_compressed_grad_transform"]

BLOCK = 256

Groups = Union[dist.ProcessGroup, Sequence[dist.ProcessGroup]]


def _over(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d``, rounded once (``d`` a tensor on x's device)."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _blocks(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    return F.pad(flat, (0, (-flat.shape[0]) % BLOCK)).view(-1, BLOCK)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    blocks = _blocks(x)
    scale = _over(torch.amax(torch.abs(blocks), dim=-1, keepdim=True), 127.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
                n: int) -> torch.Tensor:
    blocks = q.to(torch.float32) * scale
    return blocks.reshape(-1)[:n].reshape(shape)


def _as_groups(groups: Groups) -> Tuple[dist.ProcessGroup, ...]:
    return tuple(groups) if isinstance(groups, (list, tuple)) else (groups,)


def compressed_psum(x: torch.Tensor, groups: Groups) -> torch.Tensor:
    """Shared-scale int8 mean-all-reduce of ``x`` over the ranks of
    ``groups`` (one process group, or several whose product is the
    data-parallel set: MAX and an integer SUM over each in turn equal
    them over the product, bit for bit).

    Phase 1: MAX of the local block maxima -> a shared per-block scale;
    phase 2: quantize with the shared scale, SUM in int32, dequantize.
    """
    groups = _as_groups(groups)
    n_dev = 1
    for g in groups:
        n_dev *= dist.get_world_size(g)
    n = x.numel()
    blocks = _blocks(x)
    shared_max = torch.amax(torch.abs(blocks), dim=-1, keepdim=True)
    for g in groups:
        dist.all_reduce(shared_max, op=dist.ReduceOp.MAX, group=g)
    scale = torch.clamp(_over(shared_max, 127.0), min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    qsum = q.to(torch.int32)
    for g in groups:
        dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=g)
    mean = _over(qsum.to(torch.float32) * scale, n_dev)
    return mean.reshape(-1)[:n].reshape(x.shape)


def dp_groups(mesh_or_group, dp_axes: Sequence[str] = ()
              ) -> Tuple[dist.ProcessGroup, ...]:
    """The process groups of ``dp_axes`` on a ``DeviceMesh``, or the one
    group given."""
    if isinstance(mesh_or_group, dist.ProcessGroup):
        return (mesh_or_group,)
    return tuple(mesh_or_group.get_group(a) for a in dp_axes)


def make_compressed_grad_transform(mesh_or_group, dp_axes: Sequence[str],
                                   param_specs: Any = None):
    """Returns grads -> grads applying the int8 all-reduce over the DP
    ranks, for ``build_train_step(grad_transform=...)``.

    Each leaf is quantized as the JAX package stacks it: the layers'
    copies of a leaf (``models.tree`` order) are flattened in layer order
    into one vector, blocked, reduced and split back, so a block may
    straddle two layers (hymba's d_inner 3200 = 12.5 blocks).

    The port's train step holds every leaf whole on every rank, so the
    vector reduced is the whole stacked leaf, the JAX package's local
    shard when the leaf is not sharded.  A ``param_specs`` tree (from
    ``param_pspecs``) that shards a leaf over a mesh axis of more than one
    rank raises: its JAX blocks would be that axis's shards.
    """
    groups = dp_groups(mesh_or_group, dp_axes)
    if param_specs is not None and not isinstance(mesh_or_group,
                                                  dist.ProcessGroup):
        sizes = dict(zip(mesh_or_group.mesh_dim_names, mesh_or_group.shape))
        for path, spec in iter_specs(param_specs):
            for a in (a for entry in spec for a in axes_of(entry)):
                if sizes.get(a, 1) > 1:
                    raise ValueError(
                        f"{'__'.join(path)} is sharded over {a!r} "
                        f"({sizes[a]} ranks); the port's train step holds "
                        f"every leaf whole")

    def transform(grads):
        out = []
        for _, group in itertools.groupby(leaves(grads),
                                          key=lambda leaf: leaf.path):
            parts = [leaf.value for leaf in group]
            reduced = compressed_psum(
                torch.cat([p.reshape(-1) for p in parts]), groups)
            out += [r.view(p.shape) for p, r in zip(
                parts, reduced.split([p.numel() for p in parts]))]
        return rebuild(grads, out)

    return transform
