"""GPipe-style pipeline parallelism over the ``pod`` axis (optional).

The port of the JAX package's ``repro.sharding.pipeline`` on
``torch.distributed``.  Layers are partitioned into ``n_stages``
contiguous stages (stage s owns layers [s*L/S, (s+1)*L/S)); microbatches
stream through the stages in the classic GPipe schedule of ``n_micro +
n_stages - 1`` ticks (bubble fraction (S-1)/(M+S-1)), ``send``/``recv``
handing each activation to the next stage, and the last stage's outputs
reach every rank by a masked all-reduce, as the JAX package's masked
``psum`` does.

A stage computes only at the ticks where its input is a microbatch: the
JAX schedule also runs every stage at the other ticks, on zeros or a
repeated microbatch, and discards those results, so the outputs are the
same.

Forward only: the port's :func:`gpipe` carries no gradient across the
stages (the JAX docstring claims ``jax.grad`` goes through its
``ppermute``; no JAX test checks it).  It raises when gradients are on
and an input or a stage parameter requires one.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..models.tree import leaves, tree_map

__all__ = ["gpipe", "stage_split"]


def _group(mesh_or_group, axis: str) -> dist.ProcessGroup:
    if isinstance(mesh_or_group, dist.ProcessGroup):
        return mesh_or_group
    return mesh_or_group.get_group(axis)


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
          mesh_or_group, axis: str = "pod"):
    """Build pipeline_apply(stage_params, x_micro) -> y_micro.

    stage_params: tree whose tensor leaves have a leading ``n_stages``
    dim (``stage_split``); each rank reads its stage's slice, its rank in
    the group of ``axis`` (or in the group given).
    x_micro: (n_micro, mb, ...) microbatched inputs, the same on every
    rank.  Returns (n_micro, mb, ...) outputs of the LAST stage, in
    x_micro's dtype, on every rank.  ``stage_fn`` must give each
    microbatch's output x_micro's shape and dtype, as the JAX package's
    scan carry must.
    """
    group = _group(mesh_or_group, axis)

    def apply(stage_params, x_micro: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and (x_micro.requires_grad or any(
                leaf.value.requires_grad for leaf in leaves(stage_params))):
            raise RuntimeError(
                "gpipe carries no gradient across stages: call it under "
                "torch.no_grad() or with inputs that require none")
        n_stages = dist.get_world_size(group)
        stage = dist.get_rank(group)
        params_here = tree_map(lambda a: a[stage], stage_params)
        n_micro = x_micro.shape[0]
        mb_shape = x_micro.shape[1:]
        prev = dist.get_global_rank(group, stage - 1) if stage else None
        nxt = dist.get_global_rank(group, stage + 1) \
            if stage < n_stages - 1 else None
        outputs = torch.zeros((n_micro,) + mb_shape, dtype=x_micro.dtype,
                              device=x_micro.device)
        sends = []
        with torch.no_grad():
            # stage s runs microbatch t - s at tick t
            for t in range(stage, stage + n_micro):
                if stage == 0:
                    x_t = x_micro[t]
                else:
                    x_t = torch.empty(mb_shape, dtype=x_micro.dtype,
                                      device=x_micro.device)
                    dist.recv(x_t, src=prev, group=group)
                y = stage_fn(params_here, x_t)
                if y.shape != mb_shape or y.dtype != x_micro.dtype:
                    raise ValueError(
                        f"stage_fn gave {tuple(y.shape)} {y.dtype} for a "
                        f"microbatch of {tuple(mb_shape)} {x_micro.dtype}")
                if nxt is not None:
                    y = y.contiguous()
                    sends.append((y, dist.isend(y, dst=nxt, group=group)))
                else:
                    outputs[t - stage] = y
            for _, work in sends:
                work.wait()
            # broadcast the last stage's outputs to every rank (the other
            # stages hold zeros: a masked all-reduce)
            dist.all_reduce(outputs, op=dist.ReduceOp.SUM, group=group)
        return outputs

    return apply


def stage_split(tree: Any, n_stages: int) -> Any:
    """(L, ...) stacked layer params -> (n_stages, L/n_stages, ...)."""
    def split(a):
        n = a.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} "
                             f"stages")
        return a.reshape((n_stages, n // n_stages) + tuple(a.shape[1:]))
    return tree_map(split, tree)
