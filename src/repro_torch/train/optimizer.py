"""AdamW, written out in PyTorch (not ``torch.optim.AdamW``, whose bias
correction, decay and clipping differ from the JAX package's).

The port of the JAX package's ``repro.train.optimizer``: global-norm
clipping, linear warmup then cosine decay, bias-corrected moments kept
in ``moment_dtype`` (bfloat16 by default) with the update arithmetic in
float32, and decoupled weight decay on every leaf whose rank *as the JAX
package stacks it* is at least 2.  The JAX package stacks each layer
leaf (L, ...), so it decays every layer's norm weights and biases too;
only top-level vectors (``final_norm``) and the stacked scalars of a
cross layer (``gate_attn``, ``gate_mlp``: (L,)) escape.  The port keeps
layers unstacked, so it decides by :attr:`models.tree.Leaf.stacked_ndim`,
not by the tensor's own rank.

Trees are those of :mod:`repro_torch.models.tree`: a ``DecoderLM``, or
dicts and named tuples of tensors.  The update is out of place: it
returns new trees and leaves its arguments as they were.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.transformer import params_from_reference
from ..models.tree import leaves, rebuild, tree_map

__all__ = ["AdamWConfig", "OptState", "adamw_update", "global_norm",
           "init_opt_state", "lr_schedule", "opt_state_from_reference",
           "opt_state_shapes"]


@dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.bfloat16


class OptState(NamedTuple):
    step: torch.Tensor       # int32 scalar
    m: Any                   # tree like params
    v: Any


def _device_of(params) -> torch.device:
    return leaves(params)[0].value.device


def init_opt_state(params, cfg: AdamWConfig) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=_device_of(params)),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def opt_state_shapes(params_shapes, cfg: AdamWConfig) -> OptState:
    """``(shape, dtype)`` mirror of :func:`init_opt_state` over a tree of
    shapes (``models.param_shapes``), for sizing."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return (tuple(t), cfg.moment_dtype)
    return OptState(step=((), torch.int32), m=walk(params_shapes),
                    v=walk(params_shapes))


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to lr_min_ratio * peak (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr_peak * step / max(1, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0,
                       1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr_peak * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.value.to(
        torch.float32))) for leaf in leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state: OptState, cfg: AdamWConfig
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.grad_clip else 1.0
    lr = lr_schedule(cfg, step)
    f32 = torch.float32
    b1c = 1 - torch.pow(cfg.b1, step.to(f32))
    b2c = 1 - torch.pow(cfg.b2, step.to(f32))

    new_p, new_m, new_v = [], [], []
    for leaf, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                             leaves(state.v)):
        p, g, m, v = leaf.value, g.value, m.value, v.value
        g = g.to(f32) * scale
        m32 = cfg.b1 * m.to(f32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(f32) + (1 - cfg.b2) * g * g
        mhat = m32 / b1c
        vhat = v32 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay and leaf.stacked_ndim >= 2:   # not final_norm
            delta = delta + cfg.weight_decay * p.to(f32)
        new_p.append((p.to(f32) - lr * delta).to(p.dtype))
        new_m.append(m32.to(m.dtype))
        new_v.append(v32.to(v.dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return (rebuild(params, new_p),
            OptState(step, rebuild(state.m, new_m), rebuild(state.v, new_v)),
            metrics)


def opt_state_from_reference(cfg, opt_tree, *, device="cuda") -> OptState:
    """The JAX package's ``OptState`` (its ``step``, and ``m`` and ``v``
    as parameter trees of numpy arrays, layers stacked) as the port's,
    on ``device``, dtypes kept."""
    dev = resolve_device(device)
    step, m, v = opt_tree
    return OptState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev),
        m=params_from_reference(cfg, m, device=dev),
        v=params_from_reference(cfg, v, device=dev))
