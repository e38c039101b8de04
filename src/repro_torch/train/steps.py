"""Step factories: train_step / prefill_step / decode-serve_step.

The port of the JAX package's ``repro.train.steps``.  Each factory closes
over the ArchConfig and the optimizer config and returns a plain
function.  ``train_step`` differentiates :func:`lm_loss` with
``torch.autograd``: it gives the float32 master leaves fresh Parameters
that require a gradient (sharing their storage), so the model's casts at
every use (``.to(compute_dtype)``) carry each gradient back to its
master in the master's dtype, through K6 and K7's autograd Functions on
the card.  The step then applies :func:`optimizer.adamw_update` and
returns new trees; its arguments are left as they were.

The JAX package's chunked cross entropy (``perf_flags.ce_impl=
"chunked"``) is not ported: it comes with ``models/perf_flags.py`` and
the launcher that sets its flags.  ``lm_loss`` is the default
``ce_impl="full"`` path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models.config import ArchConfig
from ..models.model import decode_step as model_decode
from ..models.model import forward, prefill
from ..models.tree import leaves, rebuild, tree_map
from .optimizer import AdamWConfig, OptState, adamw_update

__all__ = ["build_decode_step", "build_prefill_step", "build_train_step",
           "lm_loss"]


def lm_loss(params, cfg: ArchConfig, batch: Dict[str, Any], *,
            compute_dtype=torch.bfloat16, z_loss: float = 1e-4
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (+ z-loss) over a batch.

    batch: {"inputs": (B,S) int or (B,S,D) float, "targets": (B,S) int,
            optional "enc": (B,E,D)}, numpy arrays or tensors.
    """
    logits = forward(params, cfg, batch["inputs"], enc=batch.get("enc"),
                     compute_dtype=compute_dtype)
    lg = logits[:, :-1].to(torch.float32)
    labels = torch.as_tensor(batch["targets"],
                             device=lg.device)[:, 1:].long()
    logz = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels[..., None])[..., 0]
    ce = torch.mean(logz - ll)
    loss = ce + z_loss * torch.mean(torch.square(logz))
    return loss, {"loss": ce}


def _grad_leaves(params):
    """``params`` with every floating leaf a fresh Parameter that requires
    a gradient (same storage), and those Parameters in leaf order."""
    leafy = tree_map(lambda p: p.detach().requires_grad_(
        p.is_floating_point()), params)
    return leafy, [leaf.value for leaf in leaves(leafy)]


def build_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                     *, microbatches: int = 1,
                     compute_dtype=torch.bfloat16,
                     grad_transform: Optional[Callable] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics).

    microbatches > 1 accumulates float32 gradients over equal batch
    slices, one after another, and takes their mean (and the mean loss).
    ``grad_transform`` maps the gradient tree before the update (the
    hook the JAX package's gradient compression uses).
    """

    def value_and_grad(params, mb):
        leafy, inputs = _grad_leaves(params)
        with torch.enable_grad():
            loss, aux = lm_loss(leafy, cfg, mb, compute_dtype=compute_dtype)
            grads = torch.autograd.grad(
                loss, [t for t in inputs if t.requires_grad],
                allow_unused=True)
        it = iter(grads)
        flat = []
        for t in inputs:
            g = next(it) if t.requires_grad else None
            flat.append(torch.zeros_like(t) if g is None else g)
        return (loss.detach(), {k: v.detach() for k, v in aux.items()},
                rebuild(params, flat))

    def train_step(params, opt_state: OptState, batch):
        if microbatches == 1:
            loss, aux, grads = value_and_grad(params, batch)
        else:
            def split(x, i):
                x = torch.as_tensor(x)
                n = x.shape[0] // microbatches
                return x[i * n:(i + 1) * n]
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32)
            for i in range(microbatches):
                mb = {k: split(v, i) for k, v in batch.items()}
                l_i, _, g = value_and_grad(params, mb)
                grads = tree_map(torch.add, grads, g)
                loss = loss.to(l_i.device) + l_i
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            aux = {"loss": loss}
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  opt_cfg)
        metrics.update(aux)
        return params, opt_state, metrics

    return train_step


def build_prefill_step(cfg: ArchConfig, *, smax: int,
                       compute_dtype=torch.bfloat16):
    """Inference-prefill: logits for the last position + filled caches."""

    @torch.no_grad()
    def prefill_step(params, batch):
        return prefill(params, cfg, batch["inputs"], smax=smax,
                       enc=batch.get("enc"), compute_dtype=compute_dtype)

    return prefill_step


def build_decode_step(cfg: ArchConfig, *, compute_dtype=torch.bfloat16,
                      greedy: bool = True):
    """Serving decode: one new token for every sequence in the batch
    (greedy: the argmax id, also for an audio backbone, whose frontend
    consumes the logits)."""

    @torch.no_grad()
    def serve_step(params, token, cache):
        logits, cache = model_decode(params, cfg, token, cache,
                                     compute_dtype=compute_dtype)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, cache

    return serve_step
