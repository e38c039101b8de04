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

Every factory takes the JAX package's ``shard`` callback
(``sharding.specs.activation_shard_fn``) and hands it to the model.
``lm_loss`` follows ``perf_flags.ce_impl``: ``"full"`` (the default)
forms the (B, S, V) float32 logits; ``"chunked"`` runs the unembed and
the cross entropy ``ce_chunk`` positions at a time, each chunk under
``torch.utils.checkpoint`` (made again in the backward), so those
logits never exist.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.sharded import as_dtensor, is_dtensor
from ..models.config import ArchConfig
from ..models.model import _unembed
from ..models.model import decode_step as model_decode
from ..models.model import forward, prefill
from ..models.perf_flags import get_flags
from ..models.transformer import ShardFn, _noshard
from ..models.tree import leaves, rebuild, tree_map
from .optimizer import AdamWConfig, OptState, adamw_update

__all__ = ["build_decode_step", "build_prefill_step", "build_train_step",
           "lm_loss"]


def _picked(lg, labels):
    """``lg[..., labels]``: the logit of each target.  For a ``DTensor``
    lg each rank picks from its own vocab shard (zero where the target
    lies in another's) and the picks are summed over the vocab ranks: a
    gather on the whole ``DTensor`` builds its backward's zero gradient at
    the global shape on every rank."""
    if not is_dtensor(lg):
        return torch.gather(lg, -1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, v = lg.device_mesh, lg.ndim - 1
    lpl = [p if isinstance(p, Shard) and p.dim in (0, v) else Replicate()
           for p in lg.placements]
    bpl = [Shard(0) if p == Shard(0) else Replicate() for p in lpl]
    vocab = [i for i, p in enumerate(lpl) if p == Shard(v)]

    def pick(lg_l, lab_l):
        coord, r = mesh.get_coordinate(), 0
        for i in vocab:
            r = r * mesh.size(i) + coord[i]
        idx = lab_l - r * lg_l.shape[-1]
        inside = (idx >= 0) & (idx < lg_l.shape[-1])
        ll = torch.gather(lg_l, -1, torch.where(inside, idx, 0)[..., None])
        return torch.where(inside, ll[..., 0], 0)
    ll = local_map(pick, out_placements=[
        Partial() if i in vocab else p for i, p in enumerate(bpl)],
        in_placements=(lpl, bpl), device_mesh=mesh)(
        lg.redistribute(mesh, lpl),
        as_dtensor(labels, mesh).redistribute(mesh, bpl))
    return ll.redistribute(mesh, bpl)


def _gathered(t, dim: int):
    """``t``, a ``DTensor`` with ``dim`` gathered (replicated)."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [
        Replicate() if getattr(p, "dim", None) == dim else p
        for p in t.placements])


def _chunked_ce(params, cfg: ArchConfig, x, targets, chunk: int):
    """Sums of the cross entropy and of logz^2 over the positions 0..S-2
    of the final hidden states ``x`` (B, S, d), ``chunk`` positions at a
    time; the last chunk is padded with rows of weight 0, as the JAX
    package pads it.  Each chunk's unembed runs under a checkpoint."""
    b, s, d = x.shape
    c = min(chunk, s - 1)
    n_chunks = -(-(s - 1) // c)
    pad = n_chunks * c - (s - 1)
    xp = F.pad(x[:, :-1], (0, 0, 0, pad))
    yp = F.pad(targets[:, 1:], (0, pad))
    wp = F.pad(torch.ones((b, s - 1), dtype=torch.float32,
                          device=x.device), (0, pad))

    def chunk_ce(x_c, y_c, w_c):
        lg = _unembed(params, cfg, x_c).to(torch.float32)
        logz = torch.logsumexp(lg, dim=-1)
        ll = _picked(lg, y_c)
        return (torch.sum((logz - ll) * w_c),
                torch.sum(torch.square(logz) * w_c))
    ce_sum = z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        ce_c, z_c = checkpoint(chunk_ce, xp[:, sl], yp[:, sl], wp[:, sl],
                               use_reentrant=False)
        ce_sum, z_sum = ce_sum + ce_c, z_sum + z_c
    return ce_sum, z_sum


def lm_loss(params, cfg: ArchConfig, batch: Dict[str, Any], *,
            compute_dtype=torch.bfloat16, shard: ShardFn = _noshard,
            z_loss: float = 1e-4
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (+ z-loss) over a batch.

    batch: {"inputs": (B,S) int or (B,S,D) float, "targets": (B,S) int,
            optional "enc": (B,E,D)}, numpy arrays or tensors.
    """
    flags = get_flags()
    if flags.ce_impl == "chunked":
        x = forward(params, cfg, batch["inputs"], enc=batch.get("enc"),
                    compute_dtype=compute_dtype, shard=shard,
                    return_hidden=True)
        b, s = x.shape[:2]
        targets = torch.as_tensor(batch["targets"], device=x.device).long()
        ce_sum, z_sum = _chunked_ce(params, cfg, x, targets, flags.ce_chunk)
        denom = b * (s - 1)
        ce = ce_sum / denom
        return ce + z_loss * z_sum / denom, {"loss": ce}
    logits = forward(params, cfg, batch["inputs"], enc=batch.get("enc"),
                     compute_dtype=compute_dtype, shard=shard)
    lg = logits[:, :-1].to(torch.float32)
    labels = torch.as_tensor(batch["targets"],
                             device=lg.device)[:, 1:].long()
    logz = torch.logsumexp(lg, dim=-1)
    ll = _picked(lg, labels)
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
                     shard: ShardFn = _noshard,
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
            loss, aux = lm_loss(leafy, cfg, mb, compute_dtype=compute_dtype,
                                shard=shard)
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
                       compute_dtype=torch.bfloat16,
                       shard: ShardFn = _noshard):
    """Inference-prefill: logits for the last position + filled caches."""

    @torch.no_grad()
    def prefill_step(params, batch):
        return prefill(params, cfg, batch["inputs"], smax=smax,
                       enc=batch.get("enc"), compute_dtype=compute_dtype,
                       shard=shard)

    return prefill_step


def build_decode_step(cfg: ArchConfig, *, compute_dtype=torch.bfloat16,
                      shard: ShardFn = _noshard, greedy: bool = True):
    """Serving decode: one new token for every sequence in the batch
    (greedy: the argmax id, also for an audio backbone, whose frontend
    consumes the logits)."""

    @torch.no_grad()
    def serve_step(params, token, cache):
        logits, cache = model_decode(params, cfg, token, cache,
                                     compute_dtype=compute_dtype,
                                     shard=shard)
        # a vocab-sharded DTensor's argmax is taken on the gathered logits
        # (DTensor's sharded argmax fails on a batch of one)
        whole = _gathered(logits, logits.ndim - 1)
        next_tok = torch.argmax(whole, dim=-1).to(torch.int32)
        return next_tok, logits, cache

    return serve_step
