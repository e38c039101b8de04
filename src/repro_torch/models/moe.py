"""Mixture-of-Experts layer with row-local capacity dispatch, in PyTorch.

The port of the JAX package's ``repro.models.moe``: :func:`moe_mlp` on
its default path (``moe_combine="gather"``, ``moe_impl="pjit"``) and
:func:`moe_mlp_shardmap`, its explicit expert parallelism, on
``torch.distributed``.  The dispatch of :func:`moe_mlp` is per sequence
(row):

1. router top-k per token (float32 logits, padded experts masked to
   ``-1e30``, softmax, top-k in ``lax.top_k``'s order: ties to the lower
   expert id, then renormalized);
2. per-row counting sort: the position of each (token, choice) within
   its expert is the exclusive cumulative count of one-hots along the
   row, flattened token-major; the capacity of a (row, expert) is
   ``max(k, round(S*k/E * cf))`` with Python's ``round`` (half to even);
   entries at or past it are dropped;
3. scatter into a zero expert buffer, the experts' SwiGLU over the whole
   buffer, and a gather-combine weighted by the router probabilities in
   float32, each token's k choices added in order (deterministic: no
   atomics);
4. optional dense shared experts gated by a sigmoid (qwen2-moe).

The buffer is laid out (E, B*C, d) where the JAX package has (B, E, C,
d): one batched product an expert, the same sums.  The ``shard`` callback
names the buffers as the JAX package names its own: ``"moe_buf"`` for the
dispatch buffer (and, with ``perf_flags.moe_combine="gather"``, the
expert outputs), ``"moe_h"`` for the experts' hidden activations (and,
with ``"sharded"``, the expert outputs: the JAX package's code tests
``== "sharded"``, which the port keeps).  The specs behind the names
(``sharding.specs.activation_shard_fn``) are written for the port's
layout.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels.sharded import (as_dtensor, batch_only, is_dtensor,
                               replicated)
from .config import MoEConfig
from .layers import mlp_swiglu, _silu
from .perf_flags import get_flags

__all__ = ["capacity_of", "dispatch", "moe_mlp", "moe_mlp_shardmap",
           "router_topk"]

#: the logit the JAX package gives padded experts
PAD_LOGIT = -1e30


def router_topk(x: torch.Tensor, w_router: torch.Tensor, moe: MoEConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (weights (B, S, k) float32, expert ids (B, S, k)
    int64).  Equal probabilities are taken lowest id first, as
    ``lax.top_k`` takes them (a stable descending sort)."""
    logits = torch.matmul(x.float(), w_router.float())
    e_pad = w_router.shape[1]
    if e_pad > moe.n_experts:                      # mask padded experts
        logits[..., moe.n_experts:] = PAD_LOGIT
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :moe.top_k], idx[..., :moe.top_k]
    if moe.router_norm_topk:
        vals = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
    return vals, idx


def capacity_of(s: int, moe: MoEConfig) -> int:
    """Entries an expert takes from a row of ``s`` tokens: the JAX
    package's expression, Python's ``round`` included."""
    k = moe.top_k
    return int(max(k, round(s * k / moe.n_experts * moe.capacity_factor)))


def dispatch(experts: torch.Tensor, e_pad: int, capacity: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """experts: (B, S, k) ids -> (position of each (token, choice) within
    its expert's row-local queue, whether it is kept), each (B, S*k),
    flattened token-major as ``experts.reshape(b, s*k)``."""
    b = experts.shape[0]
    flat_e = experts.reshape(b, -1)
    onehot = F.one_hot(flat_e, e_pad)                               # (B,Sk,E)
    pos_all = torch.cumsum(onehot, dim=1) - onehot                  # exclusive
    pos = torch.gather(pos_all, 2, flat_e[..., None])[..., 0]
    return pos, pos < capacity


def _route(x, w_router, moe: MoEConfig):
    """The row-local dispatch of x (B, S, d): (the (E, B*C, d) expert
    buffer, each (token, choice)'s row in it (B, S*k), and its router
    weight, zero where dropped, (B, S*k) float32)."""
    b, s, d = x.shape
    e_pad = w_router.shape[1]
    k = moe.top_k
    sk = s * k
    weights, experts = router_topk(x, w_router, moe)               # (B,S,k)
    capacity = capacity_of(s, moe)
    pos, keep = dispatch(experts, e_pad, capacity)                  # (B, S*k)
    flat_e = experts.reshape(b, sk)
    flat_w = weights.reshape(b, sk)

    # ---- into (E, B*C) rows, one spare row for drops ------------------------
    rows = torch.arange(b, device=x.device)[:, None]
    slot = (flat_e * b + rows) * capacity                           # (B, S*k)
    dest = torch.where(keep, slot + pos, e_pad * b * capacity)
    tok = x.reshape(b, s, 1, d).expand(b, s, k, d).reshape(b, sk, d)
    gathered = torch.where(keep[..., None], tok, 0).to(x.dtype)
    buf = torch.zeros((e_pad * b * capacity + 1, d), dtype=x.dtype,
                      device=x.device)
    buf[dest.reshape(-1)] = gathered.reshape(-1, d)
    return (buf[:-1].view(e_pad, b * capacity, d),
            slot + torch.where(keep, pos, 0), (flat_w * keep).float())


def _combine(out_buf, src, wk, s: int, k: int):
    """Each token's k expert outputs weighted by the router and added in
    order from a zero float32 sum: (B, S, d) float32."""
    b, d = src.shape[0], out_buf.shape[-1]
    expert_out = out_buf.reshape(-1, d)[src.reshape(-1)].reshape(b, s * k, d)
    expert_out = expert_out * wk[..., None]
    expert_out = expert_out.reshape(b, s, k, d)
    y = torch.zeros((b, s, d), dtype=torch.float32, device=out_buf.device)
    for j in range(k):
        y = y + expert_out[:, :, j]
    return y


def _route_dtensor(x, w_router, moe: MoEConfig):
    """:func:`_route` of a ``DTensor`` x, a batch shard a rank (its rows
    whole, so each rank's dispatch is the rows' own): the buffer (E, B*C,
    d) with its B*C dim sharded as x's batch, the rows and weights (B,
    S*k) as x's batch."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    from torch.distributed.tensor import Partial, Replicate
    mesh = x.device_mesh
    xp = batch_only(x.placements)
    bufp = [Shard(1) if p == Shard(0) else p for p in xp]
    # the router's gradient: each batch shard's part, summed over them
    wgrad = [Partial() if p == Shard(0) else Replicate() for p in xp]
    return local_map(lambda x_, w_: _route(x_, w_, moe),
                     out_placements=(bufp, list(xp), list(xp)),
                     in_placements=(xp, replicated(mesh)),
                     in_grad_placements=(xp, wgrad),
                     device_mesh=mesh)(
        x.redistribute(mesh, xp), as_dtensor(w_router, mesh).redistribute(
            mesh, replicated(mesh)))


def _combine_dtensor(out_buf, src, wk, s: int, k: int):
    """:func:`_combine` with the expert outputs gathered over the experts
    and each rank combining its batch shard."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = src.device_mesh
    xp = batch_only(src.placements)
    bufp = [Shard(1) if p == Shard(0) else p for p in xp]
    return local_map(lambda o, r, w: _combine(o, r, w, s, k),
                     out_placements=list(xp), in_placements=(bufp, xp, xp),
                     device_mesh=mesh)(
        out_buf.redistribute(mesh, bufp), src, wk)


def moe_mlp(x: torch.Tensor, params: Dict[str, torch.Tensor],
            moe: MoEConfig, shard=lambda x, name: x) -> torch.Tensor:
    """x: (B, S, d).  params: w_router (d, E_pad); wg/wu (E_pad, d,
    d_expert); wd (E_pad, d_expert, d); optional shared experts sg/su (d,
    d_shared), sd (d_shared, d), shared_gate (d,).  ``shard(t, name)``
    places the (E, B*C, .) buffers."""
    s, k = x.shape[1], moe.top_k
    if is_dtensor(x):
        buf, src, wk = _route_dtensor(x, params["w_router"], moe)
    else:
        buf, src, wk = _route(x, params["w_router"], moe)
    buf = shard(buf, "moe_buf")

    # ---- expert compute ------------------------------------------------------
    g = torch.bmm(buf, params["wg"])
    u = torch.bmm(buf, params["wu"])
    h = shard((_silu(g) * u).to(x.dtype), "moe_h")
    out_buf = torch.bmm(h, params["wd"]).to(x.dtype)
    out_buf = shard(out_buf, "moe_h" if get_flags().moe_combine == "sharded"
                    else "moe_buf")
    y = (_combine_dtensor if is_dtensor(out_buf) else _combine)(
        out_buf, src, wk, s, k)

    # ---- shared experts (qwen2-moe) -------------------------------------------
    if moe.n_shared and "sg" in params:
        shared = mlp_swiglu(x, params["sg"], params["su"], params["sd"])
        z = torch.matmul(x.float(), params["shared_gate"].float())
        gate = 1 / (1 + torch.exp(-z))
        y = y + shared.float() * gate[..., None]
    return y.to(x.dtype)


def _moe_groups(mesh_or_group, bp_axes: Sequence[str]):
    """(the ``model`` group, the batch axes' groups major first)."""
    if isinstance(mesh_or_group, dist.ProcessGroup):
        if bp_axes:
            raise ValueError("batch axes need a DeviceMesh, not a group")
        return mesh_or_group, ()
    return (mesh_or_group.get_group("model"),
            tuple(mesh_or_group.get_group(a) for a in bp_axes))


def moe_mlp_shardmap(x: torch.Tensor, params: Dict[str, torch.Tensor],
                     moe: MoEConfig, mesh_or_group,
                     bp_axes: Sequence[str] = ()) -> torch.Tensor:
    """Explicit expert parallelism, the JAX package's ``shard_map`` path.

    x: (B, S, d), the whole batch, the same on every rank; params as for
    :func:`moe_mlp`, whole (expert stacks (E_pad, ...)) on every rank.
    Each rank takes the rows its coordinate on ``bp_axes`` names (major
    first) and its ``E_pad / n_model`` experts by its rank in the
    ``model`` group, routes its local tokens to them (the router
    replicated): a running count by local expert over the local batch's
    ``t = B_l * S`` tokens, flattened (not per row, as :func:`moe_mlp`
    counts), the capacity ``max(k, round(t*k/E * cf))``, drops at or past
    it, the (E_loc, C, d) buffer, the SwiGLU experts, a float32 combine of
    the partial token outputs and a SUM over ``model``.  The shared
    experts and their gate run on the local rows as on the dense path;
    the rows are gathered over ``bp_axes`` and the whole (B, S, d) is
    returned on every rank.  ``mesh_or_group``: a ``DeviceMesh`` with a
    ``model`` axis, or the ``model`` group itself (no batch axes).
    """
    model, bp = _moe_groups(mesh_or_group, bp_axes)
    e_pad = params["w_router"].shape[1]
    n_model = dist.get_world_size(model)
    if e_pad % n_model:
        raise ValueError(f"{e_pad} experts do not split over {n_model} "
                         f"model ranks")
    e_loc = e_pad // n_model
    rank = dist.get_rank(model)
    k = moe.top_k

    b, s, d = x.shape
    n_bp, row = 1, 0
    for g in bp:
        n_bp *= dist.get_world_size(g)
        row = row * dist.get_world_size(g) + dist.get_rank(g)
    if b % n_bp:
        raise ValueError(f"a batch of {b} does not split over {n_bp} ranks")
    b_l = b // n_bp
    x_l = x[row * b_l:(row + 1) * b_l]
    t = b_l * s
    xt = x_l.reshape(t, d)
    weights, experts = router_topk(x_l, params["w_router"], moe)
    flat_e = experts.reshape(t * k)
    flat_w = weights.reshape(t * k)
    flat_t = torch.arange(t, device=x.device).repeat_interleave(k)

    local_e = flat_e - rank * e_loc
    mine = (local_e >= 0) & (local_e < e_loc)
    local_e_c = torch.where(mine, local_e, 0)
    # position within each local expert: exclusive running count
    oh = F.one_hot(local_e_c, e_loc) * mine[:, None]
    pos_all = torch.cumsum(oh, dim=0) - oh
    pos = torch.gather(pos_all, 1, local_e_c[:, None])[:, 0]
    capacity = int(max(k, round(t * k / moe.n_experts
                                * moe.capacity_factor)))
    keep = mine & (pos < capacity)

    # the (E_loc, C, d) buffer and a spare slot for the dropped entries
    gathered = torch.where(keep[:, None], xt[flat_t], 0).to(x.dtype)
    buf = torch.zeros((e_loc, capacity + 1, d), dtype=x.dtype,
                      device=x.device)
    buf[local_e_c, torch.where(keep, pos, capacity)] = gathered
    buf = buf[:, :capacity]

    lo = slice(rank * e_loc, (rank + 1) * e_loc)
    g = torch.bmm(buf, params["wg"][lo])
    u = torch.bmm(buf, params["wu"][lo])
    h = (_silu(g) * u).to(x.dtype)
    out_buf = torch.bmm(h, params["wd"][lo])

    part = out_buf[local_e_c, torch.where(keep, pos, 0)]
    part = part.float() * (flat_w * keep)[:, None]
    # each token's k entries added in order from a zero float32 sum
    part = part.reshape(t, k, d)
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        y = y + part[:, j]
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=model)
    y = y.reshape(b_l, s, d).to(x.dtype)

    # shared experts stay on the dense path (replicated weights)
    if moe.n_shared and "sg" in params:
        shared = mlp_swiglu(x_l, params["sg"], params["su"], params["sd"])
        z = torch.matmul(x_l.float(), params["shared_gate"].float())
        gate = 1 / (1 + torch.exp(-z))
        y = y + (shared.float() * gate[..., None]).to(y.dtype)

    # the whole batch on every rank: gather the rows, minor axis first
    for g in reversed(bp):
        parts = [torch.empty_like(y) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, y.contiguous(), group=g)
        y = torch.cat(parts)
    return y
