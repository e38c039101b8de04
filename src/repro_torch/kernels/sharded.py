"""The flash-attention (K6) and selective-scan (K7) wrappers on
``DTensor``s and on meta tensors.

On ``DTensor`` operands the kernels (and the Mamba mixer's causal conv,
:func:`conv_dtensor`) run once a rank on the local shards, through
``torch.distributed.tensor.experimental.local_map``: the operands are
first redistributed to the one layout the kernel can compute in
pieces, every dim but the batch and the heads (K6) or the batch and the
channels (K7) replicated, so a sharded sequence is gathered (that
all-gather is what a dispatch-mode counter sees), and the local call goes
to the wrapper on the local tensors' own device (the kernel on the card,
its plain version on the CPU, the cost op below on meta).  When K6's
query heads are sharded and its kv heads do not divide over the same
ranks, each kv head is repeated for its query group first, so every rank
holds the kv heads its query heads read.

On meta tensors (the dry run: shapes, no values) each kernel is one
custom op, ``repro_torch::flash_attention_cost`` and
``repro_torch::mamba_scan_cost``, whose result has the kernel's output
shapes and dtypes; a counter charges it the function's own operations
and bytes (:func:`attention_cost`, :func:`scan_cost`), the formulas
``chip_smoke.py`` bounds the kernels by, not the plain version's loop.
Under autograd their backward (on the card: the plain version
recomputed and differentiated) is one op too, charged the products and
the intermediates of that plain backward (:func:`attention_backward_cost`,
:func:`scan_backward_cost`): walking the plain loop op by op on meta
tensors would take minutes a step at the dry run's shapes.  The ops
have no kernel for any other device, so a tensor on the card or the CPU
never reaches them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["as_dtensor", "attention_cost", "attention_dtensor",
           "batch_only", "blockwise_dtensor", "constrain", "conv_dtensor",
           "divisible", "is_dtensor", "replicated", "scan_cost",
           "scan_dtensor"]


def is_dtensor(*tensors) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in tensors)


class _Constrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, placements):
        ctx.placements = placements
        return t.redistribute(t.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def constrain(t, placements):
    """A ``DTensor`` redistributed to ``placements``, and its gradient
    too, as ``jax.lax.with_sharding_constraint`` constrains a value and
    its cotangent alike.  A plain ``redistribute`` leaves the gradient as
    the redistribution's backward makes it: a partial sum where the
    forward summed one (``DTensor`` then multiplies it against gathered
    weights), or a shard a later view cannot split."""
    return _Constrain.apply(t, tuple(placements))


def divisible(t, dim: int, size: int):
    """``t``, or for a ``DTensor`` whose ``dim`` is sharded over ranks
    that do not divide ``size`` (the heads a reshape will split it into),
    ``t`` gathered on that dim."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    dim %= t.ndim
    pl = t.placements
    if size % _ranks(t.device_mesh, pl, dim) == 0:
        return t
    return t.redistribute(t.device_mesh, tuple(
        Replicate() if getattr(p, "dim", None) == dim else p for p in pl))


def _kept(placements, dims):
    """``placements`` with ``Shard(d)`` kept for ``d`` in ``dims``, every
    other placement (a shard of another dim, a partial sum) replaced by
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if isinstance(p, Shard) and p.dim in dims else Replicate()
                 for p in placements)


def _ranks(mesh, placements, dim: int) -> int:
    return math.prod(mesh.size(i) for i, p in enumerate(placements)
                     if getattr(p, "dim", None) == dim)


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def batch_only(placements) -> tuple:
    """``placements`` with only the shards of dim 0 kept."""
    return _kept(placements, (0,))


def as_dtensor(t, mesh):
    """``t`` as a ``DTensor`` on ``mesh``: a plain tensor (the same on
    every rank) replicated."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, replicated(mesh), run_check=False)


def _heads_layout(q, k, v, hdim: int):
    """q, k, v redistributed for a per-rank attention whose heads are dim
    ``hdim``: q keeps its batch and head shards (heads gathered when they
    do not divide over their ranks), k and v take q's placements, their
    heads first repeated for their query group when Hkv does not divide
    over q's head ranks.  Returns (q, k, v, placements)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    q, k, v = (as_dtensor(t, mesh) for t in (q, k, v))
    hq, hkv = q.shape[hdim], k.shape[hdim]
    qp = _kept(q.placements, (0, hdim))
    if hq % _ranks(mesh, qp, hdim):
        qp = _kept(qp, (0,))
    if hkv % _ranks(mesh, qp, hdim):
        group = hq // hkv
        batch = _kept(qp, (0,))
        expand = local_map(lambda t: t.repeat_interleave(group, dim=hdim),
                           out_placements=list(batch), in_placements=(batch,),
                           device_mesh=mesh)
        k, v = (expand(t.redistribute(mesh, batch)) for t in (k, v))
    q, k, v = (t.redistribute(mesh, qp) for t in (q, k, v))
    return q, k, v, qp


def attention_dtensor(fn, q, k, v):
    """``fn(q_local, k_local, v_local)`` on every rank, for q (B, Hq, S,
    D) and k, v (B, Hkv, S, D) on one mesh (``DTensor``s, a plain tensor
    replicated): q keeps the shards of its batch and head dims, k and v
    take q's placements (their heads repeated for their query group first
    when Hkv does not divide over the head ranks), everything else is
    gathered.  The result is a ``DTensor`` (B, Hq, S, D) placed as q was
    redistributed."""
    from torch.distributed.tensor.experimental import local_map
    q, k, v, qp = _heads_layout(q, k, v, 1)
    return local_map(fn, out_placements=list(qp), in_placements=(qp, qp, qp),
                     device_mesh=q.device_mesh)(q, k, v)


def blockwise_dtensor(fn, q, k, v, q_pos, kv_pos):
    """``fn(q_l, k_l, v_l, q_pos_l, kv_pos_l)`` on every rank, for q (B,
    Sq, Hq, D), k, v (B, Skv, Hkv, D) and the positions (B, Sq), (B, Skv),
    laid out as :func:`attention_dtensor` lays out its operands (heads on
    dim 2), the positions on the batch shards only."""
    from torch.distributed.tensor.experimental import local_map
    mesh = next(t for t in (q, k, v) if is_dtensor(t)).device_mesh
    q = as_dtensor(q, mesh)
    q, k, v, qp = _heads_layout(q, k, v, 2)
    pp = _kept(qp, (0,))
    q_pos, kv_pos = (as_dtensor(t, mesh).redistribute(mesh, pp)
                     for t in (q_pos, kv_pos))
    return local_map(fn, out_placements=list(qp),
                     in_placements=(qp, qp, qp, pp, pp),
                     device_mesh=mesh)(q, k, v, q_pos, kv_pos)


def scan_dtensor(fn, a, bx, c, h0, return_state: bool):
    """``fn(a_l, bx_l, c_l, h0_l)`` on every rank, for ``DTensor``s a, bx
    (B, S, D, N), c (B, S, N) and h0 (B, D, N) or None on one mesh: a and
    bx keep the shards of their batch and channel dims, c its batch's, h0
    the same as a's, everything else is gathered.  Returns y (B, S, D)
    and, with ``return_state``, h (B, D, N), placed as a and h0."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = a.device_mesh
    ap = _kept(a.placements, (0, 2))
    cp = _kept(ap, (0,))
    hp = tuple(Shard(1) if p == Shard(2) else p for p in ap)
    # c's gradient: each channel shard's part, summed over them
    cg = tuple(Partial() if p == Shard(2) else q for p, q in zip(ap, cp))
    a, bx = (t.redistribute(mesh, ap) for t in (a, bx))
    c = c.redistribute(mesh, cp)
    # a list is one output's placements, a tuple one entry an output
    out = (ap, hp) if return_state else list(ap)
    if h0 is None:
        return local_map(lambda a_, b_, c_: fn(a_, b_, c_, None),
                         out_placements=out, in_placements=(ap, ap, cp),
                         in_grad_placements=(ap, ap, cg),
                         device_mesh=mesh)(a, bx, c)
    return local_map(fn, out_placements=out, in_placements=(ap, ap, cp, hp),
                     in_grad_placements=(ap, ap, cg, hp),
                     device_mesh=mesh)(a, bx, c, h0.redistribute(mesh, hp))


def conv_dtensor(fn, xi, conv_w, prev):
    """``fn(xi_l, conv_w_l, prev_l)`` on every rank, for the Mamba
    mixer's depthwise causal conv: xi (B, S, di) and prev (B, K-1, di) or
    None keep the shards of their batch and channel dims and take
    conv_w's channel shards on the mesh dims where they have none (a
    local slice where they are replicated), conv_w (K, di) takes their
    channel shards, everything else is gathered, so the padding and the
    taps see whole sequences of local tensors (torch 2.11's
    redistribution planner fails on ``F.pad`` of a ``DTensor``).  ``fn``
    returns the tap sum (B, S, di) and the window it leaves (B, K-1, di),
    placed as xi; conv_w's gradient is a partial sum over the batch
    shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(t for t in (xi, conv_w, prev) if is_dtensor(t)).device_mesh
    xi, conv_w = as_dtensor(xi, mesh), as_dtensor(conv_w, mesh)
    xp = _kept(xi.placements, (0, 2))
    xw = tuple(Shard(2) if p == Replicate() and q == Shard(1) else p
               for p, q in zip(xp, conv_w.placements))
    if xi.shape[2] % _ranks(mesh, xw, 2) == 0:
        xp = xw
    wp = tuple(Shard(1) if p == Shard(2) else Replicate() for p in xp)
    # conv_w's gradient: each batch shard's part, summed over them
    wg = tuple(Partial() if p == Shard(0) else q for p, q in zip(xp, wp))
    xi, conv_w = xi.redistribute(mesh, xp), conv_w.redistribute(mesh, wp)
    out = (xp, xp)
    if prev is None:
        return local_map(lambda x_, w_: fn(x_, w_, None), out_placements=out,
                         in_placements=(xp, wp), in_grad_placements=(xp, wg),
                         device_mesh=mesh)(xi, conv_w)
    prev = as_dtensor(prev, mesh).redistribute(mesh, xp)
    return local_map(fn, out_placements=out, in_placements=(xp, wp, xp),
                     in_grad_placements=(xp, wg, xp),
                     device_mesh=mesh)(xi, conv_w, prev)


# ---------------------------------------------------------------------------
# the kernels on meta tensors: one op each, charged the function's own work
# ---------------------------------------------------------------------------

def _meta_only(*_args):
    raise RuntimeError("a kernel's cost op takes meta tensors only")


# Each op's only implementation is its fake (shape) one, which PyTorch
# also runs for meta tensors; on any device with values it raises.
@torch.library.custom_op("repro_torch::flash_attention_cost", mutates_args=())
def _attention_cost_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int) -> torch.Tensor:
    _meta_only()


@_attention_cost_op.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::mamba_scan_cost", mutates_args=())
def _scan_cost_op(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                  h0: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    _meta_only()


@_scan_cost_op.register_fake
def _(a, bx, c, h0):
    b, s, d, n = a.shape
    return (a.new_empty((b, s, d), dtype=torch.float32),
            a.new_empty((b, d, n), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_backward_cost",
                         mutates_args=())
def _attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      g: torch.Tensor, causal: bool, window: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _meta_only()


@_attention_bwd_op.register_fake
def _(q, k, v, g, causal, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@torch.library.custom_op("repro_torch::mamba_scan_backward_cost",
                         mutates_args=())
def _scan_bwd_op(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                 h0: Optional[torch.Tensor], gy: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    _meta_only()


@_scan_bwd_op.register_fake
def _(a, bx, c, h0, gy):
    h = torch.empty_like(h0) if h0 is not None else a.new_empty(
        (a.shape[0], a.shape[2], a.shape[3]), dtype=torch.float32)
    return torch.empty_like(a), torch.empty_like(bx), torch.empty_like(c), h


def attention_backward_meta(q, k, v, g, causal: bool, window: int):
    return torch.ops.repro_torch.flash_attention_backward_cost(
        q, k, v, g, causal, int(window))


def scan_backward_meta(a, bx, c, h0, gy):
    """(da, dbx, dc, dh0) of the scan on meta tensors (dh0 None without
    h0)."""
    out = torch.ops.repro_torch.mamba_scan_backward_cost(a, bx, c, h0, gy)
    return out[:3] + ((out[3],) if h0 is not None else (None,))


def attention_meta(q, k, v, causal: bool, window: int) -> torch.Tensor:
    return torch.ops.repro_torch.flash_attention_cost(q, k, v, causal,
                                                      int(window))


def scan_meta(a, bx, c, h0, return_state: bool):
    y, h = torch.ops.repro_torch.mamba_scan_cost(a, bx, c, h0)
    return (y, h) if return_state else y


def _pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs inside the causal and window masks of one
    head."""
    if not causal:
        if not window:
            return s * s
        # keys k > q - window, any k below s
        return sum(s - max(0, i - window + 1) for i in range(s))
    w = window or s
    if w >= s:
        return s * (s + 1) // 2
    return w * (w + 1) // 2 + (s - w) * w


def _plain_pairs(s: int, causal: bool, window: int, bk: int = 128) -> int:
    """(query, key) pairs of the blocks the plain version computes: each
    kv block of ``bk`` keys against the query rows it can reach."""
    n = 0
    for j0 in range(0, s, bk):
        j1 = min(j0 + bk, s)
        r0 = j0 if causal else 0
        r1 = min(s, j1 - 1 + window) if window > 0 else s
        n += max(0, r1 - r0) * (j1 - j0)
    return n


def attention_backward_cost(q, k, v, g, causal: bool,
                            window: int) -> Tuple[int, int]:
    """(operations, bytes) of K6's backward, the plain version recomputed
    and differentiated over its blocks: its two products forward and
    four backward, 2·D a pair each, for every query head; q, k, v and the
    output gradient read, their gradients written, and the float32 score,
    probability and their gradients (4 a pair) written and read once."""
    b, hq, s, d = q.shape
    pairs = b * hq * _plain_pairs(s, causal, window)
    ops = 12 * d * pairs
    io = sum(t.numel() * t.element_size() for t in (q, k, v, g))
    return ops, 2 * io + 2 * 4 * 4 * pairs


def scan_backward_cost(a, bx, c, h0, gy) -> Tuple[int, int]:
    """(operations, bytes) of K7's backward, the plain scan recomputed
    and differentiated step by step: 4 a state a step forward and 8
    backward; the operands and the output gradient read, their gradients
    written, and each step's float32 state saved and read back."""
    b, s, d, n = a.shape
    ops = 12 * a.numel()
    io = sum(t.numel() * t.element_size() for t in (a, bx, c, h0, gy)
             if t is not None)
    return ops, 2 * io + 2 * 4 * a.numel()


def attention_cost(q, k, v, causal: bool, window: int) -> Tuple[int, int]:
    """(operations, bytes) of K6's function: 4·D a (query, key) pair
    inside the masks (the two products' multiply-adds) for every query
    head, and q, k, v read once and the output written once."""
    b, hq, s, d = q.shape
    ops = 4 * d * hq * b * _pairs(s, causal, window)
    byts = sum(t.numel() * t.element_size() for t in (q, k, v)) \
        + q.numel() * q.element_size()
    return ops, byts


def scan_cost(a, bx, c, h0) -> Tuple[int, int]:
    """(operations, bytes) of K7's function: 4 a state a step (a·h, + bx,
    ·c, + into y), and a, bx, c, h0 read once, y and the last state
    written once."""
    b, s, d, n = a.shape
    ops = 4 * a.numel()
    byts = sum(t.numel() * t.element_size() for t in (a, bx, c, h0)
               if t is not None) + 4 * (b * s * d + b * d * n)
    return ops, byts
