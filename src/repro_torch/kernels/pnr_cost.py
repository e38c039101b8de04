"""Half-perimeter wirelength (HPWL) cost functions and the placement kernels.

The annealing placer in :mod:`repro_torch.fabric.place` scores candidate
placements by total HPWL over all nets.  Nets are lowered once to a padded
pin matrix (``net_pins``: net x pin -> entity index, ``net_mask`` marking
real pins); a placement is then a gather + masked min/max reduction.

Plain PyTorch functions (the semantics every kernel is held to):

* :func:`net_hpwl` / :func:`hpwl` — per-net / total HPWL of one placement;
* :func:`hpwl_delta` — rescore only the nets a swap touches;
* :func:`net_hpwl_fixed` / :func:`hpwl_fixed` / :func:`hpwl_delta_fixed`
  — the same with per-net fixed boxes folded in (``net_fix``: xmin, xmax,
  ymin, ymax over a net's external pins, in the sub-problem's frame; the
  hierarchical placer's cluster-local problems), :data:`EMPTY_BOX` the
  "no external pins" sentinel, a bit-exact no-op;
* :func:`net_hpwl_rows_plain` — per-net HPWL of a batch of placements
  (what the reference's Pallas ``_hpwl_kernel`` computes);
* :func:`hpwl_reference` — pure-Python oracle.

Kernel (CUDA C++ for sm_90a, ``csrc/pnr_anneal.cu``), with a plain version
beside it that the wrapper runs for CPU tensors:

* :func:`anneal_chains` (K2) — whole annealing sweeps with the delta
  rescoring of the reference's Pallas ``_hpwl_delta_kernel`` fused in,
  replacing the ``fori_loop`` of ``_build_batch_annealer`` /
  ``_build_annealer``.  Its prologue scores every chain's start: the
  per-net HPWL of the Pallas ``_hpwl_kernel`` (``hpwl_pallas``), which
  therefore has no launch of its own.

The reference's kernel entry points, each with its ``device`` (the card
by default, ``"cpu"`` for the plain version):

* :func:`hpwl_pallas` / :func:`hpwl_batched` — the total HPWL of one /
  of C placements of a problem, one zero-step launch of K2 whose
  prologue scores them (the C placements as its chains, each with its
  own slot coordinates);
* :func:`hpwl_delta_pallas` — one swap scored over a list of nets, one
  launch of ``swap_delta_kernel`` (same source): a warp rescoring each
  net with K2's row cost.

Each wrapper counts its launches in ``<function>.launches``.  For a
CUDA tensor it launches its kernel or raises; it never falls back to the
plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["hpwl_reference", "net_hpwl_from_xy", "net_hpwl", "hpwl",
           "hpwl_delta", "EMPTY_BOX", "fixed_box", "net_hpwl_fixed_from_xy",
           "net_hpwl_fixed", "hpwl_fixed", "hpwl_delta_fixed",
           "net_hpwl_rows_plain", "anneal_chains", "anneal_chains_plain",
           "anneal_layout", "pin_table", "CURVE_POINTS", "hpwl_pallas",
           "hpwl_batched", "hpwl_delta_pallas", "hpwl_delta_pallas_plain"]

_BIG = 1e9

#: cost-curve snapshot points captured per chain when telemetry is on
CURVE_POINTS = 16

_SOURCE = "pnr_anneal.cu"
#: 2K: K2 keeps at most two touched nets a lane (one when 2K <= 32); above
#: it the wrapper asks for full scoring
_MAX_TOUCHED = 64
#: shared memory a block may use on Hopper (232,448 bytes)
SMEM_LIMIT = 227 * 1024


def hpwl_reference(pos: np.ndarray, net_pins: np.ndarray,
                   net_mask: np.ndarray) -> float:
    """Pure-Python/NumPy oracle.  pos: (E, 2); net_pins/net_mask: (N, D)."""
    total = 0.0
    for i in range(net_pins.shape[0]):
        xs, ys = [], []
        for j in range(net_pins.shape[1]):
            if net_mask[i, j]:
                e = int(net_pins[i, j])
                xs.append(float(pos[e, 0]))
                ys.append(float(pos[e, 1]))
        if xs:
            total += (max(xs) - min(xs)) + (max(ys) - min(ys))
    return total


def net_hpwl_from_xy(xy: torch.Tensor, net_mask: torch.Tensor
                     ) -> torch.Tensor:
    """Per-net HPWL from already-gathered pin coordinates.
    xy: (..., N, D, 2) float; net_mask: (..., N, D) bool.  Returns (..., N)."""
    x, y = xy[..., 0], xy[..., 1]
    big = torch.tensor(_BIG, dtype=xy.dtype, device=xy.device)
    xmin = torch.where(net_mask, x, big).amin(dim=-1)
    xmax = torch.where(net_mask, x, -big).amax(dim=-1)
    ymin = torch.where(net_mask, y, big).amin(dim=-1)
    ymax = torch.where(net_mask, y, -big).amax(dim=-1)
    valid = net_mask.any(dim=-1)
    return torch.where(valid, (xmax - xmin) + (ymax - ymin),
                       torch.zeros((), dtype=xy.dtype, device=xy.device))


def net_hpwl(pos: torch.Tensor, net_pins: torch.Tensor,
             net_mask: torch.Tensor) -> torch.Tensor:
    """Per-net HPWL.  pos: (E, 2) float; net_pins: (N, D) int (pad entries
    may hold any valid index); net_mask: (N, D) bool.  Returns (N,)."""
    return net_hpwl_from_xy(pos[net_pins.long()], net_mask)


def hpwl(pos: torch.Tensor, net_pins: torch.Tensor,
         net_mask: torch.Tensor) -> torch.Tensor:
    """Total HPWL of one placement (scalar)."""
    return net_hpwl(pos, net_pins, net_mask).sum()


def _touched_view(net_pins, net_mask, per_net_cost, touched):
    """(pins, mask, old) restricted to the touched nets; ``touched``
    entries >= N (unused / duplicate) come back fully masked, old 0."""
    n = net_pins.shape[0]
    valid = touched < n
    tc = torch.clamp(touched, max=n - 1).long()
    pins = net_pins[tc]
    mask = net_mask[tc] & valid[:, None]
    old = torch.where(valid, per_net_cost[tc],
                      torch.zeros((), dtype=per_net_cost.dtype,
                                  device=per_net_cost.device))
    return pins, mask, old


def hpwl_delta(slot_xy: torch.Tensor, cand_slot_of: torch.Tensor,
               net_pins: torch.Tensor, net_mask: torch.Tensor,
               per_net_cost: torch.Tensor, touched: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rescore only the ``touched`` nets under a candidate permutation.

    Returns ``(new_vals, delta)``: the candidate HPWL of each touched net
    (0 for padding) and the scalar move cost change.
    """
    pins, mask, old = _touched_view(net_pins, net_mask, per_net_cost,
                                    touched)
    xy = slot_xy[cand_slot_of[pins.long()].long()]
    new_vals = net_hpwl_from_xy(xy, mask)
    return new_vals, (new_vals - old).sum()


# ---------------------------------------------------------------------------
# Fixed-terminal variants: per-net fixed bounding boxes folded into the
# reduction (cluster-local frames for the hierarchical placer)
# ---------------------------------------------------------------------------

#: per-net "no external pins" box: [xmin, xmax, ymin, ymax] with min > max,
#: the identity of the fold below — min(x, 1e9) == x and max(x, -1e9) == x
#: exactly, so a sentinel box is a bit-exact no-op and fixed-box programs
#: agree with the plain ones on box-free nets
EMPTY_BOX = (_BIG, -_BIG, _BIG, -_BIG)


def fixed_box(points) -> np.ndarray:
    """[xmin, xmax, ymin, ymax] float32 over (x, y) pairs; EMPTY_BOX when
    there are none.  Host-side helper for lowering cluster-local nets."""
    pts = np.asarray(list(points), np.float32)
    if pts.size == 0:
        return np.asarray(EMPTY_BOX, np.float32)
    return np.asarray([pts[:, 0].min(), pts[:, 0].max(),
                       pts[:, 1].min(), pts[:, 1].max()], np.float32)


def net_hpwl_fixed_from_xy(xy: torch.Tensor, net_mask: torch.Tensor,
                           net_fix: torch.Tensor) -> torch.Tensor:
    """Per-net HPWL with per-net fixed boxes folded in.
    xy: (..., N, D, 2); net_mask: (..., N, D) bool; net_fix: (..., N, 4).
    Returns (..., N).  A net is scored when it has movable pins or a
    non-empty box."""
    x, y = xy[..., 0], xy[..., 1]
    big = torch.tensor(_BIG, dtype=xy.dtype, device=xy.device)
    xmin = torch.minimum(torch.where(net_mask, x, big).amin(dim=-1),
                         net_fix[..., 0])
    xmax = torch.maximum(torch.where(net_mask, x, -big).amax(dim=-1),
                         net_fix[..., 1])
    ymin = torch.minimum(torch.where(net_mask, y, big).amin(dim=-1),
                         net_fix[..., 2])
    ymax = torch.maximum(torch.where(net_mask, y, -big).amax(dim=-1),
                         net_fix[..., 3])
    valid = net_mask.any(dim=-1) | (net_fix[..., 0] <= net_fix[..., 1])
    return torch.where(valid, (xmax - xmin) + (ymax - ymin),
                       torch.zeros((), dtype=xy.dtype, device=xy.device))


def net_hpwl_fixed(pos: torch.Tensor, net_pins: torch.Tensor,
                   net_mask: torch.Tensor, net_fix: torch.Tensor
                   ) -> torch.Tensor:
    """Per-net HPWL under fixed boxes.  Same contract as :func:`net_hpwl`
    plus ``net_fix`` (N, 4)."""
    return net_hpwl_fixed_from_xy(pos[net_pins.long()], net_mask, net_fix)


def hpwl_fixed(pos: torch.Tensor, net_pins: torch.Tensor,
               net_mask: torch.Tensor, net_fix: torch.Tensor) -> torch.Tensor:
    """Total HPWL of one placement with fixed terminals (scalar)."""
    return net_hpwl_fixed(pos, net_pins, net_mask, net_fix).sum()


def _touched_fix(net_fix: torch.Tensor, touched: torch.Tensor
                 ) -> torch.Tensor:
    """The touched nets' boxes; pad and duplicate entries (>= N) get
    EMPTY_BOX, not the box of net N - 1 that their clamped gather reads."""
    n = net_fix.shape[-2]
    tc = torch.clamp(touched, max=n - 1).long()
    fix = torch.gather(net_fix, -2, tc[..., None].expand(*tc.shape, 4))
    empty = torch.tensor(EMPTY_BOX, dtype=net_fix.dtype,
                         device=net_fix.device)
    return torch.where((touched < n)[..., None], fix, empty)


def hpwl_delta_fixed(slot_xy: torch.Tensor, cand_slot_of: torch.Tensor,
                     net_pins: torch.Tensor, net_mask: torch.Tensor,
                     per_net_cost: torch.Tensor, touched: torch.Tensor,
                     net_fix: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rescore the ``touched`` nets under fixed boxes — the incremental
    counterpart of :func:`hpwl_delta`, same contract plus ``net_fix``."""
    pins, mask, old = _touched_view(net_pins, net_mask, per_net_cost,
                                    touched)
    xy = slot_xy[cand_slot_of[pins.long()].long()]
    new_vals = net_hpwl_fixed_from_xy(xy, mask,
                                      _touched_fix(net_fix, touched))
    return new_vals, (new_vals - old).sum()


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------
def _lib():
    from .build import load
    lib = load(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pnr_anneal.argtypes = [i] * 10 + [p] * 18
        lib.pnr_anneal.restype = i
        lib.pnr_swap_delta.argtypes = [i] * 3 + [p] * 9
        lib.pnr_swap_delta.restype = i
        lib.pnr_anneal_smem_bytes.argtypes = [i] * 7
        lib.pnr_anneal_smem_bytes.restype = ctypes.c_longlong
        lib.pnr_error_string.argtypes = [i]
        lib.pnr_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_rc(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {rc} "
                           f"({lib.pnr_error_string(rc).decode()})")


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(x: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if x is None else x.data_ptr())


# ---------------------------------------------------------------------------
# per-net HPWL of a batch of placements (K1's function, K2's prologue)
# ---------------------------------------------------------------------------
def net_hpwl_rows_plain(prob: torch.Tensor, slot_of: torch.Tensor,
                        slot_xy: torch.Tensor, net_pins: torch.Tensor,
                        net_mask: torch.Tensor,
                        net_fix: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``out[r] = net_hpwl(slot_xy[p][slot_of[r]], net_pins[p],
    net_mask[p])`` with ``p = prob[r]`` (:func:`net_hpwl_fixed` with
    ``net_fix[p]`` when boxes are given): the reference's Pallas
    ``_hpwl_kernel`` over R placements, each over its own problem.

    prob: (R,) int32; slot_of: (R, E) int32 entity -> slot; slot_xy: (P,
    E, 2) float32; net_pins: (P, N, D) int32; net_mask: (P, N, D) bool;
    net_fix: (P, N, 4) float32 or None.  Returns (R, N) float32.  K2
    computes this in its prologue (``pnc0_out`` of :func:`anneal_chains`).
    """
    p = prob.long()
    pins = net_pins[p].long()                                 # (R, N, D)
    slots = torch.gather(slot_of.long(), 1,
                         pins.flatten(1)).view(pins.shape)    # (R, N, D)
    xy = slot_xy[p[:, None, None], slots]                     # (R, N, D, 2)
    if net_fix is None:
        return net_hpwl_from_xy(xy, net_mask[p])
    return net_hpwl_fixed_from_xy(xy, net_mask[p], net_fix[p])


# ---------------------------------------------------------------------------
# K2: annealing chains with fused delta rescoring
# ---------------------------------------------------------------------------
AnnealOut = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                  Optional[torch.Tensor]]


def anneal_chains_plain(prob, slot_xy, net_pins, net_mask, ent_nets, temps,
                        active, a, t, log_u, slot0, net_fix=None, *,
                        full: bool = False, telemetry: bool = False,
                        xy_chain: bool = False,
                        pnc0_out: Optional[torch.Tensor] = None,
                        work: Optional[dict] = None) -> AnnealOut:
    """Plain version of K2: every chain's sweep, vectorised over chains
    with a Python loop over steps (the reference ``fori_loop`` body),
    after the starting per-net costs (:func:`net_hpwl_rows_plain`),
    written to ``pnc0_out`` when given.

    ``work``, when given, accumulates what this run's data made the
    kernel do: ``steps`` (chain-steps), ``nets`` (nets rescored) and
    ``pins`` (pins visited) — the operation count of a roofline bound.
    """
    dev = slot0.device
    r_n, e_n = slot0.shape
    if xy_chain:
        # chain r's own slot coordinates: each chain its own problem
        p = prob.long()
        net_pins, net_mask, ent_nets, temps, active = (
            x[p] for x in (net_pins, net_mask, ent_nets, temps, active))
        net_fix = None if net_fix is None else net_fix[p]
        prob = torch.arange(r_n, dtype=torch.int32, device=dev)
    n_n = net_pins.shape[1]
    s_n = a.shape[1]
    k_n = ent_nets.shape[2]
    rows = torch.arange(r_n, device=dev)
    p = prob.long()
    pins_r = net_pins[p].long()                               # (R, N, D)
    mask_r = net_mask[p]
    fix_r = None if net_fix is None else net_fix[p]           # (R, N, 4)
    xy_r = slot_xy[p]                                         # (R, E, 2)
    en_r = ent_nets[p].long()                                 # (R, E, K)
    temps_r = temps[p]
    active_r = active[p]
    pnc0 = net_hpwl_rows_plain(prob, slot0, slot_xy, net_pins, net_mask,
                               net_fix)
    if pnc0_out is not None:
        pnc0_out.copy_(pnc0)
    slot_of = slot0.long().clone()
    occ = torch.empty_like(slot_of)
    occ.scatter_(1, slot_of, torch.arange(e_n, device=dev).expand(r_n, e_n))
    # one spare column takes the dropped scatters of padding entries
    pnc = torch.cat([pnc0, torch.zeros((r_n, 1), dtype=pnc0.dtype,
                                       device=dev)], dim=1)
    cur = pnc0.sum(dim=1)
    best = cur.clone()
    best_slot = slot_of.clone()
    n_acc = torch.zeros(r_n, dtype=torch.int32, device=dev)
    curve = torch.zeros((r_n, CURVE_POINTS), dtype=torch.float32,
                        device=dev)
    dup_tri = torch.tril(torch.ones((2 * k_n, 2 * k_n), dtype=torch.bool,
                                    device=dev), diagonal=-1)

    def swapped_xy(pins, ai, bi, sa, sb):
        s = torch.gather(slot_of, 1, pins.flatten(1)).view(pins.shape)
        sel = (slice(None),) + (None,) * (pins.dim() - 1)
        s = torch.where(pins == ai[sel], sb[sel],
                        torch.where(pins == bi[sel], sa[sel], s))
        return torch.gather(xy_r, 1, s.flatten(1)[..., None].expand(
            -1, -1, 2)).view(*pins.shape, 2)

    def score(xy, mask, fix):
        if fix is None:
            return net_hpwl_from_xy(xy, mask)
        return net_hpwl_fixed_from_xy(xy, mask, fix)

    for i in range(s_n):
        ai = a[:, i].long()
        ti = t[:, i].long()
        bi = occ[rows, ti]
        sa = slot_of[rows, ai]
        sb = slot_of[rows, bi]
        if full:
            new = score(swapped_xy(pins_r, ai, bi, sa, sb), mask_r,
                        fix_r).sum(dim=1)
            if work is not None:
                work["nets"] = work.get("nets", 0) + r_n * n_n
                work["pins"] = work.get("pins", 0) + int(mask_r.sum())
        else:
            tn = torch.cat([en_r[rows, ai], en_r[rows, bi]], dim=1)
            dup = ((tn[:, :, None] == tn[:, None, :]) & dup_tri).any(dim=2)
            tn = torch.where(dup, n_n, tn)
            valid = tn < n_n
            tc = torch.clamp(tn, max=n_n - 1)
            pins = torch.gather(pins_r, 1, tc[..., None].expand(
                -1, -1, pins_r.shape[2]))
            mask = torch.gather(mask_r, 1, tc[..., None].expand(
                -1, -1, mask_r.shape[2])) & valid[..., None]
            fix = None if fix_r is None else _touched_fix(fix_r, tn)
            new_vals = score(swapped_xy(pins, ai, bi, sa, sb), mask, fix)
            old = torch.where(valid, torch.gather(pnc, 1, tc),
                              torch.zeros((), device=dev))
            new = cur + (new_vals - old).sum(dim=1)
            if work is not None:
                work["nets"] = work.get("nets", 0) + int(valid.sum())
                work["pins"] = work.get("pins", 0) + int(mask.sum())
        if work is not None:
            work["steps"] = work.get("steps", 0) + r_n
        accept = (((new <= cur) | (log_u[:, i] * temps_r[:, i] < cur - new))
                  & active_r[:, i])
        if not full:
            dst = torch.where(valid & accept[:, None], tn, n_n)
            pnc.scatter_(1, dst, torch.where(dst < n_n, new_vals,
                                             torch.zeros((), device=dev)))
            pnc[:, n_n] = 0.0
        # the swap, written for every row (a rejected row writes back
        # what it holds); a == b writes the same slot twice
        slot_of[rows, ai] = torch.where(accept, sb, slot_of[rows, ai])
        slot_of[rows, bi] = torch.where(accept, sa, slot_of[rows, bi])
        occ[rows, sb] = torch.where(accept, ai, occ[rows, sb])
        occ[rows, sa] = torch.where(accept, bi, occ[rows, sa])
        cur = torch.where(accept, new, cur)
        improved = cur < best
        best = torch.where(improved, cur, best)
        best_slot = torch.where(improved[:, None], slot_of, best_slot)
        if telemetry:
            n_acc += accept.to(torch.int32)
            curve[:, min(i * CURVE_POINTS // s_n, CURVE_POINTS - 1)] = cur
    return (best_slot.to(torch.int32), best,
            n_acc if telemetry else None, curve if telemetry else None)


def pin_table(net_pins: torch.Tensor, net_mask: torch.Tensor
              ) -> torch.Tensor:
    """K2's pin table: (P, N, W) int32, row ``[c, e_1 .. e_c, -1 ...]`` per
    net with its ``c`` masked-in pins in their order (the mask folded
    in), ``W = max(8, D + 1 rounded up to 4)`` so a row is whole 16-byte
    loads and its count and first 7 pins are two of them."""
    p, n, d = net_pins.shape
    w = max(8, (d + 4) // 4 * 4)
    order = torch.sort((~net_mask).to(torch.uint8), dim=-1,
                       stable=True).indices
    cnt = net_mask.sum(dim=-1, dtype=torch.int32)
    pins = torch.gather(net_pins, -1, order)
    real = torch.arange(d, device=net_pins.device) < cnt[..., None]
    tab = torch.full((p, n, w), -1, dtype=torch.int32,
                     device=net_pins.device)
    tab[..., 0] = cnt
    tab[..., 1:d + 1] = torch.where(real, pins, -1)
    return tab


def anneal_layout(n: int, d: int, e: int, k: int, fix: bool = False
                  ) -> Tuple[int, bool, bool, int]:
    """K2's launch layout for a problem of N nets, D pins a net, E entities
    and K nets an entity (with a fixed box a net when ``fix``): ``(W,
    stage, chain, smem)`` — the pin table's row width, whether the
    problem's tables are staged in shared memory, whether each chain's
    state (slots, occupants and per-net costs, ``(2E + N) * 4`` bytes) is,
    and a block's shared-memory bytes (``pnr_anneal_smem_bytes`` in
    ``csrc/pnr_anneal.cu``).

    The tables stay in global memory when they do not fit beside the
    chain's state, and the chain's state goes to a global scratch when it
    alone exceeds :data:`SMEM_LIMIT`.
    """
    w = max(8, (d + 4) // 4 * 4)
    tables = (n * w + (4 * n if fix else 0) + 2 * e + e * k) * 4
    chain = (2 * e + n) * 4
    if chain > SMEM_LIMIT:
        return w, False, False, 0
    stage = tables + chain <= SMEM_LIMIT
    return w, stage, True, (tables if stage else 0) + chain


def _anneal_checks(prob, slot_xy, net_pins, net_mask, ent_nets, temps,
                   active, a, t, log_u, slot0, net_fix, pnc0_out, xy_chain):
    """The kernel's argument checks; returns (R, S, N, D, E, K, P)."""
    dev = slot0.device
    r, e = slot0.shape
    p, n, d = net_pins.shape
    k = ent_nets.shape[2]
    s = a.shape[1]
    checks = [("prob", prob, torch.int32, (r,)),
              ("slot_xy", slot_xy, torch.float32, (r if xy_chain else p, e,
                                                   2)),
              ("net_pins", net_pins, torch.int32, (p, n, d)),
              ("net_mask", net_mask, torch.bool, (p, n, d)),
              ("ent_nets", ent_nets, torch.int32, (p, e, k)),
              ("temps", temps, torch.float32, (p, s)),
              ("active", active, torch.bool, (p, s)),
              ("a", a, torch.int32, (r, s)), ("t", t, torch.int32, (r, s)),
              ("log_u", log_u, torch.float32, (r, s)),
              ("slot0", slot0, torch.int32, (r, e))]
    if net_fix is not None:
        checks.append(("net_fix", net_fix, torch.float32, (p, n, 4)))
    if pnc0_out is not None:
        checks.append(("pnc0_out", pnc0_out, torch.float32, (r, n)))
    for name, x, dt, shape in checks:
        _check(name, x, dt, shape, dev)
    return r, s, n, d, e, k, p


def _anneal_outputs(r, e, dev):
    return (torch.empty((r, e), dtype=torch.int32, device=dev),
            torch.empty((r,), dtype=torch.float32, device=dev),
            torch.zeros((r,), dtype=torch.int32, device=dev),
            torch.zeros((r, CURVE_POINTS), dtype=torch.float32, device=dev))


def anneal_chains(prob, slot_xy, net_pins, net_mask, ent_nets, temps,
                  active, a, t, log_u, slot0, net_fix=None, *,
                  full: bool = False, telemetry: bool = False,
                  xy_chain: bool = False,
                  pnc0_out: Optional[torch.Tensor] = None) -> AnnealOut:
    """Anneal R chains, each over its own problem, for S steps.

    Problem arrays (P problems): slot_xy (P, E, 2) float32, net_pins and
    net_mask (P, N, D) int32/bool, ent_nets (P, E, K) int32 (entries >= N
    are padding), temps (P, S) float32, active (P, S) bool, and, for the
    hierarchical placer's sub-problems, net_fix (P, N, 4) float32 fixed
    boxes (None on the flat path).  Per chain: prob (R,) int32, move
    streams a / t (R, S) int32 and log_u (R, S) float32, and the starting
    slots slot0 (R, E) int32.  With ``xy_chain`` slot_xy is per chain,
    (R, E, 2): R placements of one problem (the zero-step launch of
    :func:`hpwl_batched`).  ``pnc0_out`` (R, N) float32, when given,
    receives each chain's starting per-net costs.

    Each step swaps entity ``a`` with the occupant ``b`` of slot ``t``,
    rescores the nets the swap touches (every net with ``full``), accepts
    when ``new <= cur`` or ``log_u * temp < cur - new`` (and the step is
    active), and tracks the best placement.  Returns ``(best_slot (R, E)
    int32, best (R,) float32, accepts (R,) int32, curve (R, 16) float32)``;
    the last two only with ``telemetry`` (else None).

    Kernel K2 (``anneal_kernel``): a warp a chain for the whole sweep, one
    chain a block with its problem's tables (pin table, fixed boxes,
    ent_nets, slot coordinates) staged in shared memory and its own state
    there too (each in global memory when it does not fit); its prologue
    scores the start (the reference's Pallas ``_hpwl_kernel``, K1), and
    the delta rescoring of the Pallas ``_hpwl_delta_kernel`` is fused into
    each step.  The latency of one step's dependent loads and reductions,
    not bytes, sets its pace (:func:`anneal_layout` gives the launch
    layout).  The kernel keeps at
    most two touched nets a lane: a problem whose entities lie on more
    than 32 nets each (the hierarchical placer's cluster level) is scored
    in full at every step, which accepts the same moves as delta
    scoring, since every cost is exact.
    """
    dev = slot0.device
    if dev.type != "cuda":
        return anneal_chains_plain(prob, slot_xy, net_pins, net_mask,
                                   ent_nets, temps, active, a, t, log_u,
                                   slot0, net_fix, full=full,
                                   telemetry=telemetry, xy_chain=xy_chain,
                                   pnc0_out=pnc0_out)
    r, s, n, d, e, k, p = _anneal_checks(prob, slot_xy, net_pins, net_mask,
                                         ent_nets, temps, active, a, t,
                                         log_u, slot0, net_fix, pnc0_out,
                                         xy_chain)
    fix = net_fix is not None
    full = full or 2 * k > _MAX_TOUCHED
    w, stage, chain, smem = anneal_layout(n, d, e, k, fix)
    lib = _lib()
    if lib.pnr_anneal_smem_bytes(n, w, e, k, int(stage), int(fix),
                                 int(chain)) != smem:
        raise RuntimeError("anneal_layout and csrc/pnr_anneal.cu disagree "
                           "on K2's shared memory")
    tab = pin_table(net_pins, net_mask)
    scratch = None if chain else torch.empty((r, 2 * e + n),
                                             dtype=torch.int32, device=dev)
    best_slot, best, accepts, curve = _anneal_outputs(r, e, dev)
    rc = lib.pnr_anneal(r, s, n, w, e, k, int(stage), int(full),
                        int(telemetry), int(xy_chain), _ptr(prob),
                        _ptr(slot_xy),
                        _ptr(tab),
                        _ptr(ent_nets), _ptr(temps), _ptr(active), _ptr(a),
                        _ptr(t), _ptr(log_u), _ptr(slot0), _ptr(net_fix),
                        _ptr(scratch), _ptr(pnc0_out), _ptr(best_slot),
                        _ptr(best), _ptr(accepts), _ptr(curve), _stream(dev))
    _check_rc(lib, rc, "anneal_kernel")
    anneal_chains.launches += 1
    return (best_slot, best, accepts if telemetry else None,
            curve if telemetry else None)


anneal_chains.launches = 0


# ---------------------------------------------------------------------------
# the JAX package's kernel entry points, on K2
# ---------------------------------------------------------------------------
def _rows_plain(pos: torch.Tensor, net_pins: torch.Tensor,
                net_mask: torch.Tensor):
    """Per-net costs (R, N) and totals (R,) of R placements ``pos`` (R, E,
    2) of one problem: :func:`net_hpwl` a placement."""
    per_net = net_hpwl_from_xy(pos[:, net_pins.long()], net_mask)
    return per_net, per_net.sum(dim=-1)


def _rows_k2(pos: torch.Tensor, net_pins: torch.Tensor,
             net_mask: torch.Tensor):
    """:func:`_rows_plain` as one zero-step launch of K2 (
    :func:`anneal_chains` with ``xy_chain``) on CUDA tensors: R chains of
    one problem, chain r's slot coordinates ``pos[r]``, each entity at its
    own slot; the prologue scores them (K1's function) into ``pnc0_out``
    and the best cost, the start, is their sum."""
    dev = pos.device
    r, e = pos.shape[:2]
    n = net_pins.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    steps = torch.empty((r, 0), **i32)
    pnc0 = torch.empty((r, n), **f32)
    best = anneal_chains(
        torch.zeros((r,), **i32), pos, net_pins[None], net_mask[None],
        torch.full((1, e, 1), n, **i32), torch.empty((1, 0), **f32),
        torch.empty((1, 0), dtype=torch.bool, device=dev), steps, steps,
        torch.empty((r, 0), **f32),
        torch.arange(e, **i32).expand(r, e).contiguous(), xy_chain=True,
        pnc0_out=pnc0)[1]
    return pnc0, best


def _operands(device, *xs):
    dev = resolve_device(device)
    return dev, [torch.as_tensor(x, device=dev) for x in xs]


def _totals(counted, pos, net_pins, net_mask, device) -> torch.Tensor:
    """Totals (C,) of C placements ``pos`` (C, E, 2) of one problem: one
    zero-step K2 launch on the card (counted on ``counted``), the plain
    version on the CPU."""
    dev, (pos, net_pins, net_mask) = _operands(device, pos, net_pins,
                                                net_mask)
    pos = pos.to(torch.float32)
    if dev.type != "cuda":
        return _rows_plain(pos, net_pins, net_mask)[1]
    totals = _rows_k2(pos.contiguous(),
                      net_pins.to(torch.int32).contiguous(),
                      net_mask.to(torch.bool).contiguous())[1]
    counted.launches += 1
    return totals


def hpwl_pallas(pos, net_pins, net_mask, *, interpret: bool = True,
                device="cuda") -> torch.Tensor:
    """Total HPWL of one placement (a 0-dim float32 tensor): the
    reference's Pallas ``_hpwl_kernel`` entry point.  pos (E, 2); net_pins
    / net_mask (N, D) (tensors or arrays, moved to ``device``).

    On the card one zero-step launch of K2 scores the placement in its
    prologue (K1's function; counted in ``hpwl_pallas.launches``); on
    ``device="cpu"`` the plain version.  ``interpret`` is the reference's
    keyword, accepted and ignored: it changes no result."""
    return _totals(hpwl_pallas, torch.as_tensor(pos)[None], net_pins,
                   net_mask, device)[0]


hpwl_pallas.launches = 0


def hpwl_batched(pos, net_pins, net_mask, *, device="cuda") -> torch.Tensor:
    """Total HPWL of each of C placements of one problem (C,) float32: the
    reference's ``hpwl_batched``, vmapped over a leading chain axis.  pos
    (C, E, 2); net_pins / net_mask (N, D).

    On the card one zero-step launch of K2 with the C placements as its
    chains, each with its own slot coordinates (counted in
    ``hpwl_batched.launches``); on ``device="cpu"`` the plain version."""
    return _totals(hpwl_batched, pos, net_pins, net_mask, device)


hpwl_batched.launches = 0


def hpwl_delta_pallas_plain(slot_xy, slot_of, net_pins, net_mask,
                            per_net_cost, touched, ent_a, ent_b):
    """Plain version of :func:`hpwl_delta_pallas`: :func:`hpwl_delta`
    under ``slot_of`` with the two entities' slots exchanged."""
    a, b = torch.as_tensor(ent_a).long(), torch.as_tensor(ent_b).long()
    cand = slot_of.clone()
    cand[a], cand[b] = slot_of[b], slot_of[a]
    return hpwl_delta(slot_xy, cand, net_pins, net_mask, per_net_cost,
                      touched)


def hpwl_delta_pallas(slot_xy, slot_of, net_pins, net_mask, per_net_cost,
                      touched, ent_a, ent_b, *, interpret: bool = True,
                      device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """The swap of entities ``ent_a`` and ``ent_b`` (each to the other's
    slot) scored on the ``touched`` nets, as the reference's Pallas
    ``_hpwl_delta_kernel`` entry point: ``(new_vals (T,), delta)`` as
    :func:`hpwl_delta` returns them for the swapped permutation.
    slot_xy (E, 2) float32; slot_of (E,) entity -> slot; per_net_cost
    (N,); touched (T,) net ids, entries N for padding (a negative id is
    refused on either device).

    On the card one launch of ``swap_delta_kernel`` (``pnr_anneal.cu``): a
    warp rescoring each touched net with K2's ``row_cost`` and summing
    the delta (counted in ``hpwl_delta_pallas.launches``); on
    ``device="cpu"`` the plain version.  ``interpret`` is accepted and
    ignored."""
    dev, (slot_xy, slot_of, net_pins, net_mask, per_net_cost, touched) = \
        _operands(device, slot_xy, slot_of, net_pins, net_mask,
                  per_net_cost, touched)
    ab = torch.stack([torch.as_tensor(x, device=dev).reshape(())
                      for x in (ent_a, ent_b)]).to(torch.int32)
    slot_xy, per_net_cost = (x.to(torch.float32)
                             for x in (slot_xy, per_net_cost))
    if touched.numel() and int(touched.min()) < 0:
        raise ValueError("touched: net ids must be >= 0 (N for padding), "
                         f"got {int(touched.min())}")
    if dev.type != "cuda":
        return hpwl_delta_pallas_plain(slot_xy, slot_of, net_pins, net_mask,
                                       per_net_cost, touched, ab[0], ab[1])
    slot_of, net_pins, touched = (x.to(torch.int32).contiguous()
                                  for x in (slot_of, net_pins, touched))
    slot_xy, per_net_cost = slot_xy.contiguous(), per_net_cost.contiguous()
    net_mask = net_mask.to(torch.bool).contiguous()
    dev = slot_xy.device                 # with its index, as _check wants
    n, d = net_pins.shape
    t = touched.numel()
    for name, x, dt, shape in (
            ("slot_xy", slot_xy, torch.float32, (slot_xy.shape[0], 2)),
            ("net_mask", net_mask, torch.bool, (n, d)),
            ("per_net_cost", per_net_cost, torch.float32, (n,)),
            ("slot_of", slot_of, torch.int32, (slot_of.numel(),)),
            ("touched", touched, torch.int32, (t,))):
        _check(name, x, dt, shape, dev)
    tab = pin_table(net_pins[None], net_mask[None])
    new = torch.empty((t,), dtype=torch.float32, device=dev)
    delta = torch.empty((), dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.pnr_swap_delta(t, n, tab.shape[2], _ptr(slot_xy), _ptr(slot_of),
                            _ptr(tab), _ptr(per_net_cost), _ptr(touched),
                            _ptr(ab), _ptr(new), _ptr(delta), _stream(dev))
    _check_rc(lib, rc, "swap_delta_kernel")
    hpwl_delta_pallas.launches += 1
    return new, delta


hpwl_delta_pallas.launches = 0
