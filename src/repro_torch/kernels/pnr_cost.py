"""Half-perimeter wirelength (HPWL) cost functions and the placement kernels.

The annealing placer in :mod:`repro_torch.fabric.place` scores candidate
placements by total HPWL over all nets.  Nets are lowered once to a padded
pin matrix (``net_pins``: net x pin -> entity index, ``net_mask`` marking
real pins); a placement is then a gather + masked min/max reduction.

Plain PyTorch functions (the semantics every kernel is held to):

* :func:`net_hpwl` / :func:`hpwl` — per-net / total HPWL of one placement;
* :func:`hpwl_delta` — rescore only the nets a swap touches;
* :func:`hpwl_reference` — pure-Python oracle.

Kernels (CUDA C++ for sm_90a, ``csrc/pnr_anneal.cu``), each with a plain
version beside it that the wrapper runs for CPU tensors:

* :func:`net_hpwl_rows` (K1) — per-net HPWL for a batch of placements,
  replacing the reference's Pallas ``_hpwl_kernel`` (``hpwl_pallas``);
* :func:`anneal_chains` (K2) — whole annealing sweeps with the delta
  rescoring of the reference's Pallas ``_hpwl_delta_kernel`` fused in,
  replacing the ``fori_loop`` of ``_build_batch_annealer`` /
  ``_build_annealer``.

Each wrapper counts its launches in ``<wrapper>.launches``.  For a CUDA
tensor it launches its kernel or raises; it never falls back to the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["hpwl_reference", "net_hpwl_from_xy", "net_hpwl", "hpwl",
           "hpwl_delta", "net_hpwl_rows", "net_hpwl_rows_plain",
           "anneal_chains", "anneal_chains_plain", "CURVE_POINTS"]

_BIG = 1e9

#: cost-curve snapshot points captured per chain when telemetry is on
CURVE_POINTS = 16

_SOURCE = "pnr_anneal.cu"
_MAX_TOUCHED = 64          # 2K: the kernel keeps two touched nets per lane


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
# kernel plumbing
# ---------------------------------------------------------------------------
def _lib():
    from .build import load
    lib = load(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pnr_net_hpwl.argtypes = [i, i, i, i] + [p] * 7
        lib.pnr_net_hpwl.restype = i
        lib.pnr_anneal.argtypes = [i] * 8 + [p] * 17
        lib.pnr_anneal.restype = i
        lib.pnr_anneal_smem_bytes.argtypes = [i, i]
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


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


# ---------------------------------------------------------------------------
# K1: batched per-net HPWL
# ---------------------------------------------------------------------------
def net_hpwl_rows_plain(prob: torch.Tensor, slot_of: torch.Tensor,
                        slot_xy: torch.Tensor, net_pins: torch.Tensor,
                        net_mask: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: ``out[r] = net_hpwl(slot_xy[p][slot_of[r]],
    net_pins[p], net_mask[p])`` with ``p = prob[r]``."""
    p = prob.long()
    pins = net_pins[p].long()                                 # (R, N, D)
    slots = torch.gather(slot_of.long(), 1,
                         pins.flatten(1)).view(pins.shape)    # (R, N, D)
    xy = slot_xy[p[:, None, None], slots]                     # (R, N, D, 2)
    return net_hpwl_from_xy(xy, net_mask[p])


def net_hpwl_rows(prob: torch.Tensor, slot_of: torch.Tensor,
                  slot_xy: torch.Tensor, net_pins: torch.Tensor,
                  net_mask: torch.Tensor) -> torch.Tensor:
    """Per-net HPWL of R placements, each over its own problem.

    prob: (R,) int32 problem index per row; slot_of: (R, E) int32 entity
    -> slot; slot_xy: (P, E, 2) float32; net_pins: (P, N, D) int32;
    net_mask: (P, N, D) bool.  Returns (R, N) float32.

    Kernel K1 (``net_hpwl_kernel``): one thread per (row, net), the pin
    reduction with the reference's ``+-1e9`` sentinels; replaces the
    Pallas ``_hpwl_kernel`` (reference ``kernels/pnr_cost.py``).  Bytes
    bound it: each pin's entity, slot and coordinate is read once.
    """
    dev = slot_of.device
    if dev.type != "cuda":
        return net_hpwl_rows_plain(prob, slot_of, slot_xy, net_pins,
                                   net_mask)
    r, e = slot_of.shape
    p, n, d = net_pins.shape
    _check("prob", prob, torch.int32, (r,), dev)
    _check("slot_of", slot_of, torch.int32, (r, e), dev)
    _check("slot_xy", slot_xy, torch.float32, (p, e, 2), dev)
    _check("net_pins", net_pins, torch.int32, (p, n, d), dev)
    _check("net_mask", net_mask, torch.bool, (p, n, d), dev)
    out = torch.empty((r, n), dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.pnr_net_hpwl(r, n, d, e, _ptr(prob), _ptr(slot_of),
                          _ptr(slot_xy), _ptr(net_pins), _ptr(net_mask),
                          _ptr(out), _stream(dev))
    _check_rc(lib, rc, "net_hpwl_kernel")
    net_hpwl_rows.launches += 1
    return out


net_hpwl_rows.launches = 0


# ---------------------------------------------------------------------------
# K2: annealing chains with fused delta rescoring
# ---------------------------------------------------------------------------
AnnealOut = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                  Optional[torch.Tensor]]


def anneal_chains_plain(prob, slot_xy, net_pins, net_mask, ent_nets, temps,
                        active, a, t, log_u, slot0, pnc0, *,
                        full: bool = False, telemetry: bool = False,
                        work: Optional[dict] = None) -> AnnealOut:
    """Plain version of K2: every chain's sweep, vectorised over chains
    with a Python loop over steps (the reference ``fori_loop`` body).

    ``work``, when given, accumulates what this run's data made the
    kernel do: ``steps`` (chain-steps), ``nets`` (nets rescored) and
    ``pins`` (pins visited) — the operation count of a roofline bound.
    """
    dev = slot0.device
    r_n, e_n = slot0.shape
    n_n = net_pins.shape[1]
    s_n = a.shape[1]
    k_n = ent_nets.shape[2]
    rows = torch.arange(r_n, device=dev)
    p = prob.long()
    pins_r = net_pins[p].long()                               # (R, N, D)
    mask_r = net_mask[p]
    xy_r = slot_xy[p]                                         # (R, E, 2)
    en_r = ent_nets[p].long()                                 # (R, E, K)
    temps_r = temps[p]
    active_r = active[p]
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

    for i in range(s_n):
        ai = a[:, i].long()
        ti = t[:, i].long()
        bi = occ[rows, ti]
        sa = slot_of[rows, ai]
        sb = slot_of[rows, bi]
        if full:
            new = net_hpwl_from_xy(swapped_xy(pins_r, ai, bi, sa, sb),
                                   mask_r).sum(dim=1)
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
            new_vals = net_hpwl_from_xy(swapped_xy(pins, ai, bi, sa, sb),
                                        mask)
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


def anneal_chains(prob, slot_xy, net_pins, net_mask, ent_nets, temps,
                  active, a, t, log_u, slot0, pnc0, *, full: bool = False,
                  telemetry: bool = False) -> AnnealOut:
    """Anneal R chains, each over its own problem, for S steps.

    Problem arrays (P problems): slot_xy (P, E, 2) float32, net_pins and
    net_mask (P, N, D) int32/bool, ent_nets (P, E, K) int32 (entries >= N
    are padding), temps (P, S) float32, active (P, S) bool.  Per chain:
    prob (R,) int32, move streams a / t (R, S) int32 and log_u (R, S)
    float32, starting slots slot0 (R, E) int32 and their per-net costs
    pnc0 (R, N) float32.

    Each step swaps entity ``a`` with the occupant ``b`` of slot ``t``,
    rescores the nets the swap touches (every net with ``full``), accepts
    when ``new <= cur`` or ``log_u * temp < cur - new`` (and the step is
    active), and tracks the best placement.  Returns ``(best_slot (R, E)
    int32, best (R,) float32, accepts (R,) int32, curve (R, 16) float32)``;
    the last two only with ``telemetry`` (else None).

    Kernel K2 (``anneal_kernel``): one warp per chain for the whole sweep,
    the chain's state in shared memory; the delta rescoring of the
    reference's Pallas ``_hpwl_delta_kernel`` fused into each step.  The
    step-to-step dependency, not bytes, sets its pace.
    """
    dev = slot0.device
    if dev.type != "cuda":
        return anneal_chains_plain(prob, slot_xy, net_pins, net_mask,
                                   ent_nets, temps, active, a, t, log_u,
                                   slot0, pnc0, full=full,
                                   telemetry=telemetry)
    r, e = slot0.shape
    p, n, d = net_pins.shape
    k = ent_nets.shape[2]
    s = a.shape[1]
    if 2 * k > _MAX_TOUCHED:
        raise ValueError(f"anneal_chains: {k} nets on one entity exceed the "
                         f"kernel's {_MAX_TOUCHED // 2}")
    for name, x, dt, shape in (
            ("prob", prob, torch.int32, (r,)),
            ("slot_xy", slot_xy, torch.float32, (p, e, 2)),
            ("net_pins", net_pins, torch.int32, (p, n, d)),
            ("net_mask", net_mask, torch.bool, (p, n, d)),
            ("ent_nets", ent_nets, torch.int32, (p, e, k)),
            ("temps", temps, torch.float32, (p, s)),
            ("active", active, torch.bool, (p, s)),
            ("a", a, torch.int32, (r, s)), ("t", t, torch.int32, (r, s)),
            ("log_u", log_u, torch.float32, (r, s)),
            ("slot0", slot0, torch.int32, (r, e)),
            ("pnc0", pnc0, torch.float32, (r, n))):
        _check(name, x, dt, shape, dev)
    lib = _lib()
    smem = lib.pnr_anneal_smem_bytes(n, e)
    if smem > 227 * 1024:
        raise ValueError(f"anneal_chains: {e} entities x {n} nets need "
                         f"{smem} bytes of shared memory (> 227 KB)")
    best_slot = torch.empty((r, e), dtype=torch.int32, device=dev)
    best = torch.empty((r,), dtype=torch.float32, device=dev)
    accepts = torch.zeros((r,), dtype=torch.int32, device=dev)
    curve = torch.zeros((r, CURVE_POINTS), dtype=torch.float32, device=dev)
    rc = lib.pnr_anneal(r, s, n, d, e, k, int(full), int(telemetry),
                        _ptr(prob), _ptr(slot_xy), _ptr(net_pins),
                        _ptr(net_mask), _ptr(ent_nets), _ptr(temps),
                        _ptr(active), _ptr(a), _ptr(t), _ptr(log_u),
                        _ptr(slot0), _ptr(pnc0), _ptr(best_slot), _ptr(best),
                        _ptr(accepts), _ptr(curve), _stream(dev))
    _check_rc(lib, rc, "anneal_kernel")
    anneal_chains.launches += 1
    return (best_slot, best, accepts if telemetry else None,
            curve if telemetry else None)


anneal_chains.launches = 0
