#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It drives the port's main path — the Explorer on the paper's Fig. 10
image suite (gaussian, harris, camera, laplacian), per-app PE1..PE4,
place-and-route on a 16x16 fabric at the default annealing budget
(16 chains x 32 sweeps), then modulo scheduling and the cycle-accurate
golden check (``simulate=True`` at the default 3 iterations x 2 input
rows) — and holds every kernel on that path against its plain PyTorch
version:

1. require a card; print its name and power limit (``nvidia-smi``);
2. build the kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc``
   (one process per source, all started together) and print each
   kernel's registers and shared memory (``-Xptxas -v``);
3. run the Explorer's front half (mine -> rank -> merge -> map) on the
   card's Explorer, lower every (variant, app) pair, group the pairs by
   bucket signature, and on every signature check the annealing kernel
   (K2: delta, full and telemetry) against its plain version on the card —
   the starting per-net costs its prologue scores (K1's function, which
   has no launch of its own), slots, costs, accept counts and cost curves
   bit-equal — and time K2 and sum it over the signatures (one launch each
   on the main path); then place, route and schedule every
   pair on a copy of the front, group the programs by sim signature, and
   on every one check the cycle stepper (K3, state in shared and in global
   memory) against its plain version on the card, outputs bit-equal;
4. run the Explorer to the end on the card, traced by ``torch.profiler``
   (CUDA activity), with the launch counters set to 0 just before, read
   them just after, then rerun pnr, schedule and simulate on the CPU over
   the same mined and mapped front (one store, ``forget("pnr", "sched",
   "sim")``) and require identical records, sim buckets and failure rows,
   every simulated pair golden-verified, K2 launched, K3 launched once
   per sim bucket, the trace's launches of both equal to the counters,
   and no launch in the trace of K1 (a kernel whose name holds "hpwl") or
   of another kernel of this repository's sources;
5. time each kernel and its plain version with CUDA events at the main
   path's largest signature (camera on PE1), K2 also a step and with zero
   steps (staging, the prologue that computes K1's function, and writing
   the start out: the kernel alone from the profiler's trace, and with
   its wrapper); K3's launch
   alone (its wrapper's host work apart) also a cycle, with its state in
   global memory, at a larger input batch, and with empty cycles
   (barriers and event walks only: the floor of a cycle, printed beside
   its bytes bound);
6. the fused-PE path: run the Explorer's front half on the paper's
   Fig. 11 ML suite with the benchmark's settings (PE_ML, then per-app
   variants of up to 3 merged subgraphs), and, with the launch counters
   set to 0 just before and read just after, apply every configuration
   of every variant through ``kernel_from_config`` (K4, Triton generated
   per pattern) to float32 operands of shape (4096, 8192) — the MLP
   activation of the Llama 3.2 1B configuration the repository carries
   (d_ff 8192) at 4096 tokens — and run ``matmul_fused`` (K5, CUDA C++)
   at x (4096, 2048) @ w (2048, 8192) with four epilogues: none, the
   Conv tail (bias + ReLU), the Block tail (skip-add + ReLU), and the
   Conv tail stored as bfloat16; hold every result against its plain
   version on the card, K4 also in bfloat16 once per distinct pattern,
   both against the float64 oracles on small inputs, and time K4 at the
   largest and the median distinct pattern and K5 (3xTF32 on wgmma) on
   the first three epilogues and against ``torch.matmul``;
7. the attention and selective-scan boundary at the widths of three
   configurations the repository carries: with the launch counters set to
   0 just before and read just after, ``attention`` (K6) at Llama 3.2 1B
   (32 query heads, 8 kv heads, head dim 64, 4096 tokens, causal; (a) in
   float32, (c) in bfloat16), at a Gemma 2 27B local layer (32 / 16
   heads, head dim 128, 8192 tokens, causal, window 4096, softcap 50,
   scale 1/12; (b)) and non-causal at a ragged 4000 tokens (d), and
   ``selective_scan`` (K7) at falcon-mamba-7b (d_inner 8192, d_state 16,
   4096 tokens) and at a ragged S=100, D=50; hold each result against its
   plain version on the card (K6 in bfloat16 also by its relative error
   norm, over the output and over each row) and K6 in float32 against the
   float64 oracle ``ref_attention`` (on query heads 0-1 for (b)); time
   each kernel, its plain version and, for (a), (c) and (d),
   ``scaled_dot_product_attention`` (with the backend PyTorch picks), and
   print K6's share of its bound, its ratio to that call, and the floor
   its exponentials set;
8. hierarchical placement (``place_hierarchical``) on the locality-4
   synthetic netlists of ``benchmarks/pnr_bench.py`` (``HIER_SIZES``):
   at 64x64 with that bench's budget (2 chains x 2 sweeps) the card's
   ``HierPlacement`` equals the CPU's field by field and delta equals full
   on the card; at 128x128 (8x8 clusters of 16x16) at the default budget
   (16 chains x 32 sweeps), with the launch counter set to 0 just before
   and read just after, the wall of each span (partition, cluster, io,
   detail, deblock) and K2's launches and time per level (each call
   attributed to the ``pnr.hier.*`` span open around it), then K2 held
   to its plain version at every level: the cluster level's launch (full
   scoring in the kernel), the detail level's largest, and the deblock's
   on its first ``HIER_CHECK_STEPS`` steps; flat ``place`` at 64x64
   beside the hierarchical placer at the same budget; and a flat 128x128
   problem on the grouped path (``anneal_jax_batch``, padded to its
   bucket signature), whose chain state exceeds shared memory and lives
   in global memory: timed, and held to the plain version on its first
   ``HIER_CHECK_STEPS`` steps;
9. serving, the second entry point into K2 and K3, and the rest of
   observability: ``analyze_pnr`` of the largest scheduled pair from
   phase 4's card ``PnRResult`` equals the report from the CPU rerun's;
   ``buildprof`` records exactly one compile event and one
   ``kernel-compile`` span for one ``nvcc`` run (mamba_scan.cu into a
   fresh build directory), and (around phase 6) one Triton
   specialisation for each distinct (pattern, dtype) K4 launched; then
   the four overlapping clients of the JAX package's serve smoke (r1
   {camera}, r2 {camera, harris}, r3 {harris, gaussian}, r4 {camera,
   laplacian}) at phase 3's configuration, each solo on the card and
   then all at once through ``repro_torch.serve.ExploreService``, every
   run from a copy of phase 3's mined and mapped front (nothing mined):
   with the launch counters set to 0 just before the served batch and
   read just after, under ``torch.profiler``, every response ``ok``, not
   cached, byte-identical to its solo run and record for record equal
   to phase 4's card records, its failure rows only phase 4's schedule
   rows for its apps, no degraded batch, K2 and K3 launched (as many
   times as the trace shows) and fewer launches and dispatches than the
   solo runs summed; a repeat of r2 under a new id answered from cache
   without a launch in under 1000 ms; r2 and a malformed line over TCP;
   it prints the served wall, the solo walls summed, the launches, the
   cache hit's milliseconds and the device's busy share of the served
   wall, beside the card's name and power limit;
10. print one JSON line ``{"kernels": [...]}`` with launches, max |diff|,
   times and bounds of K1-K7 (K1's row: its launches counted in the
   main path's trace, its ``ms`` K2 with zero steps, the kernel alone,
   against the bound of that launch's bytes, its ``timed`` key says so;
   K3's ``ms`` its launch alone, its
   ``wrapper_ms`` with the wrapper's host work, as the main path pays
   it; K2's and K3's ``serve_launches`` their launches in the served
   batch), then ``{"ok": true, "device": {...}}`` as the last line.

Any failure exits nonzero; no phase catches an error and carries on
(phase 6 counts the configurations the port refuses with the reference's
``ValueError`` and prints them).
Bounds: bytes over 3.35 TB/s and operations over 67 TFLOP/s (float32
outside the tensor cores), the H100 SXM's published peaks at 700 W; on
the tensor cores, the function's own operations at their rate for the
operands' type: K5 2MNK at 495 TFLOP/s (TF32), K6 4·D a pair inside the
masks at 495 TFLOP/s for float32 and 989 TFLOP/s for bfloat16 (the three
TF32 products 3xTF32 does for each are printed apart, as the share of the
kernel's time they would take at that rate).  The run fails if K5 is not
faster than ``torch.matmul`` or a kernel reads below its bound.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
#: special-function results (expf's ex2) a second: 16 a clock an SM (the
#: CUDA C++ Programming Guide's throughput table, compute capability 9.0)
#: on 132 SMs at the 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9
CSRC = "src/repro_torch/kernels/csrc/"
#: the larger input batch K3 is also timed at (sim_batch x sim_iterations)
BIG_BATCH, BIG_ITERS = 256, 16
#: phase 6 widths: Llama 3.2 1B (src/repro/configs/llama3_2_1b.py) d_model
#: and d_ff, at 4096 tokens
TOKENS, D_MODEL, D_FF = 4096, 2048, 8192
K4_TOL, K4_BF16_TOL, K5_TOL = 1e-5, 5e-2, 1e-4
#: phase 7: (B, Hq, Hkv, D, S, options, dtype) of each K6 case —
#: (a) src/repro/configs/llama3_2_1b.py (32 heads, kv 8, head_dim 64) at
#: 4096 tokens, (b) a local layer of src/repro/configs/gemma2_27b.py
#: (32 heads, kv 16, head_dim 128, window 4096, softcap 50, scale 1/12)
#: at its max_seq_len 8192, (c) = (a) in bfloat16, (d) non-causal at a
#: sequence length that is not a multiple of the tile
K6_CASES = {
    "a": (1, 32, 8, 64, 4096, dict(causal=True), "float32"),
    "b": (1, 32, 16, 128, 8192, dict(causal=True, window=4096, softcap=50.0,
                                     scale=1.0 / 12), "float32"),
    "c": (1, 32, 8, 64, 4096, dict(causal=True), "bfloat16"),
    "d": (1, 8, 2, 64, 4000, dict(causal=False), "float32"),
}
#: K7 at src/repro/configs/falcon_mamba_7b.py (d_model 4096, expand 2,
#: d_state 16) at 4096 tokens, and a ragged (S, D)
K7_SHAPE, K7_RAGGED = (1, 4096, 8192, 16), (1, 100, 50, 16)
K6_TOL, K6_BF16_TOL, K7_TOL = 2e-5, 5e-2, 1e-4
#: K6 in bfloat16 (c) is also held, against its plain version, to
#: ||got - want|| / ||want|| over the whole output and over each row of
#: head_dim values.  Rounding P and the output to bfloat16 (2^-9 relative
#: each) gives a sound kernel about 2^-9 over the output and at most
#: 0.006 on a row (H100: case (c) and the gpu tests' bfloat16 cases); an
#: output 1% low fails the first limit, a kv tile's P V dropped or an
#: unrescaled accumulator both
K6_BF16_REL, K6_BF16_ROW = 2.0 ** -8, 2.0 ** -6
#: phase 8: benchmarks/pnr_bench.py HIER_SIZES, HIER_LOCALITY and the
#: seed of its hier_sweep (the netlist's; the placer's is seed + 1)
HIER_SIZES, HIER_LOCALITY, HIER_SEED = (64, 128), 4, 4
#: the steps of the 128x128 deblock's chains (of 65536) and of the grouped
#: flat 128x128 bucket's (of 524288) held to the plain version, which
#: takes about a millisecond a step
HIER_CHECK_STEPS = 4096
#: K2's per-step inputs (R, S) or (P, S), cut to a prefix of steps
STREAMS = ("a", "t", "log_u", "temps", "active")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs (CUDA events,
    after one warm-up run)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def same_bits(a, b) -> bool:
    """float32 tensors equal bit for bit (every NaN equal to every NaN)."""
    import torch
    eq = (a.view(torch.int32) == b.view(torch.int32)) \
        | (torch.isnan(a) & torch.isnan(b))
    return bool(eq.all())


def device_kernels(run):
    """``run()`` under ``torch.profiler`` (CUDA activity): its result, the
    device kernels it launched, ``{name: [milliseconds of each launch]}``
    (copies and memsets included under their own names), and the
    milliseconds in which the device ran at least one of them (the union
    of their intervals: its busy time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    kern, spans = {}, []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            tr = ev.time_range
            kern.setdefault(ev.name, []).append(tr.elapsed_us() / 1e3)
            spans.append((tr.start, tr.end))
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    return out, kern, busy_us / 1e3


def launches_of(kern: dict, name: str) -> int:
    """Launches of the kernels in a :func:`device_kernels` trace whose
    name holds ``name`` as a word."""
    pat = re.compile(rf"\b{name}\b")
    return sum(len(v) for k, v in kern.items() if pat.search(k))


def source_kernels() -> list:
    """Names of the ``__global__`` functions in the port's CUDA sources."""
    names = set()
    for f in sorted(os.listdir(os.path.join(ROOT, CSRC))):
        if f.endswith(".cu"):
            with open(os.path.join(ROOT, CSRC, f)) as fh:
                names.update(re.findall(
                    r"__global__[^{;]*?\b(\w+_kernel)\s*\(", fh.read()))
    return sorted(names)


def record_k2_calls(run):
    """``run()`` with tracing on and every ``fabric.place.run_chains`` call
    (K2's one launch on the placement paths) recorded as ``(level,
    inputs, full, wall_s)``: ``level`` is the innermost open
    ``pnr.hier.*`` span without its prefix (cluster, detail, deblock), or
    "flat" outside them.  Returns (run's result, the calls, the
    tracer)."""
    import torch
    from repro_torch.obs import disable_tracing, enable_tracing
    place_mod = sys.modules["repro_torch.fabric.place"]
    orig = place_mod.run_chains
    calls = []
    tracer = enable_tracing()

    def run_chains(inputs, device, *, full=False, telemetry=False):
        level = next((n[len("pnr.hier."):]
                      for n in reversed(tracer.open_spans())
                      if n.startswith("pnr.hier.")), "flat")
        sync = torch.device(device).type == "cuda"
        if sync:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(inputs, device, full=full, telemetry=telemetry)
        if sync:
            torch.cuda.synchronize()
        calls.append((level, inputs, full, time.perf_counter() - t))
        return out

    place_mod.run_chains = run_chains
    try:
        out = run()
    finally:
        disable_tracing()
        place_mod.run_chains = orig
    return out, calls, tracer


def k2_per_level(calls, dev) -> dict:
    """Each recorded K2 call (:func:`record_k2_calls`) launched again on
    the card and timed alone (CUDA events), summed by level: launches,
    ms, the calls' walls with their inputs' copies, and each launch's
    shape and layout (:func:`pnr_cost.anneal_layout`)."""
    from repro_torch.fabric.place import KERNEL_INPUTS
    from repro_torch.kernels import pnr_cost
    per_level = {}
    for lv, inputs, full, call_wall in calls:
        d = {k: v.to(dev) for k, v in inputs.items()}
        args = [d[k] for k in KERNEL_INPUTS]
        fix = d.get("net_fix")
        ms = cuda_ms(lambda: pnr_cost.anneal_chains(*args, fix, full=full),
                     1)
        row = per_level.setdefault(lv, {"launches": 0, "ms": 0.0,
                                        "call_wall_s": 0.0, "shapes": []})
        row["launches"] += 1
        row["ms"] += ms
        row["call_wall_s"] += call_wall
        r_, s_ = d["a"].shape
        p_, n_, d_ = d["net_pins"].shape
        e_, k_ = d["ent_nets"].shape[1:]
        _, stage, chain, smem = pnr_cost.anneal_layout(n_, d_, e_, k_,
                                                       fix is not None)
        row["shapes"].append(
            f"R={r_} S={s_} P={p_} N={n_} D={d_} E={e_} K={k_}"
            + (" boxes" if fix is not None else "")
            + (" full scoring" if full or 2 * k_ > pnr_cost._MAX_TOUCHED
               else "")
            + f" (tables {'staged' if stage else 'global'}, chain "
            f"{'shared' if chain else 'global'}, {smem} B shared a block; "
            f"{ms:.4f} ms)")
    return per_level


def k2_vs_plain(d: dict, what: str, steps=None) -> tuple:
    """K2 on the kernel inputs ``d`` (on the card) against its plain
    version in delta, full and telemetry mode: the starting costs its
    prologue writes (``pnc0_out``; the plain version's are
    ``net_hpwl_rows_plain``'s), slots, costs, accepts and curves
    bit-equal, or the run fails.  With ``steps``, both run the first
    ``steps`` steps of every chain only.  Returns the largest |difference|
    of the starting costs and of the other float outputs (0, 0)."""
    import torch
    from repro_torch.fabric.place import KERNEL_INPUTS
    from repro_torch.kernels import pnr_cost
    if steps is not None:
        d = {k: (v[:, :steps].contiguous() if k in STREAMS else v)
             for k, v in d.items()}
    args = [d[k] for k in KERNEL_INPUTS] + [d.get("net_fix")]
    err = {"pnc0": 0.0, "out": 0.0}
    for full, tele in ((False, False), (True, False), (False, True)):
        got0 = torch.full((d["a"].shape[0], d["net_pins"].shape[1]), -1.0,
                          device=d["a"].device)
        want0 = torch.full_like(got0, -2.0)
        got = pnr_cost.anneal_chains(*args, full=full, telemetry=tele,
                                     pnc0_out=got0)
        want = pnr_cost.anneal_chains_plain(*args, full=full, telemetry=tele,
                                            pnc0_out=want0)
        torch.cuda.synchronize()
        for name, g, w in zip(("pnc0", "best_slot", "best", "accepts",
                               "curve"), (got0,) + got, (want0,) + want):
            if (g is None) != (w is None) or (g is not None
                                              and not torch.equal(g, w)):
                fail(f"K2 (full={full}, telemetry={tele}) {name} differs "
                     f"from its plain version: {what}")
            if g is not None and g.dtype == torch.float32:
                key = "pnc0" if name == "pnc0" else "out"
                err[key] = max(err[key], float((g - w).abs().max()))
    return err["pnc0"], err["out"]


def rel_norms(got, want) -> tuple:
    """||got - want|| / ||want|| over the whole tensor, and its largest
    value over the rows of the last axis."""
    d, w = got.double() - want.double(), want.double()
    return (float(d.norm() / w.norm()),
            float((d.norm(dim=-1) / w.norm(dim=-1)).max()))


def k6_bf16_check(name: str, got, want) -> tuple:
    """Fails unless K6's bfloat16 output is within :data:`K6_BF16_REL`
    of ``want`` over the whole tensor and :data:`K6_BF16_ROW` on every
    row (both relative error norms); returns the two readings."""
    rel, row = rel_norms(got, want)
    if not (rel <= K6_BF16_REL and row <= K6_BF16_ROW):
        fail(f"{name}: relative error norm {rel} (limit {K6_BF16_REL}), "
             f"largest over the rows {row} (limit {K6_BF16_ROW})")
    return rel, row


def attention_scan_phase(dev, launches: dict) -> dict:
    """Phase 7: K6 and K7 at model widths through ``attention`` and
    ``selective_scan``, counted, checked and timed; sets ``launches["k6"]``
    and ``launches["k7"]`` and returns the numbers of the kernels line."""
    import torch
    from repro_torch.kernels import (attention, flash_attention, mamba_scan,
                                     selective_scan)
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.mamba_scan import mamba_scan_plain
    from repro_torch.kernels.ref import ref_attention, ref_mamba_scan

    phase("7 attention (K6) and selective scan (K7) at model widths")
    gen7 = torch.Generator(device=dev).manual_seed(16)
    k6_in = {}
    for case, (b_, hq, hkv, hd, s_, kw, dt) in K6_CASES.items():
        if case == "c":                     # (a)'s inputs, rounded
            k6_in[case] = [t.to(torch.bfloat16) for t in k6_in["a"]]
            continue
        k6_in[case] = [torch.randn((b_, h, s_, hd), generator=gen7,
                                   device=dev) for h in (hq, hkv, hkv)]

    def scan_inputs(shape):
        # tests/test_kernels.py: a ~ U(0.6, 0.999), bx ~ N(0, 0.1^2),
        # c ~ N(0, 1)
        b_, s_, d_, n_ = shape
        a = torch.rand(shape, generator=gen7, device=dev) * 0.399 + 0.6
        bx = torch.randn(shape, generator=gen7, device=dev) * 0.1
        c = torch.randn((b_, s_, n_), generator=gen7, device=dev)
        return a, bx, c

    k7_in = scan_inputs(K7_SHAPE)
    k7r_in = scan_inputs(K7_RAGGED)
    torch.cuda.synchronize()
    flash_attention.launches = 0
    mamba_scan.launches = 0
    k6_out = {case: attention(*k6_in[case], **K6_CASES[case][5])
              for case in K6_CASES}
    k7_out = selective_scan(*k7_in)
    k7r_out = selective_scan(*k7r_in)
    torch.cuda.synchronize()
    launches["k6"] = flash_attention.launches
    launches["k7"] = mamba_scan.launches
    print(f"launches {{'k6': {launches['k6']}, 'k7': {launches['k7']}}}",
          flush=True)
    if launches["k6"] != len(K6_CASES) or launches["k7"] != 2:
        fail(f"K6 launched {launches['k6']} times for {len(K6_CASES)} "
             f"cases, K7 {launches['k7']} times for 2")

    def check(name, got, want, tol):
        """max |got - want|; fails unless |got - want| <= tol * (1 +
        |want|) everywhere and got is finite."""
        d = (got.double() - want.double()).abs()
        ok = bool((d <= tol * (1 + want.double().abs())).all()) \
            and bool(torch.isfinite(got).all())
        err = float(d.max())
        if not ok:
            fail(f"{name}: max |diff| {err} above {tol}")
        return err

    k6_err = 0.0
    for case, (b_, hq, hkv, hd, s_, kw, dt) in K6_CASES.items():
        q, k, v = k6_in[case]
        got = k6_out[case]
        if got.shape != q.shape or got.dtype != getattr(torch, dt):
            fail(f"K6 ({case}) returned {got.dtype} {tuple(got.shape)}")
        tol = K6_BF16_TOL if dt == "bfloat16" else K6_TOL
        plain = attention_plain(q, k, v, **kw)
        err = check(f"K6 ({case}) vs its plain version", got, plain, tol)
        if dt == "float32":
            k6_err = max(k6_err, err)
        else:
            rel, row = k6_bf16_check(f"K6 ({case}) vs its plain version",
                                     got, plain)
            print(f"K6 ({case}): relative error norm {rel} (limit "
                  f"{K6_BF16_REL}), largest over the rows {row} (limit "
                  f"{K6_BF16_ROW})", flush=True)
        # the float64 oracle: every head, one kv head at a time; for (b)
        # (S x S in float64 at 8192 tokens) query heads 0-1 only
        group = hq // hkv
        kv_heads = range(1) if case == "b" else range(hkv)
        oracle_err = 0.0
        if dt == "float32":
            for g in kv_heads:
                hs = slice(g * group, (g + 1) * group)
                want = ref_attention(q[:, hs].double(),
                                     k[:, g:g + 1].double(),
                                     v[:, g:g + 1].double(), **kw)
                oracle_err = max(oracle_err, check(
                    f"K6 ({case}) vs the float64 oracle", got[:, hs], want,
                    K6_TOL))
        print(f"K6 ({case}) B={b_} Hq={hq} Hkv={hkv} D={hd} S={s_} {kw} "
              f"{dt}: == plain at {tol} (max |diff| {err}); float64 oracle "
              f"max |diff| {oracle_err if dt == 'float32' else 'n/a'} on "
              f"{len(kv_heads) * group if dt == 'float32' else 0} heads",
              flush=True)
    k7_err = check("K7 vs its plain version", k7_out,
                   mamba_scan_plain(*k7_in), K7_TOL)
    k7r_err = check("K7 (ragged) vs its plain version", k7r_out,
                    mamba_scan_plain(*k7r_in), K7_TOL)
    check("K7 (ragged) vs the float64 oracle", k7r_out,
          ref_mamba_scan(*[t.double() for t in k7r_in]), K7_TOL)
    if k7_out.shape != K7_SHAPE[:3] or k7_out.dtype != torch.float32:
        fail(f"K7 returned {k7_out.dtype} {tuple(k7_out.shape)}")
    print(f"K7 at {K7_SHAPE}: == plain at {K7_TOL} (max |diff| {k7_err}); "
          f"at {K7_RAGGED}: == plain (max |diff| {k7r_err}) and the float64 "
          f"oracle", flush=True)

    # times, bounds and the one-call yardstick
    def attn_pairs(s_, causal, window):
        """(q, k) pairs inside the masks: the work this run's data needs."""
        qp = torch.arange(s_, dtype=torch.int64)
        hi = qp if causal else torch.full_like(qp, s_ - 1)
        lo = (qp - window + 1).clamp(min=0) if window > 0 \
            else torch.zeros_like(qp)
        return int((hi - lo + 1).clamp(min=0).sum())

    from torch.nn.functional import scaled_dot_product_attention

    def sdpa_backend(q, k, v, **kw):
        """The backend PyTorch's dispatcher picks for these inputs."""
        if not hasattr(torch, "_fused_sdp_choice"):
            return "unknown (no torch._fused_sdp_choice)"
        from torch.nn.attention import SDPBackend
        return SDPBackend(torch._fused_sdp_choice(q, k, v, **kw)).name

    k6_rows, lib_err, lib_backend = {}, {}, {}
    for case, (b_, hq, hkv, hd, s_, kw, dt) in K6_CASES.items():
        q, k, v = k6_in[case]
        reps = 3 if case == "b" else 10
        ms = cuda_ms(lambda: attention(q, k, v, **kw), reps)
        plain_ms = cuda_ms(lambda: attention_plain(q, k, v, **kw), 2)
        lib_ms = None
        if case != "b":         # no one call computes (b)'s softcap
            sdpa = dict(is_causal=kw["causal"], enable_gqa=True)
            lib_ms = cuda_ms(lambda: scaled_dot_product_attention(
                q, k, v, **sdpa), reps)
            lib_err[case] = float((scaled_dot_product_attention(
                q, k, v, **sdpa).float() - k6_out[case].float()).abs().max())
            lib_backend[case] = sdpa_backend(q, k, v, **sdpa)
        pairs = b_ * hq * attn_pairs(s_, kw["causal"], kw.get("window", 0))
        ops = 4 * hd * pairs
        byts = nbytes(q, k, v, k6_out[case])
        peak = BF16_OPS_PER_S if dt == "bfloat16" else TF32_OPS_PER_S
        k6_rows[case] = (ms, plain_ms, lib_ms, byts, ops, peak, pairs)
        print(f"K6 ({case}): {ms:.4f} ms ({ops / ms / 1e9:.2f} TFLOP/s over "
              f"{pairs} unmasked pairs), plain {plain_ms:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; "
              f"{byts} bytes, {ops} operations", flush=True)
    for case in lib_err:
        print(f"scaled_dot_product_attention ({case}): backend "
              f"{lib_backend[case]}, max |diff| from K6 {lib_err[case]}")
    k7_ms = cuda_ms(lambda: selective_scan(*k7_in), 10)
    k7_plain = cuda_ms(lambda: mamba_scan_plain(*k7_in), 1)
    k7_bytes = nbytes(*k7_in, k7_out)
    k7_ops = 4 * k7_in[0].numel()       # a*h, + bx, * c, + into y per state
    print(f"K7 at {K7_SHAPE}: {k7_ms:.4f} ms "
          f"({k7_bytes / k7_ms / 1e9:.3f} TB/s), plain {k7_plain:.4f} ms, "
          f"library none; {k7_bytes} bytes, {k7_ops} operations", flush=True)
    return {"k6_rows": k6_rows, "k6_err": k6_err, "k7_ms": k7_ms,
            "k7_plain": k7_plain, "k7_bytes": k7_bytes, "k7_ops": k7_ops,
            "k7_err": k7_err, "sdpa_backend": lib_backend}



def hier_fields_differ(a, b) -> list:
    """The fields of two ``HierPlacement`` s that differ: every level's
    winning slots, the level costs, the final coordinates and cost."""
    import numpy as np
    bad = []
    if not np.array_equal(a.cluster_slots, b.cluster_slots):
        bad.append("cluster_slots")
    if a.detail_slots.keys() != b.detail_slots.keys() or not all(
            np.array_equal(a.detail_slots[k], b.detail_slots[k])
            for k in a.detail_slots):
        bad.append("detail_slots")
    if (a.deblock_slots is None) != (b.deblock_slots is None) or (
            a.deblock_slots is not None
            and not np.array_equal(a.deblock_slots, b.deblock_slots)):
        bad.append("deblock_slots")
    return bad + [f for f in ("level_costs", "coords", "cost")
                  if getattr(a, f) != getattr(b, f)]


def hier_phase(dev) -> dict:
    """Phase 8: ``place_hierarchical`` on the card at 64x64 (== the CPU,
    delta == full) and 128x128 (span walls, K2 per level, K2 with fixed
    boxes == plain at every level), flat ``place`` at 64x64 beside it, and
    a flat 128x128 problem on the grouped path (K2 with its chain's state
    in global memory, == plain)."""
    import torch
    from repro_torch.fabric import (FabricSpec, anneal_jax_batch,
                                    batch_signature, lower, place,
                                    place_hierarchical, synthetic_netlist)
    from repro_torch.fabric.place import KERNEL_INPUTS
    from repro_torch.kernels import pnr_cost

    phase("8 hierarchical placement at mega-fabric size")
    nets = {}
    for size in HIER_SIZES:
        spec = FabricSpec(rows=size, cols=size)
        nets[size] = (spec, synthetic_netlist(spec, seed=HIER_SEED,
                                              locality=HIER_LOCALITY))
    small, big = HIER_SIZES
    spec, nl = nets[small]
    kw = dict(chains=2, sweeps=2, seed=HIER_SEED + 1)
    t0 = time.perf_counter()
    card = {m: place_hierarchical(nl, spec, score_mode=m, device="cuda",
                                  **kw) for m in ("delta", "full")}
    t1 = time.perf_counter()
    cpu = place_hierarchical(nl, spec, score_mode="delta", device="cpu",
                             **kw)
    t2 = time.perf_counter()
    for what, a, b in (("card vs cpu", card["delta"], cpu),
                       ("delta vs full on the card", card["delta"],
                        card["full"])):
        bad = hier_fields_differ(a, b)
        if bad:
            fail(f"hierarchical {small}x{small} {what}: {bad} differ")
    h = card["delta"]
    print(f"hierarchical {small}x{small} (grid {h.cluster_grid}, "
          f"{len(nl.pe_cells)} PE + {len(nl.io_cells)} I/O cells, "
          f"{len(nl.nets)} nets, chains 2 x sweeps 2): card == cpu on "
          f"cluster_slots, detail_slots, deblock_slots, level_costs, "
          f"coords and cost, delta == full on the card; level costs "
          f"{h.level_costs}; card {t1 - t0:.2f} s for both modes, cpu "
          f"{t2 - t1:.2f} s", flush=True)

    # 128x128 at the default budget: every K2 call recorded under the
    # level span it ran in
    spec, nl = nets[big]
    torch.cuda.synchronize()
    pnr_cost.anneal_chains.launches = 0
    t0 = time.perf_counter()
    h, calls, tracer = record_k2_calls(lambda: place_hierarchical(
        nl, spec, chains=16, sweeps=32, seed=HIER_SEED + 1, device="cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pnr_cost.anneal_chains.launches
    spans = {}
    for sp, _depth, _path in tracer.iter_spans():
        if sp.name.startswith("pnr.hier."):
            spans[sp.name[9:]] = spans.get(sp.name[9:], 0.0) + sp.dur
    cells = [c.name for c in nl.pe_cells] + [c.name for c in nl.io_cells]
    levels = [c[0] for c in calls]
    if launches != len(calls) or h.cluster_grid < 2 or sorted(h.coords) \
            != sorted(cells) or len(set(h.coords.values())) != len(cells) \
            or not 0 < h.cost < float("inf") or levels[0] != "cluster" \
            or levels[-1] != "deblock" or "detail" not in levels:
        fail(f"hierarchical {big}x{big}: {launches} launches for {len(calls)} "
             f"calls at levels {levels}, grid {h.cluster_grid}, "
             f"{len(h.coords)} cells placed on {len(set(h.coords.values()))} "
             f"tiles, cost {h.cost}")
    print(f"hierarchical {big}x{big} (grid {h.cluster_grid}, "
          f"{len(nl.pe_cells)} PE + {len(nl.io_cells)} I/O cells, "
          f"{len(nl.nets)} nets, chains 16 x sweeps 32, delta): "
          f"{wall:.3f} s wall; span walls (s) "
          f"{ {k: round(v, 4) for k, v in spans.items()} }; level costs "
          f"{h.level_costs}; K2 launched {launches} times", flush=True)
    per_level = k2_per_level(calls, dev)
    for lv, row in per_level.items():
        print(f"  K2 at the {lv} level: {row['launches']} launch(es), "
              f"{row['ms']:.4f} ms on the card (CUDA events), "
              f"{row['call_wall_s']:.3f} s with its inputs' copies; "
              f"{row['shapes']}", flush=True)

    # K2 against its plain version on every level: the cluster level's
    # launch (more than 32 nets an entity: the kernel scores in full,
    # the plain version in delta too) and the detail level's largest, every
    # step; the deblock (tables and boxes in global memory) on a prefix
    box_err = 0.0
    t0 = time.perf_counter()
    cluster = next(c for c in calls if c[0] == "cluster")
    detail = max((c for c in calls if c[0] == "detail"),
                 key=lambda c: c[1]["prob"].shape[0])
    deblock = next(c for c in calls if c[0] == "deblock")
    for (lv, inputs, _, _), steps in ((cluster, None), (detail, None),
                                      (deblock, HIER_CHECK_STEPS)):
        d = {k: v.to(dev) for k, v in inputs.items()}
        r_, s_ = d["a"].shape
        t1 = time.perf_counter()
        box_err = max(box_err, *k2_vs_plain(d, f"{big}x{big} {lv} level",
                                            steps))
        print(f"K2 == plain (delta, full, telemetry; starting costs, slots, "
              f"costs, accepts, curves) at the {big}x{big} {lv} level"
              f"{' (its largest launch)' if lv == 'detail' else ''}: "
              f"R={r_} chains x "
              + (f"S={s_} steps (not cut)" if steps is None else
                 f"the first {steps} of S={s_} steps (cut: the plain "
                 f"version takes about a millisecond a step)")
              + f", N={d['net_pins'].shape[1]}, K={d['ent_nets'].shape[2]}"
              f"{', boxes' if 'net_fix' in d else ''}, in "
              f"{time.perf_counter() - t1:.1f} s", flush=True)

    # flat beside it at the smaller size, the same budget
    spec, nl = nets[small]
    t0 = time.perf_counter()
    flat = place(nl, spec, chains=16, sweeps=32, seed=HIER_SEED + 1,
                 device="cuda")
    t1 = time.perf_counter()
    h64 = place_hierarchical(nl, spec, chains=16, sweeps=32,
                             seed=HIER_SEED + 1, device="cuda")
    t2 = time.perf_counter()
    print(f"{small}x{small} at chains 16 x sweeps 32: flat place "
          f"{t1 - t0:.3f} s, "
          f"HPWL {flat.cost}; hierarchical {t2 - t1:.3f} s, HPWL "
          f"{h64.cost} (level costs {h64.level_costs})", flush=True)

    # flat at the larger size: its own path fits a chain in shared memory;
    # the grouped path (the Explorer's, padded to the bucket signature)
    # keeps the chain's state in global memory
    spec, nl = nets[big]
    p = lower(nl, spec)
    n_, d_ = p.net_pins.shape
    w, stage, chain, smem = pnr_cost.anneal_layout(n_, d_, p.n_entities,
                                                   p.ent_nets.shape[1])
    print(f"flat {big}x{big} (place, unpadded N={n_}, D={d_}, "
          f"E={p.n_entities}, K={p.ent_nets.shape[1]}): {smem} B of shared "
          f"memory a block, tables {'staged' if stage else 'global'}, chain "
          f"{'shared' if chain else 'global'}", flush=True)
    sig = batch_signature(p, 32)
    w, stage, chain, smem = pnr_cost.anneal_layout(*sig[1:])
    chain_bytes = (2 * sig[3] + sig[1]) * 4
    if chain or chain_bytes <= pnr_cost.SMEM_LIMIT:
        fail(f"the grouped flat {big}x{big} bucket {sig} keeps a chain of "
             f"{chain_bytes} B in shared memory")
    t0 = time.perf_counter()
    _, gcalls, _ = record_k2_calls(lambda: anneal_jax_batch(
        [p], chains=16, sweeps=32, seed=HIER_SEED + 1, device="cuda"))
    g_wall = time.perf_counter() - t0
    _, inputs, _, g_k2_wall = gcalls[0]
    d = {k: v.to(dev) for k, v in inputs.items()}
    g_ms = cuda_ms(lambda: pnr_cost.anneal_chains(
        *[d[k] for k in KERNEL_INPUTS]), 1)
    t1 = time.perf_counter()
    box_err = max(box_err, *k2_vs_plain(d, f"grouped flat {big}x{big}",
                                        HIER_CHECK_STEPS))
    print(f"flat {big}x{big} on the grouped path (anneal_jax_batch, padded "
          f"to {sig}): the chain's {chain_bytes} B of state in global "
          f"memory (> {pnr_cost.SMEM_LIMIT} B), {smem} B shared a block; "
          f"{g_wall:.3f} s wall, K2 {g_ms:.4f} ms on the card (CUDA "
          f"events) for R={d['a'].shape[0]} chains x S={d['a'].shape[1]} "
          f"steps ({1e3 * g_ms / d['a'].shape[1]:.4f} us a step); == plain "
          f"on the first {HIER_CHECK_STEPS} steps (cut) in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    return {"box_err": box_err, "hier_wall": wall, "spans": spans,
            "per_level": per_level}


#: phase 9: the four overlapping clients of the JAX package's serve smoke
#: (src/repro/serve/__main__.py), over the image suite's apps
SERVE_CLIENTS = (("r1", ("camera",)), ("r2", ("camera", "harris")),
                 ("r3", ("harris", "gaussian")),
                 ("r4", ("camera", "laplacian")))


def analyze_check(card_pnrs: dict, cpu_pnrs: dict, skip: set) -> None:
    """``analyze_pnr`` of the largest scheduled pair: the report from the
    card's ``PnRResult`` equals the report from the CPU rerun's."""
    from repro_torch.obs import analyze_pnr
    from repro_torch.sim import modulo_schedule
    pair = max((p for p in card_pnrs if p not in skip),
               key=lambda p: (len(card_pnrs[p].netlist.pe_cells), p))
    reports = []
    for pnr in (card_pnrs[pair], cpu_pnrs[pair]):
        sched = modulo_schedule(pnr.netlist, pnr.placement, pnr.routes,
                                pnr.spec)
        rep = analyze_pnr(pnr, sched)
        reports.append((rep.to_dict(), rep.render()))
    if reports[0] != reports[1]:
        fail(f"analyze_pnr of {pair} differs between the card's and the "
             f"cpu's PnRResult")
    d = reports[0][0]
    print(f"analyze_pnr {pair[0]}/{pair[1]} (card == cpu): pe_util "
          f"{d['pe_util']}, channels {d['used_edges']}/{d['total_edges']}, "
          f"II {d['ii']} (min {d['min_ii']}), skew-critical nets "
          f"{len(d['skew_critical'])}", flush=True)


def buildprof_nvcc_check() -> None:
    """``buildprof`` on one ``nvcc`` run: mamba_scan.cu (the smallest
    source) built into a fresh build directory with a tracer on records
    one compile event and one span on the ``kernel-compile`` track."""
    import tempfile
    from repro_torch.kernels import build
    from repro_torch.obs import buildprof, disable_tracing, enable_tracing
    from repro_torch.obs.metrics import MetricsRegistry
    reg = MetricsRegistry()
    old = os.environ.get("REPRO_TORCH_BUILD_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TORCH_BUILD_DIR"] = tmp
        buildprof.enable(registry=reg)
        tracer = enable_tracing()
        try:
            lib, _ = build.build("mamba_scan.cu")
            built = lib.exists()
        finally:
            disable_tracing()
            buildprof.disable()
            if old is None:
                del os.environ["REPRO_TORCH_BUILD_DIR"]
            else:
                os.environ["REPRO_TORCH_BUILD_DIR"] = old
    spans = [r for r in tracer.to_rows() if r.get("track") == "kernel-compile"]
    secs = reg.histogram("kernels.compile.secs")
    print(f"buildprof: nvcc on mamba_scan.cu {secs.total:.2f} s; counters "
          f"{reg.counters('kernels.compile')}; kernel-compile spans "
          f"{[(r['name'], round(r['dur_s'], 3)) for r in spans]}",
          flush=True)
    if not built or reg.counter("kernels.compile.events") != 1 \
            or reg.counter("kernels.compile.mamba_scan") != 1 \
            or [r["name"] for r in spans] != ["mamba_scan"]:
        fail("buildprof did not record exactly one nvcc compile")


def serve_phase(apps, cfg, front, card_rows, card_fails, card) -> dict:
    """Phase 9: the four overlapping clients of :data:`SERVE_CLIENTS`
    served at once by ``repro_torch.serve.ExploreService`` on the card,
    each held byte for byte to a solo ``Explorer`` run on the card and
    record for record to phase 4's card records; every run starts from a
    copy of phase 3's ``front``, so what is served is pnr, schedule and
    simulate (K2 and K3).  Then a cache hit and a TCP round trip."""
    import asyncio
    from repro_torch.explore import Explorer
    from repro_torch.kernels import pnr_cost, sim_step
    from repro_torch.serve import ExploreService, encode_request

    cfg = cfg.replace(on_error="isolate")       # what the service runs under
    want_row = {(r["pe_name"], r["app"]): r for r in card_rows}

    def counts():
        return (pnr_cost.anneal_chains.launches,
                sim_step.simulate_batch_stepper.launches)

    def fails_of(failures, names):
        return sorted((f["stage"], f["pe_name"], f["app"], f["error_type"])
                      for f in failures if f["app"] in names)

    # solo: one Explorer a client, on the card
    solo, solo_wall, solo_disp, solo_k = {}, 0.0, 0, (0, 0)
    for rid, names in SERVE_CLIENTS:
        ex = Explorer({n: apps[n] for n in names}, cfg, store=dict(front),
                      device="cuda")
        k0 = counts()
        t0 = time.perf_counter()
        res = ex.run()
        solo_wall += time.perf_counter() - t0
        solo_k = tuple(s + b - a for s, a, b in zip(solo_k, k0, counts()))
        solo_disp += ex.stats["pnr_dispatch"] + ex.stats["sim_dispatch"]
        if ex.stats["mine"] or ex.stats["map"]:
            fail(f"solo {rid} re-mined: it must start from phase 3's front")
        solo[rid] = [json.dumps(r.to_dict()) for r in res.records()]
        if fails_of([f.to_dict() for f in res.failures], names) \
                != fails_of(card_fails, names):
            fail(f"solo {rid}'s failure rows differ from phase 4's")

    svc = ExploreService(store=dict(front), max_batch_apps=4,
                         max_wait_ms=100, queue_limit=16)
    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(svc.start())

        async def clients():
            return await asyncio.gather(*[
                svc.explore(rid, {n: apps[n] for n in names}, cfg)
                for rid, names in SERVE_CLIENTS])

        def served():
            t0 = time.perf_counter()
            out = loop.run_until_complete(clients())
            return out, time.perf_counter() - t0

        # the served batch, traced: K2 and K3 run in the batcher's worker
        # thread, which CUPTI sees as it sees any other
        pnr_cost.anneal_chains.launches = 0
        sim_step.simulate_batch_stepper.launches = 0
        (resps, wall), kern, busy_ms = device_kernels(served)
        served_k = counts()
        stats = svc.metrics.view()
        for (rid, names), resp in zip(SERVE_CLIENTS, resps):
            if not resp.ok or resp.cached:
                fail(f"served {rid}: ok={resp.ok} cached={resp.cached} "
                     f"{resp.error}")
            if resp.record_lines() != solo[rid]:
                fail(f"served {rid}'s records differ from its solo run's")
            for r in resp.records:
                if r != want_row.get((r["pe_name"], r["app"])):
                    fail(f"served record {r['pe_name']}/{r['app']} differs "
                         f"from phase 4's card record")
            if fails_of(resp.failures, names) != fails_of(card_fails, names) \
                    or any(f["stage"] != "schedule" for f in resp.failures):
                fail(f"served {rid}'s failure rows {resp.failures} are not "
                     f"phase 4's schedule rows for {names}")
        served_disp = stats["pnr_dispatch"] + stats["sim_dispatch"]
        if stats["serve.batch_degraded"] or stats["serve.request_errors"] \
                or stats["mine"] or stats["map"]:
            fail(f"the served batch degraded, failed or re-mined: "
                 f"{dict(stats)}")
        if min(served_k) == 0 or sum(served_k) >= sum(solo_k) \
                or any(a > b for a, b in zip(served_k, solo_k)):
            fail(f"served launches (K2, K3) {served_k} against solo "
                 f"{solo_k}: not amortized")
        if (launches_of(kern, "anneal_kernel"),
                launches_of(kern, "sim_stepper_kernel")) != served_k:
            fail(f"the served batch's trace disagrees with the launch "
                 f"counters {served_k}")
        if served_disp >= solo_disp:
            fail(f"served {served_disp} dispatches against {solo_disp} solo")

        # a cache hit: the same content under a new id launches nothing
        rid2, names2 = SERVE_CLIENTS[1]
        apps2 = {n: apps[n] for n in names2}
        k0 = counts()
        hit = loop.run_until_complete(svc.explore("r2-again", apps2, cfg))
        if not (hit.ok and hit.cached) or hit.record_lines() != solo[rid2] \
                or counts() != k0 or hit.elapsed_ms >= 1000:
            fail(f"the cache hit: ok={hit.ok} cached={hit.cached}, "
                 f"launches {k0} -> {counts()}, {hit.elapsed_ms:.1f} ms")

        # the wire: r2 and one malformed line over TCP
        async def wire():
            server = await svc.serve_tcp("127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            try:
                writer.write((json.dumps(encode_request(
                    "wire-1", apps2, cfg)) + "\n").encode())
                writer.write(b'{"this is": "not a request"}\n')
                await writer.drain()
                writer.write_eof()
                return [json.loads(await reader.readline())
                        for _ in range(2)]
            finally:
                writer.close()
                await writer.wait_closed()
                server.close()
                await server.wait_closed()

        by_ok = {d["ok"]: d for d in loop.run_until_complete(wire())}
        if set(by_ok) != {True, False} or by_ok[True]["id"] != "wire-1" \
                or [json.dumps(r) for r in by_ok[True]["records"]] \
                != solo[rid2]:
            fail(f"the TCP round trip: {sorted(by_ok)}")
        loop.run_until_complete(svc.aclose())
    finally:
        loop.run_until_complete(loop.shutdown_default_executor())
        loop.close()
    print(card)
    print(f"served {len(SERVE_CLIENTS)} clients in "
          f"{stats['serve.batches']} batch(es): {wall:.3f} s wall (traced), "
          f"solo runs summed {solo_wall:.3f} s; K2, K3 launches served "
          f"{served_k[0]}, {served_k[1]} against solo {solo_k[0]}, "
          f"{solo_k[1]}; dispatches served {served_disp} against solo "
          f"{solo_disp}; device busy {busy_ms:.2f} ms of the served wall "
          f"({100 * busy_ms / (wall * 1e3):.2f}%); every response == solo "
          f"== phase 4's card records, failure rows "
          f"{fails_of(card_fails, apps)}; cache hit {hit.elapsed_ms:.3f} ms "
          f"with no launch; TCP round trip == solo, malformed line "
          f"answered ok: false", flush=True)
    return {"served_k": served_k, "solo_k": solo_k}


def main() -> int:
    import torch

    # -- 1: the card ------------------------------------------------------
    phase("1 device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.apps import image_graphs, ml_graphs
        from repro_torch.core.mining import MiningConfig
        from repro_torch.explore import ExploreConfig, Explorer
        from repro_torch.fabric import (FabricOptions, FabricSpec,
                                        batch_signature, extract_netlist,
                                        lower)
        from repro_torch.fabric.place import KERNEL_INPUTS, batch_inputs
        from repro_torch.graphir import pattern_from_spec
        from repro_torch.graphir.graph import free_in_ports
        from repro_torch.kernels import (build, gemm, kernel_from_config,
                                         matmul_fused, pe_fused, pnr_cost,
                                         sim_step)
        from repro_torch.kernels.flash_attention import _lib as attention_lib
        from repro_torch.kernels.mamba_scan import _lib as scan_lib
        from repro_torch.kernels.ref import ref_gemm_pe, ref_pe
        from repro_torch.obs import buildprof, disable_tracing, enable_tracing
        from repro_torch.obs.metrics import MetricsRegistry
        from repro_torch.sim import random_inputs, sim_signature
        from repro_torch.sim.cycle import bucket_tensors
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    if any(m == "jax" or m.startswith(("jax.", "repro."))
           for m in sys.modules):
        fail("the port imported JAX or the JAX package")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)
    dev = torch.device("cuda")

    # -- 2: build ---------------------------------------------------------
    phase("2 build")
    sources = sorted(f for f in os.listdir(os.path.join(
        ROOT, "src/repro_torch/kernels/csrc")) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = list(pool.map(build.build, sources))
    print(f"built {len(built)} source(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for src, (lib, report) in zip(sources, built):
        print(f"{src} -> {os.path.relpath(lib, ROOT)}")
        for line in report.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("  " + line.strip())
    pnr_cost._lib()                     # load and type the libraries
    sim_step._lib()
    gemm._lib()
    attention_lib()
    scan_lib()

    # -- 3: front half + kernels vs plain on every signature -------------
    phase("3 front half, kernels vs plain versions")
    options = FabricOptions(spec=FabricSpec(rows=16, cols=16), chains=16,
                            sweeps=32, simulate=True)
    cfg = ExploreConfig(mode="per_app", max_merge=3,
                        mining=MiningConfig(min_support=3,
                                            max_pattern_nodes=6,
                                            time_budget_s=15,
                                            max_patterns_per_level=40),
                        fabric=options)
    apps = image_graphs()
    ex = Explorer(apps, cfg, device="cuda")
    t0 = time.perf_counter()
    mapped = ex.map()
    front = dict(ex._store)             # mined .. mapped, nothing placed
    print(f"front half: {len(mapped)} (variant, app) pairs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if len(mapped) != 16:
        fail(f"expected 16 (variant, app) pairs, got {len(mapped)}")
    groups = {}
    for (pe, app), m in sorted(mapped.items()):
        nl = extract_netlist(m, apps[app], options.spec)
        spec = options.spec.fit(len(nl.pe_cells), len(nl.io_cells))
        p = lower(nl, spec)
        groups.setdefault(batch_signature(p, options.sweeps), []).append(
            ((pe, app), p))
    print(f"{len(groups)} bucket signatures")
    max_err = {"k1": 0.0, "k2": 0.0}
    per_sig = []
    largest = None
    for sig in sorted(groups):
        items = groups[sig]
        probs = [p for _, p in items]
        inputs = batch_inputs(
            probs, chains=options.chains, seed=options.seed,
            sweeps=options.sweeps,
            nonces=[zlib.crc32(f"{pe}:{app}".encode()) for (pe, app), _ in
                    items])
        d = {k: v.to(dev) for k, v in inputs.items()}
        args = [d[k] for k in KERNEL_INPUTS]
        pnc0_plain = pnr_cost.net_hpwl_rows_plain(
            d["prob"], d["slot0"], d["slot_xy"], d["net_pins"],
            d["net_mask"])
        errs = k2_vs_plain(d, f"signature {sig}")
        max_err["k1"] = max(max_err["k1"], errs[0])
        max_err["k2"] = max(max_err["k2"], errs[1])
        k2_ms = cuda_ms(lambda: pnr_cost.anneal_chains(*args), 2)
        pairs = [f"{pe}/{app}" for (pe, app), _ in items]
        per_sig.append((sig, pairs, k2_ms))
        print(f"  {'x'.join(map(str, sig))}: {pairs} K2's starting costs "
              f"(K1) == plain, K2 delta/full/telemetry == plain; K2 "
              f"{k2_ms:.4f} ms "
              f"({1e3 * k2_ms / sig[0]:.4f} us a step)", flush=True)
        if largest is None or sig[0] > largest[0][0]:
            largest = (sig, d, pnc0_plain)

    k2_sum = sum(x[2] for x in per_sig)
    print(f"K2 summed over the {len(per_sig)} signatures (one launch each "
          f"on the main path): {k2_sum:.4f} ms", flush=True)

    # K3 on every sim signature: the pairs placed on a copy of the front,
    # so the main path below still places and simulates everything itself
    k_it, b_rows = options.sim_iterations, options.sim_batch
    ex3 = Explorer(apps, cfg, store=dict(front), device="cuda")
    t0 = time.perf_counter()
    progs = ex3.schedule()
    print(f"placed and scheduled {len(progs)} programs in "
          f"{time.perf_counter() - t0:.1f} s; schedule failures "
          f"{[(f.pe_name, f.app, f.error_type) for f in ex3.failures]}",
          flush=True)
    sim_groups = {}
    for (pe, app), prog in sorted(progs.items()):
        sim_groups.setdefault(sim_signature(prog, k_it, b_rows), []).append(
            ((pe, app), prog))
    print(f"{len(sim_groups)} sim signatures")
    max_err["k3"] = 0.0
    largest_sim, k3_sum, k3_wrap_sum = None, 0.0, 0.0
    for sig in sorted(sim_groups, key=lambda s: (s[8], s[0], s[4])):
        items = sim_groups[sig]
        arrs = [random_inputs(p, k_it, b_rows, seed=options.input_seed(
            zlib.crc32(f"{pe}:{app}".encode()))) for (pe, app), p in items]
        tabs, x, op_ids = bucket_tensors([p for _, p in items], arrs, sig,
                                         dev)
        kw = dict(cycles=sig[8], latch_depth=sig[9])
        want = sim_step.simulate_batch_plain(tabs, x, op_ids, **kw)
        for force_global in (False, True):
            got = sim_step.simulate_batch_stepper(
                tabs, x, op_ids, force_global=force_global, **kw)
            torch.cuda.synchronize()
            if not same_bits(got, want):
                fail(f"K3 (global={force_global}) differs from its plain "
                     f"version at {sig}")
            max_err["k3"] = max(max_err["k3"],
                                float((got - want).abs().max()))
        # the kernel alone, then with the wrapper's host work (checks,
        # event lists, buffers)
        prep = sim_step.prepare_stepper(tabs, x, op_ids, **kw)
        k3_ms = cuda_ms(lambda: sim_step.launch_stepper(prep), 3)
        k3_wrap = cuda_ms(lambda: sim_step.simulate_batch_stepper(
            tabs, x, op_ids, **kw), 3)
        state = sim_step.stepper_state_bytes(*sig[:7], sig[9])
        pairs = [f"{pe}/{app}" for (pe, app), _ in items]
        k3_sum += k3_ms
        k3_wrap_sum += k3_wrap
        print(f"  {'x'.join(map(str, sig))}: {pairs} K3 shared/global == "
              f"plain; state {state} B; K3 {k3_ms:.4f} ms "
              f"({1e3 * k3_ms / sig[8]:.3f} us a cycle), with its "
              f"wrapper's host work {k3_wrap:.4f} ms", flush=True)
        # signatures run in ascending (cycles, tiles, wires): keep the last
        largest_sim = (sig, [p for _, p in items], tabs, x, op_ids)
    print(f"K3 summed over the {len(sim_groups)} sim signatures: "
          f"{k3_sum:.4f} ms, with its wrapper's host work {k3_wrap_sum:.4f} "
          f"ms", flush=True)

    # -- 4: the main path, counted ----------------------------------------
    phase("4 main path: Explorer.run() on the card vs pnr, schedule and "
          "simulate on the CPU")

    def traced_run(explorer):
        tracer = enable_tracing()
        t0 = time.perf_counter()
        try:
            out = explorer.run()
        finally:
            disable_tracing()
        wall = time.perf_counter() - t0
        stages = {}
        for sp, _depth, _path in tracer.iter_spans():
            if sp.name in ("pnr", "schedule", "simulate", "sim.dispatch"):
                stages[sp.name] = stages.get(sp.name, 0.0) + sp.dur
        return out, wall, stages

    # the run traced by torch.profiler: every device kernel it launched,
    # by name; K1 (the Pallas _hpwl_kernel's port was net_hpwl_kernel) is
    # counted there, as every launch of a kernel whose name holds "hpwl"
    pnr_cost.anneal_chains.launches = 0
    sim_step.simulate_batch_stepper.launches = 0
    (res, gpu_wall, gpu_stages), kern, busy_ms = device_kernels(
        lambda: traced_run(ex))
    launches = {"k1": sum(len(v) for k, v in kern.items() if "hpwl" in k),
                "k2": pnr_cost.anneal_chains.launches,
                "k3": sim_step.simulate_batch_stepper.launches}
    ours = {name: launches_of(kern, name) for name in source_kernels()}
    rows = [r.to_dict() for r in res.records()]
    buckets = {b for b in res.sim_buckets.values() if b}
    print(f"Explorer.run() on cuda (traced by torch.profiler): "
          f"{gpu_wall:.2f} s wall; stage walls (s) "
          f"{ {k: round(v, 3) for k, v in gpu_stages.items()} }; "
          f"{ex.stats['pnr_dispatch']} pnr dispatches, "
          f"{ex.stats['sim_dispatch']} sim dispatches, launches {launches}; "
          f"the trace holds {sum(len(v) for v in kern.values())} device "
          f"activities of {len(kern)} names, of this repository's kernels "
          f"{ {k: v for k, v in ours.items() if v} }; the device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / (gpu_wall * 1e3):.2f}% of "
          f"the wall)", flush=True)
    if ours["anneal_kernel"] != launches["k2"] \
            or ours["sim_stepper_kernel"] != launches["k3"]:
        fail(f"the profiler's trace ({ours}) disagrees with the launch "
             f"counters ({launches})")
    if launches["k1"] or any(v for k, v in ours.items() if k not in (
            "anneal_kernel", "sim_stepper_kernel")):
        fail(f"the main path launched K1 or a kernel off its path: "
             f"{launches}, {ours}")
    if launches["k2"] == 0:
        fail(f"the main path skipped a kernel: launches {launches}")
    if not (launches["k3"] == ex.stats["sim_dispatch"] == len(buckets) > 0):
        fail(f"K3 launched {launches['k3']} times for {len(buckets)} sim "
             f"buckets ({ex.stats['sim_dispatch']} dispatches)")
    if any(f.stage != "schedule" for f in res.failures):
        fail(f"cuda run degraded: {[f.to_dict() for f in res.failures]}")
    sims = [r for r in rows if r["sim_bucket"]]
    if len(rows) != 16 or len(sims) != 16 - len(res.failures) or not all(
            r["fabric_wirelength"] > 0 and r["fabric_energy_per_op_pj"] > 0
            and all(v == v and abs(v) != float("inf")
                    for v in r.values() if isinstance(v, float))
            for r in rows):
        fail("cuda records are incomplete or not finite")
    if not all(r["sim_verified"] == 1 and r["sim_ii"] >= r["sim_min_ii"] > 0
               for r in sims):
        fail("a simulated pair is not golden-verified against the "
             "interpreter")
    card_pnrs = ex.pnr()                # memo hits: the card's placements
    ex_cpu = Explorer(apps, cfg, store=ex._store, device="cpu")
    ex_cpu.forget("pnr", "sched", "sim")
    res_cpu, cpu_wall, cpu_stages = traced_run(ex_cpu)
    print(f"Explorer.run() on cpu (plain versions): {cpu_wall:.2f} s wall; "
          f"stage walls (s) "
          f"{ {k: round(v, 3) for k, v in cpu_stages.items()} }", flush=True)
    if [r.to_dict() for r in res_cpu.records()] != rows:
        fail("records on cuda differ from the cpu rerun")
    if res_cpu.sim_buckets != res.sim_buckets:
        fail("sim buckets on cuda differ from the cpu rerun")
    if [f.to_dict() for f in res_cpu.failures] \
            != [f.to_dict() for f in res.failures]:
        fail("failure rows on cuda differ from the cpu rerun")
    if ex_cpu.stats["mine"] or ex_cpu.stats["map"]:
        fail("the cpu rerun re-mined: the front half must be shared")
    fails = [(f.stage, f.pe_name, f.app, f.error_type)
             for f in res.failures]
    print(f"{len(rows)} records ({len(sims)} simulated and golden-verified, "
          f"{len(buckets)} sim buckets), failure rows {fails} identical on "
          f"cuda and cpu")
    print(res.table())
    cpu_pnrs = ex_cpu.pnr()

    # -- 5: kernel times and bounds at the largest signature ---------------
    phase("5 kernel timing")
    sig, d, pnc0 = largest
    k1_args = (d["prob"], d["slot0"], d["slot_xy"], d["net_pins"],
               d["net_mask"])
    r_n, e_n = d["slot0"].shape
    n_n, d_n = d["net_pins"].shape[1:]
    # K1's function is K2's prologue: K2 with zero steps stages the tables,
    # scores the start and writes it out as the best placement
    zero = {k: (v[:, :0].contiguous() if k in ("a", "t", "log_u", "temps",
                                                "active") else v)
            for k, v in d.items()}
    args0 = [zero[k] for k in KERNEL_INPUTS]
    pro = torch.full_like(pnc0, -1.0)
    out0 = pnr_cost.anneal_chains(*args0, pnc0_out=pro)
    torch.cuda.synchronize()
    if not (torch.equal(pro, pnc0) and torch.equal(out0[0], d["slot0"])
            and torch.equal(out0[1], pnc0.sum(dim=1))):
        fail("K2 with zero steps does not return its start")
    # the kernel alone (its device time in the profiler's trace) and with
    # its wrapper (the pin table and the outputs; CUDA events)
    reps = 20
    _, kern0, _ = device_kernels(lambda: [
        pnr_cost.anneal_chains(*args0, pnc0_out=pro) for _ in range(reps)])
    k1_times = [t for k, v in kern0.items() if "anneal_kernel" in k
                for t in v]
    if len(k1_times) != reps:
        fail(f"the profiler traced {len(k1_times)} launches of K2 with zero "
             f"steps for {reps}")
    k1_ms = sum(k1_times) / reps
    k1_wrap = cuda_ms(lambda: pnr_cost.anneal_chains(*args0, pnc0_out=pro),
                      reps)
    k1_plain = cuda_ms(lambda: pnr_cost.anneal_chains_plain(
        *args0, pnc0_out=pro), 5)
    k1_plain_costs = cuda_ms(
        lambda: pnr_cost.net_hpwl_rows_plain(*k1_args), 5)
    # what that launch must move: the problems' tables as the kernel reads
    # them (pin table, slot coordinates, ent_nets), the chains' start, and
    # the starting costs, slots and cost it writes; its operations are the
    # prologue's (K1's: 4 a pin, 3 a net)
    tab = pnr_cost.pin_table(d["net_pins"], d["net_mask"])
    k1_pins = int(d["net_mask"][d["prob"].long()].sum())
    k1_bytes = nbytes(d["prob"], d["slot_xy"], tab, d["ent_nets"],
                      d["slot0"], pnc0) + r_n * (e_n * 4 + 4)
    k1_ops = 4 * k1_pins + 3 * r_n * n_n
    args = [d[k] for k in KERNEL_INPUTS]
    k2_ms = cuda_ms(lambda: pnr_cost.anneal_chains(*args), 3)
    k2_steps = d["a"].shape[1]
    print(f"K2 at {'x'.join(map(str, sig))}: {k2_ms:.4f} ms, "
          f"{1e3 * k2_ms / k2_steps:.4f} us a step; with zero steps (staging, "
          f"the prologue, which computes K1's function, and writing the "
          f"start out) {k1_ms:.4f} ms alone (torch.profiler), {k1_wrap:.4f} "
          f"ms with its wrapper, {k1_plain:.4f} ms plain (the starting "
          f"costs alone {k1_plain_costs:.4f} ms); summed over the main "
          f"path's {launches['k2']} launches {k2_sum:.4f} ms", flush=True)
    if launches["k2"] != len(per_sig):
        fail(f"K2 launched {launches['k2']} times on the main path for "
             f"{len(per_sig)} bucket signatures")
    work = {}
    t0 = time.perf_counter()
    pnr_cost.anneal_chains_plain(*args, work=work)
    torch.cuda.synchronize()
    k2_plain = (time.perf_counter() - t0) * 1e3
    k2_bytes = nbytes(*args) + r_n * (e_n * 4 + 4)
    k2_ops = 4 * work["pins"] + 5 * work["nets"] + 4 * work["steps"]

    # K3 at the largest sim signature (the default 3 iterations x 2 rows),
    # and again at a larger input batch over the same programs
    ssig, sprogs, tabs, x, op_ids = largest_sim
    kw = dict(cycles=ssig[8], latch_depth=ssig[9])
    # the kernel alone (launch_stepper), state in shared and in global
    # memory, full and empty cycles (the floor: barriers and event walks)
    k3_t = {}
    for fl in (False, True):
        for fg in (False, True):
            prep = sim_step.prepare_stepper(tabs, x, op_ids, floor=fl,
                                            force_global=fg, **kw)
            k3_t[fl, fg] = cuda_ms(lambda: sim_step.launch_stepper(prep), 20)
    k3_ms, k3_global_ms = k3_t[False, False], k3_t[False, True]
    k3_floor, k3_floor_global = k3_t[True, False], k3_t[True, True]
    k3_wrap = cuda_ms(lambda: sim_step.simulate_batch_stepper(
        tabs, x, op_ids, **kw), 20)
    k3_plain = cuda_ms(lambda: sim_step.simulate_batch_plain(
        tabs, x, op_ids, **kw), 2)
    k3_bytes = nbytes(*tabs.values(), x, op_ids) \
        + x.shape[0] * x.shape[1] * x.shape[2] * ssig[7] * 4
    # one ALU operation per active micro-op slot, every cycle and row
    k3_ops = ssig[8] * x.shape[1] * sum(p.n_inst * p.n_steps for p in sprogs)
    bsig = sim_signature(sprogs[0], BIG_ITERS, BIG_BATCH)
    bprogs = [p for p in sprogs
              if sim_signature(p, BIG_ITERS, BIG_BATCH) == bsig]
    barrs = [random_inputs(p, BIG_ITERS, BIG_BATCH, seed=i)
             for i, p in enumerate(bprogs)]
    btabs, bx, bops = bucket_tensors(bprogs, barrs, bsig, dev)
    bkw = dict(cycles=bsig[8], latch_depth=bsig[9])
    bprep = sim_step.prepare_stepper(btabs, bx, bops, **bkw)
    k3_big_ms = cuda_ms(lambda: sim_step.launch_stepper(bprep), 5)
    big_got = sim_step.simulate_batch_stepper(btabs, bx, bops, **bkw)
    big_want = sim_step.simulate_batch_plain(btabs, bx, bops, **bkw)
    torch.cuda.synchronize()
    if not same_bits(big_got, big_want):
        fail(f"K3 differs from its plain version at {bsig}")
    cyc = ssig[8]
    print(f"K3 at {'x'.join(map(str, ssig))} ({len(sprogs)} program(s), "
          f"{sim_step.stepper_state_bytes(*ssig[:7], ssig[9])} B state, "
          f"{cyc} cycles): {k3_ms:.4f} ms ({1e3 * k3_ms / cyc:.3f} us a "
          f"cycle) with its state in shared memory, {k3_global_ms:.4f} ms "
          f"({1e3 * k3_global_ms / cyc:.3f} us) in global memory; empty "
          f"cycles (the floor) {k3_floor:.4f} ms "
          f"({1e3 * k3_floor / cyc:.3f} us a cycle), {k3_floor_global:.4f} "
          f"ms in global memory; bytes bound "
          f"{k3_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms; with the wrapper's "
          f"host work {k3_wrap:.4f} ms; plain {k3_plain:.1f} "
          f"ms; at sim_batch={BIG_BATCH}, sim_iterations={BIG_ITERS} "
          f"({'x'.join(map(str, bsig))}): {k3_big_ms:.4f} ms, == plain",
          flush=True)

    # -- 6: the fused-PE path: ML-suite PEs on K4, MAC + epilogue on K5 ---
    phase("6 fused-PE path: ML-suite configurations through K4, "
          "matmul + PE epilogue through K5")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is on: the plain K5 "
             "product would not be float32")
    # benchmarks/common.py BENCH_MINING, benchmarks/fig11_ml_pe.py
    bench_mining = MiningConfig(min_support=4, max_pattern_nodes=8,
                                time_budget_s=45, max_patterns_per_level=60)
    t0 = time.perf_counter()
    ml = Explorer(ml_graphs(), ExploreConfig(
        mode="domain", mining=bench_mining, per_app_subgraphs=2,
        domain_name="PE_ML"), device="cuda")
    ml_runs = [ml.run(), ml.with_config(mode="per_app", max_merge=3).run()]
    variants = [v for r in ml_runs for dse in r.results.values()
                for v in dse.variants]
    configs = [(v.name, c, v.datapath) for v in variants
               for c in sorted(v.datapath.configs)]
    print(f"ML-suite front half: {len(variants)} variants, {len(configs)} "
          f"configurations in {time.perf_counter() - t0:.1f} s", flush=True)
    shape = (TOKENS, D_FF)
    gen = torch.Generator(device=dev).manual_seed(15)
    n_max = max(len(free_in_ports(dp.configs[c].pattern))
                for _, c, dp in configs)
    pool = [torch.rand(shape, generator=gen, device=dev) * 3 - 1.5
            for _ in range(n_max)]
    x5 = torch.randn((TOKENS, D_MODEL), generator=gen, device=dev)
    w5 = torch.randn((D_MODEL, D_FF), generator=gen, device=dev) \
        / D_MODEL ** 0.5                    # a layer's initialisation
    bias = torch.randn((D_FF,), generator=gen, device=dev) * 0.1
    skip = torch.randn(shape, generator=gen, device=dev)
    relu_tail = [("add", (-1, -1)), ("const", ()), ("max", (0, 1))]
    conv_tail = pattern_from_spec(relu_tail)      # apps/mlkernels.py Conv
    block_tail = pattern_from_spec(relu_tail)     # apps/mlkernels.py Block
    k5_cases = {
        "a": ((), dict()),
        "b": ((bias,), dict(epilogue=conv_tail, extra_kinds=("vec",))),
        "c": ((skip,), dict(epilogue=block_tail, extra_kinds=("full",))),
        "d": ((bias,), dict(epilogue=conv_tail, extra_kinds=("vec",),
                            out_dtype=torch.bfloat16)),
    }

    def max_diff(got, want) -> float:
        got, want = got.double(), want.double()
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        return float(torch.where(same, 0.0, (got - want).abs()).max())

    # every Triton JIT specialisation of K4 in this phase, recorded by
    # buildprof: one for each distinct (pattern, dtype) launched
    k4_builds = MetricsRegistry()
    buildprof.enable(registry=k4_builds)
    pe_fused.pe_apply.launches = 0
    gemm.gemm_pe.launches = 0
    applied, refused, k4_err = 0, [], 0.0
    distinct = {}
    for vname, cname, dp in configs:
        pat = dp.configs[cname].pattern
        try:
            fn = kernel_from_config(dp, cname)
        except ValueError as e:          # the reference refuses it too
            refused.append((vname, cname, str(e)))
            continue
        xs = pool[:len(free_in_ports(pat))]
        got = fn(*xs)
        applied += 1
        want = pe_fused.pe_apply_plain(pat, *xs)
        for g, w in zip(*[o if isinstance(o, tuple) else (o,)
                          for o in (got, want)]):
            if not bool(torch.isclose(g, w, rtol=K4_TOL, atol=K4_TOL,
                                      equal_nan=True).all()):
                fail(f"K4 differs from its plain version on {vname}/{cname}")
            k4_err = max(k4_err, max_diff(g, w))
        distinct.setdefault(pe_fused.lower_pattern(pat).key,
                            (f"{vname}/{cname}", pat))
    k5_out = {}
    for case, (extras, kw) in k5_cases.items():
        k5_out[case] = matmul_fused(x5, w5, *extras, **kw)
    torch.cuda.synchronize()
    launches["k4"] = pe_fused.pe_apply.launches
    launches["k5"] = gemm.gemm_pe.launches
    print(f"K4 applied {applied} configurations ({len(distinct)} distinct "
          f"patterns), each == plain at {K4_TOL}; refused {len(refused)} "
          f"as the reference does: {refused}; launches "
          f"{ {k: launches[k] for k in ('k4', 'k5')} }", flush=True)
    if launches["k4"] != applied or applied == 0:
        fail(f"K4 launched {launches['k4']} times for {applied} "
             f"configurations")
    if launches["k5"] != len(k5_cases):
        fail(f"K5 launched {launches['k5']} times for {len(k5_cases)} "
             f"matmuls")
    k5_err = 0.0
    for case, (extras, kw) in k5_cases.items():
        got = k5_out[case]
        want = gemm.gemm_pe_plain(x5, w5, *extras, **kw)
        if got.shape != shape or got.dtype != want.dtype:
            fail(f"K5 ({case}) returned {got.dtype} {tuple(got.shape)}")
        d = (got.double() - want.double()).abs()
        lim = K5_TOL * want.double().abs().clamp(min=1.0)
        if case == "d":
            # float32 sums that differ in the last bits can round to
            # neighbouring bfloat16 values, 2^(e-7) apart in [2^e, 2^(e+1)):
            # allow that step where it is wider than 1e-4 * |plain|; the
            # kernel's own float32 result (b) rounds to (d) exactly
            step = torch.exp2(torch.floor(torch.log2(
                want.double().abs().clamp(min=2.0 ** -126))) - 7)
            lim = torch.maximum(lim, step)
            if not torch.equal(got, k5_out["b"].to(torch.bfloat16)):
                fail("K5 (d) is not K5 (b) rounded to bfloat16")
        if not bool((d <= lim).all()) or not bool(torch.isfinite(got).all()):
            fail(f"K5 ({case}) differs from its plain version: max |diff| "
                 f"{float(d.max())}")
        if case != "d":
            k5_err = max(k5_err, float(d.max()))
    print(f"K5 (a)-(d) == plain within 1e-4 * max(1, |plain|); max |diff| "
          f"{k5_err}", flush=True)

    # outside the counted run: bfloat16 once per distinct pattern, and
    # both kernels against the float64 oracles on small inputs
    small = torch.rand((64, 128), generator=gen, device=dev) * 3 - 1.5
    for key, (label, pat) in sorted(distinct.items()):
        n_in = len(free_in_ports(pat))
        xs = [x.to(torch.bfloat16) for x in pool[:n_in]]
        got = pe_fused.make_pe_kernel(pat)(*xs)
        want = pe_fused.pe_apply_plain(pat, *xs)
        filled = pat.copy()          # mined constants carry no value:
        for n, op in filled.nodes.items():     # the kernels bake 0.0
            if op == "const" and filled.attr(n, "value") is None:
                filled.attrs.setdefault(n, {})["value"] = 0.0
        oracle = ref_pe(filled, *[small * (i + 1) / n_in
                                  for i in range(n_in)])
        got_small = pe_fused.make_pe_kernel(pat)(
            *[small * (i + 1) / n_in for i in range(n_in)])
        for g, w in zip(*[o if isinstance(o, tuple) else (o,)
                          for o in (got, want)]):
            if not bool(torch.isclose(g.float(), w.float(), rtol=K4_BF16_TOL,
                                      atol=K4_BF16_TOL, equal_nan=True).all()):
                fail(f"K4 in bfloat16 differs from its plain version on "
                     f"{label}")
        for g, w in zip(*[o if isinstance(o, tuple) else (o,)
                          for o in (got_small, oracle)]):
            w = torch.as_tensor(w, device=dev).double().expand(g.shape)
            if not bool(torch.isclose(g.double(), w, rtol=K4_TOL,
                                      atol=K4_TOL, equal_nan=True).all()):
                fail(f"K4 differs from the float64 oracle on {label}")
    xs5, ws5 = x5[:100, :70], w5[:70, :50]
    for extras, kw in ((), {}), ((bias[:50],), k5_cases["b"][1]), \
            ((skip[:100, :50],), k5_cases["c"][1]):
        got = matmul_fused(xs5, ws5, *extras, **kw)
        want = ref_gemm_pe(xs5.cpu(), ws5.cpu(),
                           *[e.cpu() for e in extras], **kw)
        if not torch.allclose(got.cpu(), want, rtol=K5_TOL, atol=K5_TOL):
            fail("K5 differs from the float64 oracle at 100x70x50")
    print(f"K4 in bfloat16 == plain at {K4_BF16_TOL} on {len(distinct)} "
          f"patterns; K4 and K5 == float64 oracles on small inputs",
          flush=True)

    # times: K4 at the largest and the median distinct pattern
    def pe_size(item):
        prog = pe_fused.lower_pattern(item[1])
        return (prog.n_in + len(prog.outs), prog.n_compute, item[0])

    ranked = sorted(distinct.values(), key=pe_size)
    numel = pool[0].numel()

    def library_call(prog, xs):
        """One torch call computing the pattern, where there is one: a
        binary op or mul -> add over the inputs (torch.addcmul)."""
        body = [(st.op, st.args) for st in prog.stmts]
        one = {"add": torch.add, "mul": torch.mul, "max": torch.maximum}
        if len(body) == 1 and body[0][0] in one \
                and body[0][1] == ("p0", "p1"):
            return lambda: one[body[0][0]](xs[0], xs[1])
        if [op for op, _ in body] == ["mul", "add"] \
                and body[0][1] == ("p0", "p1") \
                and body[1][1] == (prog.stmts[0].dst, "p2"):
            return lambda: torch.addcmul(xs[2], xs[0], xs[1])
        return None

    k4_rows = []
    for which, (label, pat) in (("largest", ranked[-1]),
                                ("median", ranked[len(ranked) // 2])):
        prog = pe_fused.lower_pattern(pat)
        xs = pool[:prog.n_in]
        fn = pe_fused.make_pe_kernel(pat)
        ms = cuda_ms(lambda: fn(*xs), 20)
        plain_ms = cuda_ms(lambda: pe_fused.pe_apply_plain(pat, *xs), 5)
        lib = library_call(prog, xs)
        lib_ms = cuda_ms(lib, 20) if lib else None
        k4_bytes = (prog.n_in + len(prog.outs)) * 4 * numel
        k4_ops = prog.n_compute * numel
        k4_rows.append((which, label, prog, ms, plain_ms, lib_ms, k4_bytes,
                        k4_ops))
        print(f"K4 at the {which} pattern {label} ({prog.n_in} in, "
              f"{len(prog.outs)} out, {prog.n_compute} ops, "
              f"{[s.op for s in prog.stmts]}): {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; "
              f"{k4_bytes} bytes", flush=True)

    buildprof.disable()
    # float32 at (4096, 8192) and (64, 128), both with n % 16 == 0 (one
    # specialisation), and bfloat16, for every distinct Triton rendering
    renderings = {pe_fused.triton_source(pe_fused.lower_pattern(pat))
                  for _, pat in distinct.values()}
    k4_jit = k4_builds.counter("kernels.compile.triton")
    print(f"buildprof: {k4_jit} Triton specialisations of K4 in "
          f"{k4_builds.histogram('kernels.compile.secs').total:.2f} s for "
          f"{len(renderings)} distinct renderings ({len(distinct)} "
          f"patterns) x (float32, bfloat16)", flush=True)
    if k4_jit != 2 * len(renderings) \
            or k4_builds.counter("kernels.compile.events") != k4_jit:
        fail(f"buildprof counted {k4_builds.counters('kernels.compile')} "
             f"for {len(renderings)} distinct renderings in two dtypes")

    k5_ms = {}
    for case in ("a", "b", "c"):
        extras, kw = k5_cases[case]
        k5_ms[case] = cuda_ms(lambda: matmul_fused(x5, w5, *extras, **kw),
                              10)
    k5_plain = cuda_ms(lambda: gemm.gemm_pe_plain(x5, w5), 10)
    k5_lib = cuda_ms(lambda: torch.matmul(x5, w5), 10)
    k5_ops = 2 * TOKENS * D_MODEL * D_FF
    k5_bytes = nbytes(x5, w5) + TOKENS * D_FF * 4
    print(f"K5 at {TOKENS}x{D_MODEL}x{D_FF}: (a) {k5_ms['a']:.4f} ms "
          f"({k5_ops / k5_ms['a'] / 1e9:.2f} TFLOP/s of float32 product, "
          f"{3 * k5_ops / k5_ms['a'] / 1e9:.2f} of TF32 tensor-core work), "
          f"(b) {k5_ms['b']:.4f} ms, (c) {k5_ms['c']:.4f} ms; plain (a) "
          f"{k5_plain:.4f} ms; torch.matmul {k5_lib:.4f} ms", flush=True)
    if k5_ms["a"] >= k5_lib:
        fail(f"K5 ({k5_ms['a']:.4f} ms) is not faster than torch.matmul "
             f"({k5_lib:.4f} ms)")

    # -- 7: the attention / selective-scan boundary at model widths -------
    p7 = attention_scan_phase(dev, launches)

    # -- 8: hierarchical placement at mega-fabric size -------------------
    p8 = hier_phase(dev)

    # -- 9: serving on the card, and the rest of observability -----------
    phase("9 serving on the card: four overlapping clients through "
          "repro_torch.serve; analyze_pnr and buildprof")
    skip = {(f.pe_name, f.app) for f in res.failures}
    analyze_check(card_pnrs, cpu_pnrs, skip)
    buildprof_nvcc_check()
    p9 = serve_phase(apps, cfg, front, rows,
                     [f.to_dict() for f in res.failures], card)

    # -- 10: the kernels line ---------------------------------------------
    phase("10 the kernels line")
    def bound(b, ops, peak=FP32_OPS_PER_S):
        t_b, t_o = b / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    kernels = []
    for name, src, repl, n, err, ms, plain_ms, b, ops in (
            ("anneal_kernel with zero steps (K1, folded into K2's "
             "prologue)", "pnr_anneal.cu",
             "src/repro/kernels/pnr_cost.py:108", launches["k1"],
             max_err["k1"], k1_ms, k1_plain, k1_bytes, k1_ops),
            ("anneal_kernel (K2)", "pnr_anneal.cu",
             "src/repro/kernels/pnr_cost.py:185", launches["k2"],
             max_err["k2"], k2_ms, k2_plain, k2_bytes, k2_ops),
            ("sim_stepper_kernel (K3)", "sim_step.cu",
             "src/repro/kernels/sim_step.py:144", launches["k3"],
             max_err["k3"], k3_ms, k3_plain, k3_bytes, k3_ops)):
        b_ms, by = bound(b, ops)
        kernels.append({"name": name, "route": "cuda", "source": CSRC + src,
                        "replaces": repl, "launches": n, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": by, "library_ms": None})
    # K1's row times K2 launched with zero steps: staging, the prologue
    # (K1's function) and writing the start out, the kernel alone; its
    # launches are the profiler's count of K1 on the main path
    kernels[0]["timed"] = ("anneal_kernel with zero steps and pnc0_out: "
                           "staging, the prologue and writing the start "
                           "out; ms alone (torch.profiler), wrapper_ms with "
                           "its wrapper, launches counted in the main "
                           "path's trace")
    kernels[0]["wrapper_ms"] = k1_wrap
    # K3's ms is its launch alone; with the wrapper's host work (checks,
    # event lists, buffers), as the main path pays it:
    kernels[2]["wrapper_ms"] = k3_wrap
    # K2's and K3's launches on the second path into them: the served
    # batch of phase 9
    kernels[1]["serve_launches"], kernels[2]["serve_launches"] = \
        p9["served_k"]
    _, _, prog, ms, plain_ms, lib_ms, b, ops = k4_rows[0]
    b_ms, by = bound(b, ops)
    kernels.append({"name": "pe_kernel (K4)", "route": "triton",
                    "source": "src/repro_torch/kernels/pe_fused.py",
                    "replaces": "src/repro/kernels/pe_fused.py:71",
                    "launches": launches["k4"], "max_abs_err": k4_err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": by, "library_ms": lib_ms})
    # the function's own operations at the tensor cores' TF32 rate; the
    # three TF32 products K5 does for each float32 one are its cost, not
    # the function's, and are printed apart as a share of that work
    b_ms, by = bound(k5_bytes, k5_ops, TF32_OPS_PER_S)
    tf32_ms = bound(k5_bytes, 3 * k5_ops, TF32_OPS_PER_S)[0]
    print(f"K5 (a): {k5_ms['a']:.4f} ms against a bound of {b_ms:.4f} ms "
          f"({by}, 2MNK at 495 TFLOP/s: {100 * b_ms / k5_ms['a']:.1f}%); "
          f"its 3xTF32 tensor-core work alone takes {tf32_ms:.4f} ms at that "
          f"rate ({100 * tf32_ms / k5_ms['a']:.1f}% of its time)")
    kernels.append({"name": "gemm_pe_kernel (K5)", "route": "cuda",
                    "source": CSRC + "gemm_pe.cu",
                    "replaces": "src/repro/kernels/gemm.py:51",
                    "launches": launches["k5"], "max_abs_err": k5_err,
                    "ms": k5_ms["a"], "plain_ms": k5_plain, "bound_ms": b_ms,
                    "bound_by": by, "library_ms": k5_lib})
    k6_rows = p7["k6_rows"]
    k7_ms, k7_plain = p7["k7_ms"], p7["k7_plain"]
    k7_bytes, k7_ops = p7["k7_bytes"], p7["k7_ops"]
    ms, plain_ms, lib_ms, b, ops, peak, _ = k6_rows["a"]
    b_ms, by = bound(b, ops, peak)
    kernels.append({"name": "flash_attention_kernel (K6)", "route": "cuda",
                    "source": CSRC + "flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention.py:29",
                    "launches": launches["k6"], "max_abs_err": p7["k6_err"],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": by, "library_ms": lib_ms})
    b_ms, by = bound(k7_bytes, k7_ops)
    kernels.append({"name": "mamba_scan_kernel (K7)", "route": "cuda",
                    "source": CSRC + "mamba_scan.cu",
                    "replaces": "src/repro/kernels/mamba_scan.py:24",
                    "launches": launches["k7"], "max_abs_err": p7["k7_err"],
                    "ms": k7_ms, "plain_ms": k7_plain, "bound_ms": b_ms,
                    "bound_by": by, "library_ms": None})
    for case, (ms, plain_ms, lib_ms, b, ops, peak, pairs) in k6_rows.items():
        b_ms, by = bound(b, ops, peak)
        split = "" if peak == BF16_OPS_PER_S else (
            f"; its 3xTF32 work alone {3 * ops / peak * 1e3:.4f} ms")
        lib = "none" if lib_ms is None else (
            f"{lib_ms:.4f} ms ({p7['sdpa_backend'][case]}), K6 at "
            f"{ms / lib_ms:.2f}x its time")
        print(f"K6 ({case}): {ms:.4f} ms against a bound of {b_ms:.4f} ms "
              f"({by}, 4·D a pair at {peak / 1e12:.0f} TFLOP/s: "
              f"{100 * b_ms / ms:.1f}% of it{split}; one expf a pair on "
              f"the SFUs {pairs / SFU_PER_S * 1e3:.4f} ms), plain "
              f"{plain_ms:.4f} ms, scaled_dot_product_attention {lib}")
    b_ms, by = bound(k7_bytes, k7_ops)
    print(f"K7: {k7_ms:.4f} ms against a bound of {b_ms:.4f} ms ({by}), "
          f"plain {k7_plain:.4f} ms, library none")
    print(f"K1/K2 timed at signature {'x'.join(map(str, sig))} "
          f"(R={r_n} chains, E={e_n}, N={n_n}, D={d_n}); K2 work {work}; "
          f"K3 work {k3_ops} ALU operations, {k3_bytes} bytes")
    for row in kernels:
        if row["ms"] < row["bound_ms"]:
            fail(f"{row['name']} reads {row['ms']} ms, below its bound of "
                 f"{row['bound_ms']} ms: the bound is miscounted")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
