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
   bucket signature, and on every signature check the batched-HPWL kernel
   (K1) and the annealing kernel (K2: delta, full and telemetry) against
   their plain versions on the card — slots, costs, accept counts and cost
   curves bit-equal; then place, route and schedule every pair on a copy
   of the front, group the programs by sim signature, and on every one
   check the cycle stepper (K3, shared-memory and global-memory forms)
   against its plain version on the card, outputs bit-equal;
4. run the Explorer to the end on the card with the launch counters set
   to 0 just before, read them just after, then rerun pnr, schedule and
   simulate on the CPU over the same mined and mapped front (one store,
   ``forget("pnr", "sched", "sim")``) and require identical records,
   sim buckets and failure rows, every simulated pair golden-verified,
   K1/K2 launched and K3 launched once per sim bucket;
5. time each kernel and its plain version with CUDA events at the main
   path's largest signature (camera on PE1), K3 also at a larger input
   batch;
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
   largest and the median distinct pattern and K5 on the first three
   epilogues;
7. the attention and selective-scan boundary at the widths of three
   configurations the repository carries: with the launch counters set to
   0 just before and read just after, ``attention`` (K6) at Llama 3.2 1B
   (32 query heads, 8 kv heads, head dim 64, 4096 tokens, causal; (a) in
   float32, (c) in bfloat16), at a Gemma 2 27B local layer (32 / 16
   heads, head dim 128, 8192 tokens, causal, window 4096, softcap 50,
   scale 1/12; (b)) and non-causal at a ragged 4000 tokens (d), and
   ``selective_scan`` (K7) at falcon-mamba-7b (d_inner 8192, d_state 16,
   4096 tokens) and at a ragged S=100, D=50; hold each result against its
   plain version on the card and K6 against the float64 oracle
   ``ref_attention`` (on query heads 0-1 for (b)); time each kernel, its
   plain version and, for (a), ``scaled_dot_product_attention``;
8. print one JSON line ``{"kernels": [...]}`` with launches, max |diff|,
   times and bounds of K1-K7, then ``{"ok": true, "device": {...}}`` as
   the last line.

Any failure exits nonzero; no phase catches an error and carries on
(phase 6 counts the configurations the port refuses with the reference's
``ValueError`` and prints them).
Bounds: bytes over 3.35 TB/s and operations over 67 TFLOP/s (float32
outside the tensor cores), the H100 SXM's published peaks at 700 W.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
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
        err = check(f"K6 ({case}) vs its plain version", got,
                    attention_plain(q, k, v, **kw), tol)
        if dt == "float32":
            k6_err = max(k6_err, err)
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

    k6_rows = {}
    for case, (b_, hq, hkv, hd, s_, kw, dt) in K6_CASES.items():
        q, k, v = k6_in[case]
        reps = 3 if case == "b" else 10
        ms = cuda_ms(lambda: attention(q, k, v, **kw), reps)
        plain_ms = cuda_ms(lambda: attention_plain(q, k, v, **kw), 2)
        lib_ms = None
        if case == "a":
            from torch.nn.functional import scaled_dot_product_attention
            lib_ms = cuda_ms(lambda: scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), reps)
            lib_err = float((scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
                - k6_out["a"]).abs().max())
        pairs = b_ * hq * attn_pairs(s_, kw["causal"], kw.get("window", 0))
        ops = 4 * hd * pairs
        byts = nbytes(q, k, v, k6_out[case])
        k6_rows[case] = (ms, plain_ms, lib_ms, byts, ops)
        print(f"K6 ({case}): {ms:.4f} ms ({ops / ms / 1e9:.2f} TFLOP/s over "
              f"{pairs} unmasked pairs), plain {plain_ms:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; "
              f"{byts} bytes, {ops} operations", flush=True)
    print(f"scaled_dot_product_attention (a) max |diff| from K6 {lib_err}")
    k7_ms = cuda_ms(lambda: selective_scan(*k7_in), 10)
    k7_plain = cuda_ms(lambda: mamba_scan_plain(*k7_in), 1)
    k7_bytes = nbytes(*k7_in, k7_out)
    k7_ops = 4 * k7_in[0].numel()       # a*h, + bx, * c, + into y per state
    print(f"K7 at {K7_SHAPE}: {k7_ms:.4f} ms "
          f"({k7_bytes / k7_ms / 1e9:.3f} TB/s), plain {k7_plain:.4f} ms, "
          f"library none; {k7_bytes} bytes, {k7_ops} operations", flush=True)
    return {"k6_rows": k6_rows, "k6_err": k6_err, "k7_ms": k7_ms,
            "k7_plain": k7_plain, "k7_bytes": k7_bytes, "k7_ops": k7_ops,
            "k7_err": k7_err}



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
        from repro_torch.obs import disable_tracing, enable_tracing
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
    sources = sorted(os.listdir(os.path.join(
        ROOT, "src/repro_torch/kernels/csrc")))
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
        k1_args = (d["prob"], d["slot0"], d["slot_xy"], d["net_pins"],
                   d["net_mask"])
        pnc0 = pnr_cost.net_hpwl_rows(*k1_args)
        pnc0_plain = pnr_cost.net_hpwl_rows_plain(*k1_args)
        torch.cuda.synchronize()
        if not torch.equal(pnc0, pnc0_plain):
            fail(f"K1 differs from its plain version at {sig}")
        max_err["k1"] = max(max_err["k1"],
                            float((pnc0 - pnc0_plain).abs().max()))
        args = [d[k] for k in KERNEL_INPUTS] + [pnc0]
        k2_ms = cuda_ms(lambda: pnr_cost.anneal_chains(*args), 1)
        for full, tele in ((False, False), (True, False), (False, True)):
            got = pnr_cost.anneal_chains(*args, full=full, telemetry=tele)
            want = pnr_cost.anneal_chains_plain(*args, full=full,
                                                telemetry=tele)
            torch.cuda.synchronize()
            for name, g, w in zip(("best_slot", "best", "accepts", "curve"),
                                  got, want):
                if (g is None) != (w is None):
                    fail(f"K2 {name} presence differs at {sig}")
                if g is None:
                    continue
                if not torch.equal(g, w):
                    fail(f"K2 (full={full}, telemetry={tele}) {name} "
                         f"differs from its plain version at {sig}")
                if g.dtype == torch.float32:
                    max_err["k2"] = max(max_err["k2"],
                                        float((g - w).abs().max()))
        pairs = [f"{pe}/{app}" for (pe, app), _ in items]
        per_sig.append((sig, pairs, k2_ms))
        print(f"  {'x'.join(map(str, sig))}: {pairs} K1 == plain, "
              f"K2 delta/full/telemetry == plain; K2 {k2_ms:.2f} ms",
              flush=True)
        if largest is None or sig[0] > largest[0][0]:
            largest = (sig, d, pnc0)

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
    largest_sim = None
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
        k3_ms = cuda_ms(lambda: sim_step.simulate_batch_stepper(
            tabs, x, op_ids, **kw), 1)
        state = sim_step.stepper_state_bytes(*sig[:7], sig[9])
        pairs = [f"{pe}/{app}" for (pe, app), _ in items]
        print(f"  {'x'.join(map(str, sig))}: {pairs} K3 shared/global == "
              f"plain; state {state} B; K3 {k3_ms:.3f} ms", flush=True)
        # signatures run in ascending (cycles, tiles, wires): keep the last
        largest_sim = (sig, [p for _, p in items], tabs, x, op_ids)

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

    pnr_cost.net_hpwl_rows.launches = 0
    pnr_cost.anneal_chains.launches = 0
    sim_step.simulate_batch_stepper.launches = 0
    res, gpu_wall, gpu_stages = traced_run(ex)
    torch.cuda.synchronize()
    launches = {"k1": pnr_cost.net_hpwl_rows.launches,
                "k2": pnr_cost.anneal_chains.launches,
                "k3": sim_step.simulate_batch_stepper.launches}
    rows = [r.to_dict() for r in res.records()]
    buckets = {b for b in res.sim_buckets.values() if b}
    print(f"Explorer.run() on cuda: {gpu_wall:.2f} s wall; stage walls (s) "
          f"{ {k: round(v, 3) for k, v in gpu_stages.items()} }; "
          f"{ex.stats['pnr_dispatch']} pnr dispatches, "
          f"{ex.stats['sim_dispatch']} sim dispatches, launches {launches}",
          flush=True)
    if launches["k1"] == 0 or launches["k2"] == 0:
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
    print(f"{len(rows)} records ({len(sims)} simulated and golden-verified, "
          f"{len(buckets)} sim buckets), failure rows "
          f"{[(f.stage, f.pe_name, f.app, f.error_type) for f in res.failures]}"
          f" identical on cuda and cpu")
    print(res.table())

    # -- 5: kernel times and bounds at the largest signature ---------------
    phase("5 kernel timing")
    sig, d, pnc0 = largest
    k1_args = (d["prob"], d["slot0"], d["slot_xy"], d["net_pins"],
               d["net_mask"])
    r_n, e_n = d["slot0"].shape
    n_n, d_n = d["net_pins"].shape[1:]
    k1_ms = cuda_ms(lambda: pnr_cost.net_hpwl_rows(*k1_args), 20)
    k1_plain = cuda_ms(lambda: pnr_cost.net_hpwl_rows_plain(*k1_args), 5)
    k1_pins = int(d["net_mask"][d["prob"].long()].sum())
    k1_bytes = nbytes(*k1_args, pnc0)
    k1_ops = 4 * k1_pins + 3 * r_n * n_n
    args = [d[k] for k in KERNEL_INPUTS] + [pnc0]
    k2_ms = cuda_ms(lambda: pnr_cost.anneal_chains(*args), 3)
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
    k3_ms = cuda_ms(lambda: sim_step.simulate_batch_stepper(
        tabs, x, op_ids, **kw), 20)
    k3_global_ms = cuda_ms(lambda: sim_step.simulate_batch_stepper(
        tabs, x, op_ids, force_global=True, **kw), 20)
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
    k3_big_ms = cuda_ms(lambda: sim_step.simulate_batch_stepper(
        btabs, bx, bops, **bkw), 5)
    big_got = sim_step.simulate_batch_stepper(btabs, bx, bops, **bkw)
    big_want = sim_step.simulate_batch_plain(btabs, bx, bops, **bkw)
    torch.cuda.synchronize()
    if not same_bits(big_got, big_want):
        fail(f"K3 differs from its plain version at {bsig}")
    print(f"K3 at {'x'.join(map(str, ssig))} ({len(sprogs)} program(s), "
          f"{sim_step.stepper_state_bytes(*ssig[:7], ssig[9])} B state): "
          f"{k3_ms:.4f} ms shared-memory form, {k3_global_ms:.4f} ms "
          f"global-memory form, {k3_plain:.1f} ms plain; at sim_batch="
          f"{BIG_BATCH}, sim_iterations={BIG_ITERS} "
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
            # one bfloat16 rounding step: float32 sums that differ in the
            # last bits can round to neighbouring bfloat16 values; the
            # kernel's own float32 result (b) rounds to (d) exactly
            lim = torch.maximum(lim, want.double().abs() * 2.0 ** -8)
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
          f"({k5_ops / k5_ms['a'] / 1e9:.2f} TFLOP/s), (b) "
          f"{k5_ms['b']:.4f} ms, (c) {k5_ms['c']:.4f} ms; plain (a) "
          f"{k5_plain:.4f} ms; torch.matmul {k5_lib:.4f} ms", flush=True)

    # -- 7: the attention / selective-scan boundary at model widths -------
    p7 = attention_scan_phase(dev, launches)

    # -- 8: the kernels line ----------------------------------------------
    def bound(b, ops):
        t_b, t_o = b / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    kernels = []
    for name, src, repl, n, err, ms, plain_ms, b, ops in (
            ("net_hpwl_kernel (K1)", "pnr_anneal.cu",
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
    _, _, prog, ms, plain_ms, lib_ms, b, ops = k4_rows[0]
    b_ms, by = bound(b, ops)
    kernels.append({"name": "pe_kernel (K4)", "route": "triton",
                    "source": "src/repro_torch/kernels/pe_fused.py",
                    "replaces": "src/repro/kernels/pe_fused.py:71",
                    "launches": launches["k4"], "max_abs_err": k4_err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": by, "library_ms": lib_ms})
    b_ms, by = bound(k5_bytes, k5_ops)
    kernels.append({"name": "gemm_pe_kernel (K5)", "route": "cuda",
                    "source": CSRC + "gemm_pe.cu",
                    "replaces": "src/repro/kernels/gemm.py:51",
                    "launches": launches["k5"], "max_abs_err": k5_err,
                    "ms": k5_ms["a"], "plain_ms": k5_plain, "bound_ms": b_ms,
                    "bound_by": by, "library_ms": k5_lib})
    k6_rows = p7["k6_rows"]
    k7_ms, k7_plain = p7["k7_ms"], p7["k7_plain"]
    k7_bytes, k7_ops = p7["k7_bytes"], p7["k7_ops"]
    ms, plain_ms, lib_ms, b, ops = k6_rows["a"]
    b_ms, by = bound(b, ops)
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
    for case, (ms, plain_ms, lib_ms, b, ops) in k6_rows.items():
        b_ms, by = bound(b, ops)
        print(f"K6 ({case}): {ms:.4f} ms against a bound of {b_ms:.4f} ms "
              f"({by}), plain {plain_ms:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    b_ms, by = bound(k7_bytes, k7_ops)
    print(f"K7: {k7_ms:.4f} ms against a bound of {b_ms:.4f} ms ({by}), "
          f"plain {k7_plain:.4f} ms, library none")
    print(f"K1/K2 timed at signature {'x'.join(map(str, sig))} "
          f"(R={r_n} chains, E={e_n}, N={n_n}, D={d_n}); K2 work {work}; "
          f"K3 work {k3_ops} ALU operations, {k3_bytes} bytes")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
