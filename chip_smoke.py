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
   batch, and print one JSON line ``{"kernels": [...]}`` with launches,
   max |diff|, times and bounds;
6. print ``{"ok": true, "device": {...}}`` as the last line.

Any failure exits nonzero; no phase catches an error and carries on.
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


def main() -> int:
    import torch

    # -- 1: the card ------------------------------------------------------
    phase("1 device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.apps import image_graphs
        from repro_torch.core.mining import MiningConfig
        from repro_torch.explore import ExploreConfig, Explorer
        from repro_torch.fabric import (FabricOptions, FabricSpec,
                                        batch_signature, extract_netlist,
                                        lower)
        from repro_torch.fabric.place import KERNEL_INPUTS, batch_inputs
        from repro_torch.kernels import build, pnr_cost, sim_step
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
