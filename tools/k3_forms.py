"""Time the cycle stepper K3 as commit 2ba36e0 shipped it, with its state
in shared and in global memory, with one phase of its cycle taken out at
a time: the measurement behind PERF.md's table of why that K3 was slower
with its state in shared memory.  It applies to that commit's K3 only
(its source is checked by checksum first); the K3 of later commits
walks event lists and is timed by ``chip_smoke.py`` phase 5.

    git archive 2ba36e0 | tar -x -C build/parent
    python3 tools/k3_forms.py --other build/parent [--reps 10]

That checkout's ``csrc/sim_step.cu`` is built as it is and in variants
made by editing its text (each edit must apply, or the script fails):

- ``as is``;
- ``smem held``: the global-memory placement launched with the shared
  placement's dynamic shared memory allocated and unused, so both run
  with the same split of the SM's 256 KB between shared memory and L1;
- ``no zeroing``: tmp is not cleared at the start of each tile's steps;
- ``no ALU``: the tiles run no micro-op;
- ``no views``: phase (1), the latch views, is skipped;
- ``no wires``: the wire copies of phase (3) are skipped;
- ``empty``: every loop of the cycle is skipped, the barriers stay.

The inputs are ``chip_smoke.py``'s: the image suite mined, mapped, placed,
routed and scheduled with its settings, at the largest sim signature
(camera on PE1), 3 iterations x 2 input rows.  Each variant's launch
alone (the arguments the other checkout's wrapper passes, prepared once)
is timed in both placements in rounds of (shared, global, global,
shared) with CUDA events; the script prints the means, and the other
checkout's whole wrapper (launch and host work) apart.  ``as is`` must
equal this checkout's plain version bit for bit.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import subprocess
import sys
import types
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: zlib.crc32 of csrc/sim_step.cu at commit 2ba36e0
PARENT_CRC = 0xC5692825

#: variant -> [(old text, new text)] edits of the other checkout's source
VARIANTS = {
    "as is": [],
    "smem held": [("long long smem = use_global ? 0 : floats * 4;",
                   "long long smem = floats * 4;")],
    "no zeroing": [("for (int u = 0; u < up; ++u) tmp[u] = 0.0f;", "")],
    "no ALU": [("for (int u = 0; u < n_steps; ++u) {",
                "for (int u = 0; u < 0; ++u) {")],
    "no views": [("for (int l = tid; l < lp; l += THREADS) {\n"
                  "      periodic(c, fire_time[latch_owner[l]]",
                  "for (int l = tid; l < 0; l += THREADS) {\n"
                  "      periodic(c, fire_time[latch_owner[l]]")],
    "no wires": [("for (int w = tid; w < wp; w += THREADS) {",
                  "for (int w = tid; w < 0; w += THREADS) {")],
}
VARIANTS["empty"] = VARIANTS["no views"] + [
    ("for (int i = tid; i < ip; i += THREADS) {",
     "for (int i = tid; i < 0; i += THREADS) {"),
    ("for (int s = tid; s < sp; s += THREADS)",
     "for (int s = tid; s < 0; s += THREADS)"),
    ("for (int e = tid; e < ep; e += THREADS)",
     "for (int e = tid; e < 0; e += THREADS)"),
    ("for (int l = tid; l < lp; l += THREADS)\n      if (periodic",
     "for (int l = tid; l < 0; l += THREADS)\n      if (periodic"),
    ("for (int o = tid; o < op; o += THREADS)",
     "for (int o = tid; o < 0; o += THREADS)")] + VARIANTS["no wires"]


def load_other(root: Path):
    """The other checkout's kernel package, as ``k3_other``."""
    pkg = types.ModuleType("k3_other")
    pkg.__path__ = [str(root / "src" / "repro_torch" / "kernels")]
    sys.modules["k3_other"] = pkg
    return (importlib.import_module("k3_other.sim_step"),
            importlib.import_module("k3_other.build"))


def build_variant(source: str, name: str, edits, out_dir: Path,
                  flags) -> ctypes.CDLL:
    for old, new in edits:
        if source.count(old) != 1:
            raise SystemExit(f"k3_forms: FAIL: edit of {name!r} does not "
                             f"apply: {old!r}")
        source = source.replace(old, new)
    stem = name.replace(" ", "_")
    src = out_dir / f"{stem}.cu"
    src.write_text(source)
    lib = out_dir / f"lib{stem}.so"
    proc = subprocess.run([*flags, "-o", str(lib), str(src)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"k3_forms: FAIL: nvcc on {name!r}:\n"
                         f"{proc.stderr}")
    return ctypes.CDLL(str(lib))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_forms: FAIL: no card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.apps import image_graphs
    from repro_torch.core.mining import MiningConfig
    from repro_torch.explore import ExploreConfig, Explorer
    from repro_torch.fabric import FabricOptions, FabricSpec
    from repro_torch.kernels import build, sim_step
    from repro_torch.sim import random_inputs, sim_signature
    from repro_torch.sim.cycle import bucket_tensors

    source = (args.other / "src/repro_torch/kernels/csrc/sim_step.cu"
              ).read_text()
    if zlib.crc32(source.encode()) != PARENT_CRC:
        print("k3_forms: FAIL: --other is not a checkout of commit 2ba36e0 "
              "(its sim_step.cu differs)", file=sys.stderr)
        return 1
    other, other_build = load_other(args.other.resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    out_dir = ROOT / "build" / "k3_forms"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [build._nvcc()] + [f for f in build.NVCC_FLAGS
                               if f not in ("-Xptxas", "-v")]
    libs = {name: build_variant(source, name, edits, out_dir, flags)
            for name, edits in VARIANTS.items()}

    options = FabricOptions(spec=FabricSpec(rows=16, cols=16), chains=16,
                            sweeps=32, simulate=True)
    cfg = ExploreConfig(mode="per_app", max_merge=3,
                        mining=MiningConfig(min_support=3,
                                            max_pattern_nodes=6,
                                            time_budget_s=15,
                                            max_patterns_per_level=40),
                        fabric=options)
    apps = image_graphs()
    progs = Explorer(apps, cfg, device="cuda").schedule()
    k_it, b_rows = options.sim_iterations, options.sim_batch
    groups = {}
    for (pe, app), prog in sorted(progs.items()):
        groups.setdefault(sim_signature(prog, k_it, b_rows), []).append(
            ((pe, app), prog))
    sig = max(groups, key=lambda s: (s[8], s[0], s[4]))
    items = groups[sig]
    arrs = [random_inputs(p, k_it, b_rows, seed=options.input_seed(
        zlib.crc32(f"{pe}:{app}".encode()))) for (pe, app), p in items]
    dev = torch.device("cuda")
    tabs, x, op_ids = bucket_tensors([p for _, p in items], arrs, sig, dev)
    kw = dict(cycles=sig[8], latch_depth=sig[9])
    state = other.stepper_state_bytes(*sig[:7], sig[9])
    print(f"signature {'x'.join(map(str, sig))}: "
          f"{[f'{pe}/{app}' for (pe, app), _ in items]}, {state} B of "
          f"state in the other checkout's layout, {sig[8]} cycles",
          flush=True)
    want = sim_step.simulate_batch_plain(tabs, x, op_ids, **kw)

    def run(name, fg):
        other_build.load = lambda _source, _lib=libs[name]: _lib
        return other.simulate_batch_stepper(tabs, x, op_ids,
                                            force_global=fg, **kw)

    for name, lib in libs.items():          # the wrapper types each one
        other_build.load = lambda _source, _lib=lib: _lib
        other._lib()

    for fg in (False, True):
        got = run("as is", fg)
        torch.cuda.synchronize()
        same = (got.view(torch.int32) == want.view(torch.int32)) \
            | (torch.isnan(got) & torch.isnan(want))
        if not bool(same.all()):
            print(f"k3_forms: FAIL: the other checkout's K3 (global={fg}) "
                  f"differs from the plain version", file=sys.stderr)
            return 1

    # the launch alone, with the arguments the other checkout's wrapper
    # passes (its checks and allocations are host work, timed apart)
    shapes = other._shapes(tabs)
    g, b, k = x.shape[:3]
    outbuf = torch.zeros((g, b, k, shapes["op"]), device=dev)
    scratch = torch.empty((g * b * state // 4,), device=dev)
    ptr = other._ptr

    def launch(name, fg):
        rc = libs[name].sim_stepper(
            g, b, k, kw["cycles"], kw["latch_depth"], shapes["ip"],
            shapes["up"], shapes["ep"], shapes["sp"], shapes["wp"],
            shapes["lp"], shapes["cp"], shapes["op"], int(fg),
            *(ptr(tabs[n]) for n in other.TABLES), ptr(op_ids), ptr(x),
            ptr(outbuf), ptr(scratch), other._stream(dev))
        if rc != 0:
            raise SystemExit(f"k3_forms: FAIL: {name!r} launch: CUDA error "
                             f"{rc}")

    def ms(fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / args.reps

    wrapped = [ms(lambda: run("as is", fg)) for fg in (False, True)]
    print(f"the other checkout's wrapper, launch and host work: shared "
          f"{wrapped[0]:.4f} ms, global {wrapped[1]:.4f} ms", flush=True)
    print(f"{'variant':12s} {'shared ms':>10s} {'global ms':>10s} "
          f"{'shared us/cycle':>16s} {'global us/cycle':>16s}  (launch "
          f"alone)")
    for name in VARIANTS:
        t = [ms(lambda: launch(name, fg)) for fg in (False, True, True,
                                                     False)]
        sh, gl = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        print(f"{name:12s} {sh:10.4f} {gl:10.4f} "
              f"{1e3 * sh / sig[8]:16.3f} {1e3 * gl / sig[8]:16.3f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
