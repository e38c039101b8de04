"""Time K3 (``sim_step.launch_stepper``) of this checkout against K3 of
another checkout, in turns, on the image suite's sim signatures.

    python3 tools/k3_turns.py --other DIR [--rounds 10]

DIR is the root of another checkout of the repository, for example a
parent commit unpacked with ``git archive`` into a gitignored directory
such as ``build/``.  Both forms get the same inputs: the image suite
mined, mapped, placed and scheduled with ``chip_smoke.py``'s phase 3
settings (16 chains, 32 sweeps on a 16x16 fabric, ``random_inputs`` for
each pair), one bucket per sim signature.  An op id this checkout has and
the other lacks (``OP_MAC2``: ``mac`` rounded twice) is given to the other
as ``mac``; the inputs are integral, so both roundings give the same bits.
Each round times other, this, this, other with CUDA events, the kernel
alone as ``chip_smoke.py``'s phase 5 times it (20 launches of one
prepared launch, state in shared memory), on every signature; the script
prints each round's sum over the signatures and the largest signature's
time per form (phase 5's bucket: the last in ascending (cycles, tiles,
wires)), then their means, and fails unless the two forms return the same
bits.  Needs one card; imports of the other checkout only what its
``repro_torch/kernels/sim_step.py`` imports.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import types
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load_other(root: Path):
    """The other checkout's ``sim_step`` module, as
    ``k3_other.kernels.sim_step``: ``k3_other`` stands for its
    ``repro_torch`` (without running its ``__init__``), so the module's
    relative imports, its ``csrc`` and its build directory are its own."""
    pkg = types.ModuleType("k3_other")
    pkg.__path__ = [str(root / "src" / "repro_torch")]
    sys.modules["k3_other"] = pkg
    return importlib.import_module("k3_other.kernels.sim_step")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_turns: FAIL: no card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.apps import image_graphs
    from repro_torch.core.mining import MiningConfig
    from repro_torch.explore import ExploreConfig, Explorer
    from repro_torch.fabric import FabricOptions, FabricSpec
    from repro_torch.kernels import build, sim_step
    from repro_torch.sim import random_inputs, sim_signature
    from repro_torch.sim.cycle import bucket_tensors
    other = load_other(args.other.resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    other_build = importlib.import_module("k3_other.kernels.build")
    for name, b in (("this", build), ("other", other_build)):
        path, report = b.build("sim_step.cu")
        print(f"{name}: {os.path.relpath(path, ROOT)}")
        for line in report.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("  " + line.strip())

    options = FabricOptions(spec=FabricSpec(rows=16, cols=16), chains=16,
                            sweeps=32, simulate=True)
    cfg = ExploreConfig(mode="per_app", max_merge=3,
                        mining=MiningConfig(min_support=3,
                                            max_pattern_nodes=6,
                                            time_budget_s=15,
                                            max_patterns_per_level=40),
                        fabric=options)
    progs = Explorer(image_graphs(), cfg, device="cuda").schedule()
    k_it, b_rows = options.sim_iterations, options.sim_batch
    groups = {}
    for (pe, app), prog in sorted(progs.items()):
        groups.setdefault(sim_signature(prog, k_it, b_rows), []).append(
            ((pe, app), prog))
    dev = torch.device("cuda")
    mac2 = getattr(sim_step, "OP_MAC2", None)
    cases = []
    for sig in sorted(groups, key=lambda s: (s[8], s[0], s[4])):
        items = groups[sig]
        arrs = [random_inputs(p, k_it, b_rows, seed=options.input_seed(
            zlib.crc32(f"{pe}:{app}".encode()))) for (pe, app), p in items]
        tabs, x, op_ids = bucket_tensors([p for _, p in items], arrs, sig,
                                         dev)
        other_ids = op_ids if mac2 is None else torch.where(
            op_ids == mac2, sim_step.OP_IDS["mac"], op_ids)
        kw = dict(cycles=sig[8], latch_depth=sig[9])
        preps = {"this": sim_step.prepare_stepper(tabs, x, op_ids, **kw),
                 "other": other.prepare_stepper(tabs, x, other_ids, **kw)}
        cases.append((sig, [f"{pe}/{app}" for (pe, app), _ in items],
                       preps))
    print(f"{len(cases)} signatures; largest "
          f"{'x'.join(map(str, cases[-1][0]))} {cases[-1][1]}", flush=True)
    forms = {"this": sim_step.launch_stepper, "other": other.launch_stepper}
    for sig, _, preps in cases:
        got = {n: f(preps[n]).clone() for n, f in forms.items()}
        torch.cuda.synchronize()
        same = (got["this"].view(torch.int32)
                == got["other"].view(torch.int32)) | (
            torch.isnan(got["this"]) & torch.isnan(got["other"]))
        if not bool(same.all()):
            print(f"k3_turns: FAIL: the forms differ at {sig}",
                  file=sys.stderr)
            return 1

    def one_pass(name, reps=20):
        ms = []
        for _, _, preps in cases:
            fn, prep = forms[name], preps[name]
            fn(prep)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                fn(prep)
            stop.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(stop) / reps)
        return sum(ms), ms[-1]

    times = {"this": [], "other": []}
    for rnd in range(args.rounds):
        row = []
        for name in ("other", "this", "this", "other"):
            total, big = one_pass(name)
            times[name].append((total, big))
            row.append(f"{name} {total:.4f}/{big:.4f}")
        print(f"round {rnd}: sum/largest ms: " + ", ".join(row), flush=True)
    out = {}
    for name, ts in times.items():
        sums = [t[0] for t in ts]
        bigs = [t[1] for t in ts]
        out[name] = {"sum_ms_mean": sum(sums) / len(sums),
                     "sum_ms_min": min(sums), "sum_ms_max": max(sums),
                     "largest_ms_mean": sum(bigs) / len(bigs),
                     "largest_ms_min": min(bigs),
                     "largest_ms_max": max(bigs), "passes": len(ts)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
