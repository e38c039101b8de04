"""Time K2 (``pnr_cost.anneal_chains``) of this checkout against K2 of
another checkout, in turns, on the image suite's pnr signatures.

    python3 tools/k2_turns.py --other DIR [--rounds 10]

DIR is the root of another checkout of the repository, for example a
parent commit unpacked with ``git archive`` into a gitignored directory
such as ``build/``.  Both forms get the same inputs: the image suite mined
and mapped with ``chip_smoke.py``'s settings (16 chains, 32 sweeps on a
16x16 fabric) and one launch per bucket signature, as the Explorer's pnr
stage launches K2.  A checkout whose K2 still takes the starting per-net
costs as an input (``pnc0``, before K2's prologue scored them) runs them
through its own K1 (``net_hpwl_rows``) first, inside the timed call, as
its pnr stage did.  Each round times other, this, this, other with CUDA
events, one call per signature, first with every step, then with zero
steps (the prologue alone: staging the tables and the starting costs,
read or scored); the script prints each round's sum over the signatures
and the largest signature's time per form, then their means, and fails
unless the two forms return the same bits.  Needs one
card; imports only the other checkout's ``repro_torch/kernels`` modules.
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
    """The other checkout's ``pnr_cost`` module, as ``k2_other.pnr_cost``
    (its ``csrc`` and build directory are its own)."""
    pkg = types.ModuleType("k2_other")
    pkg.__path__ = [str(root / "src" / "repro_torch" / "kernels")]
    sys.modules["k2_other"] = pkg
    return importlib.import_module("k2_other.pnr_cost")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k2_turns: FAIL: no card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.apps import image_graphs
    from repro_torch.core.mining import MiningConfig
    from repro_torch.explore import ExploreConfig, Explorer
    from repro_torch.fabric import (FabricOptions, FabricSpec,
                                    batch_signature, extract_netlist, lower)
    from repro_torch.fabric.place import KERNEL_INPUTS, batch_inputs
    from repro_torch.kernels import pnr_cost
    other = load_other(args.other.resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    from repro_torch.kernels import build
    for name, b in (("this", build),
                    ("other", importlib.import_module("k2_other.build"))):
        path, report = b.build("pnr_anneal.cu")
        print(f"{name}: {os.path.relpath(path, ROOT)}")
        for line in report.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("  " + line.strip())

    options = FabricOptions(spec=FabricSpec(rows=16, cols=16), chains=16,
                            sweeps=32)
    cfg = ExploreConfig(mode="per_app", max_merge=3,
                        mining=MiningConfig(min_support=3,
                                            max_pattern_nodes=6,
                                            time_budget_s=15,
                                            max_patterns_per_level=40),
                        fabric=options)
    apps = image_graphs()
    groups = {}
    for (pe, app), m in sorted(Explorer(apps, cfg, device="cuda")
                               .map().items()):
        nl = extract_netlist(m, apps[app], options.spec)
        p = lower(nl, options.spec.fit(len(nl.pe_cells), len(nl.io_cells)))
        groups.setdefault(batch_signature(p, options.sweeps), []).append(
            ((pe, app), p))
    dev = torch.device("cuda")
    cases = []
    for sig in sorted(groups):
        items = groups[sig]
        d = {k: v.to(dev) for k, v in batch_inputs(
            [p for _, p in items], chains=options.chains, seed=options.seed,
            sweeps=options.sweeps,
            nonces=[zlib.crc32(f"{pe}:{app}".encode())
                    for (pe, app), _ in items]).items()}
        cases.append((sig, [d[k] for k in KERNEL_INPUTS]))
    largest = max(range(len(cases)), key=lambda i: cases[i][0][0])
    print(f"{len(cases)} signatures; largest "
          f"{'x'.join(map(str, cases[largest][0]))}", flush=True)

    def other_k1_k2(*a, **kw):
        # K1 (its starting costs), then K2, as the other pnr stage ran them
        pnc0 = other.net_hpwl_rows(a[0], a[10], a[1], a[2], a[3])
        return other.anneal_chains(*a, pnc0, **kw)

    k1 = hasattr(other, "net_hpwl_rows")
    print(f"other: {'K1 + K2 (K2 takes pnc0)' if k1 else 'K2 alone'}; "
          f"this: K2 alone (starting costs in its prologue)", flush=True)
    forms = {"this": pnr_cost.anneal_chains,
             "other": other_k1_k2 if k1 else other.anneal_chains}
    for sig, a in cases:
        got = {n: f(*a, telemetry=True) for n, f in forms.items()}
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got["this"],
                                                      got["other"])):
            print(f"k2_turns: FAIL: the forms differ at {sig}",
                  file=sys.stderr)
            return 1

    # the same inputs with zero steps: every per-step stream cut to width 0
    streams = {KERNEL_INPUTS.index(k) for k in ("temps", "active", "a", "t",
                                                 "log_u")}
    zero_cases = [(sig, [x[:, :0].contiguous() if i in streams else x
                         for i, x in enumerate(a)]) for sig, a in cases]

    def one_pass(fn, cases):
        ms = []
        for _, a in cases:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn(*a)
            stop.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(stop))
        return sum(ms), ms[largest]

    times = {"this": [], "other": [], "this zero steps": [],
             "other zero steps": []}
    for rnd in range(args.rounds):
        for suffix, cs in (("", cases), (" zero steps", zero_cases)):
            row = []
            for name in ("other", "this", "this", "other"):
                total, big = one_pass(forms[name], cs)
                times[name + suffix].append((total, big))
                row.append(f"{name} {total:.4f}/{big:.4f}")
            print(f"round {rnd}{suffix}: sum/largest ms: " + ", ".join(row),
                  flush=True)
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
