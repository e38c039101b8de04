"""Place a mega-fabric with the hierarchical placer on the card and print,
level by level, the launch layout K2 (``pnr_cost.anneal_chains``) gets and
its time.

    python3 tools/hier_layout.py [--size 256] [--chains 16] [--sweeps 32]

Runs ``place_hierarchical`` on ``benchmarks/pnr_bench.py``'s locality-4
synthetic netlist (seed 4, placer seed 5) at ``--size`` x ``--size``, with
every K2 call recorded under the ``pnr.hier.*`` span open around it
(``chip_smoke.record_k2_calls``).  Prints the wall of each span, the level
costs, and per level K2's launches, its time on the card (each call
launched again alone, CUDA events: ``chip_smoke.k2_per_level``) and each
launch's shape and layout: whether the problem's tables and the chain's
own state sit in shared or in global memory, and a block's shared-memory
bytes.  Needs one card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--sweeps", type=int, default=32)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("hier_layout: FAIL: no card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import k2_per_level, record_k2_calls
    from repro_torch.fabric import (FabricSpec, place_hierarchical,
                                    synthetic_netlist)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    spec = FabricSpec(rows=args.size, cols=args.size)
    t0 = time.perf_counter()
    nl = synthetic_netlist(spec, seed=4, locality=4)
    print(f"{args.size}x{args.size}: {len(nl.pe_cells)} PE + "
          f"{len(nl.io_cells)} I/O cells, {len(nl.nets)} nets "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    h, calls, tracer = record_k2_calls(lambda: place_hierarchical(
        nl, spec, chains=args.chains, sweeps=args.sweeps, seed=5,
        device="cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = {}
    for sp, _depth, _path in tracer.iter_spans():
        if sp.name.startswith("pnr.hier."):
            spans[sp.name[9:]] = spans.get(sp.name[9:], 0.0) + sp.dur
    cells = len(nl.pe_cells) + len(nl.io_cells)
    placed = len(set(h.coords.values()))
    print(f"placed {len(h.coords)} cells on {placed} tiles in {wall:.1f} s "
          f"(grid {h.cluster_grid}, chains {args.chains} x sweeps "
          f"{args.sweeps}); span walls (s) "
          f"{ {k: round(v, 4) for k, v in spans.items()} }; level costs "
          f"{h.level_costs}", flush=True)
    for lv, row in k2_per_level(calls, torch.device("cuda")).items():
        print(f"  K2 at the {lv} level: {row['launches']} launch(es), "
              f"{row['ms']:.4f} ms on the card (CUDA events), "
              f"{row['call_wall_s']:.3f} s with its inputs' copies",
              flush=True)
        for shape in row["shapes"]:
            print(f"    {shape}", flush=True)
    if len(h.coords) != cells or placed != cells \
            or not 0 < h.cost < float("inf"):
        print("hier_layout: FAIL: the placement is incomplete",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
