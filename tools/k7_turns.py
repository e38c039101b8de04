"""Time K7 (``kernels.mamba_scan.mamba_scan``) of this checkout against K7
of another checkout, in turns, at the widths the repository uses it.

    python3 tools/k7_turns.py --other DIR [--rounds 2]

DIR is the root of another checkout of the repository, for example a
parent commit unpacked with ``git archive`` into a gitignored directory
such as ``build/``.  Each checkout runs in a process of its own (its
``src`` first on the path, its kernels built into its own build
directory), on the same inputs made on the card from one seed: phase 7's
falcon-mamba-7b scan (1, 4096, 8192, 16) and phase 11's served prefill
(1, 512, 8192, 16), float32, from no state and y only (the call both
forms take).  Each round runs other, this, this, other; each process
times every shape with CUDA events (one warm-up call, then the mean of 20)
and prints a CRC of y.  The script prints every reading and the means,
and fails unless the two forms return the same bits.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((1, 4096, 8192, 16), (1, 512, 8192, 16))


def worker(src: str) -> None:
    """Times this process's ``mamba_scan`` (from ``src``) at
    :data:`SHAPES`; prints one JSON line."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import mamba_scan
    out = {}
    for shape in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(7)
        a = torch.rand(shape, generator=gen, device="cuda") * 0.399 + 0.6
        bx = torch.randn(shape, generator=gen, device="cuda") * 0.1
        c = torch.randn(shape[:2] + shape[3:], generator=gen, device="cuda")
        y = mamba_scan(a, bx, c)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            mamba_scan(a, bx, c)
        stop.record()
        torch.cuda.synchronize()
        out["x".join(map(str, shape))] = {
            "ms": start.elapsed_time(stop) / 20,
            "crc": zlib.crc32(y.cpu().numpy().tobytes())}
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return 0
    if args.other is None:
        ap.error("--other is required")
    import torch
    if not torch.cuda.is_available():
        print("k7_turns: FAIL: no card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    trees = {"this": ROOT / "src", "other": args.other.resolve() / "src"}
    runs = {"this": [], "other": []}
    for r in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            p = subprocess.run([sys.executable, __file__, "--worker",
                                str(trees[name])], capture_output=True,
                               text=True, timeout=600, cwd=trees[name].parent)
            if p.returncode != 0:
                print(f"k7_turns: FAIL: {name}: {p.stderr[-2000:]}",
                      file=sys.stderr)
                return 1
            got = json.loads(p.stdout.strip().splitlines()[-1])
            runs[name].append(got)
            print(f"round {r} {name}: " + "; ".join(
                f"{k} {v['ms']:.4f} ms" for k, v in got.items()), flush=True)
    for shape in runs["this"][0]:
        crcs = {v[shape]["crc"] for side in runs.values() for v in side}
        if len(crcs) != 1:
            print(f"k7_turns: FAIL: y differs at {shape}: {crcs}",
                  file=sys.stderr)
            return 1
        means = {name: sum(v[shape]["ms"] for v in side) / len(side)
                 for name, side in runs.items()}
        print(f"{shape}: this {means['this']:.4f} ms, other "
              f"{means['other']:.4f} ms (means of {len(runs['this'])}); y "
              f"bit-equal", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
