"""How many device records does ``torch.profiler`` drop at the start of a
window, as the process ages?  And does ``chip_smoke.py``'s preamble of
empty kernels keep the window's own records?

    python3 tools/trace_loss.py [--minutes 12] [--every 90]

Builds ``chip_smoke.py`` phase 16 (e)'s GPipe run (Llama 3.2 1B's 16
layers unreduced in bfloat16 from seed 0 as one stage over a one-rank
NCCL group, 4 microbatches of (2, 512) ``SyntheticLM`` tokens: about
4,550 device records, the first K6 launch the 49th).  Then, every
``--every`` seconds for ``--minutes`` minutes (the card idle between),
traces the run twice (``torch.profiler``, CUDA activity): bare, and
after ``chip_smoke.TRACE_PREAMBLE`` empty spin kernels, as
``chip_smoke.device_kernels`` traces.  For each it prints the process's
age, the records lost against the first bare window and where in the
window they were lost (at its start, its end, or spread), the K6
launches in the trace and, with the preamble, how many of its records
were kept.  Ends with one JSON line of the rows.  Needs one card.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
K6 = "flash_attention_kernel"


def trace(run, preamble: int) -> list:
    """Names of the device records of one traced ``run()``, in order of
    their start, after ``preamble`` empty spin kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(preamble):
            torch.cuda._sleep(0)
        run()
        torch.cuda.synchronize()
    return [ev.name() for ev in sorted(
        prof.profiler.kineto_results.events(), key=lambda e: e.start_ns())
        if ev.device_type() == torch.autograd.DeviceType.CUDA]


def where_lost(got: list, ref: list) -> str:
    k = len(ref) - len(got)
    if k <= 0:
        return "none"
    return "start" if got == ref[k:] else "end" if got == ref[:-k] \
        else "spread"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--minutes", type=float, default=12.0)
    ap.add_argument("--every", type=float, default=90.0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import _lib
    from repro_torch.models import init_params
    from repro_torch.models.model import _embed
    from repro_torch.models.transformer import layer_body
    from repro_torch.sharding.pipeline import gpipe, stage_split

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    _lib()
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="trace_loss_")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        cfg = get_config(cs.TR_ARCH)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.bfloat16, device=dev)
        data = DataConfig(vocab=cfg.vocab, seq_len=cs.TR_SEQ,
                          global_batch=cs.TR_BATCH, seed=0)
        toks = torch.as_tensor(SyntheticLM(data).batch_at(0)["inputs"],
                               device=dev).reshape(cs.DIST_MICRO, cs.DIST_MB,
                                                   cs.TR_SEQ)
        x_micro = torch.stack([_embed(params, cfg, t, torch.bfloat16)
                               for t in toks])
        stages = stage_split({k: torch.stack([lp[k] for lp in params.layers])
                              for k in params.layers[0].keys()}, 1)
        q_pos = torch.arange(cs.TR_SEQ, dtype=torch.int32,
                             device=dev)[None].expand(cs.DIST_MB, cs.TR_SEQ)
        kinds = cfg.layer_kinds()

        def stage_fn(p, h):
            for i in range(p["ln1"].shape[0]):
                h, _, _ = layer_body(h, {k: v[i] for k, v in p.items()}, cfg,
                                     q_pos=q_pos, is_global=bool(kinds[i]),
                                     compute_dtype=torch.bfloat16)
            return h
        apply = gpipe(stage_fn, dist.group.WORLD)

        def run():
            apply(stages, x_micro)
        run()
        ref = trace(run, 0)
        rows = []
        n = int(args.minutes * 60 // args.every) + 1
        for i in range(n):
            bare = trace(run, 0)
            pre = trace(run, cs.TRACE_PREAMBLE)
            kept = sum("spin_kernel" in name for name in pre)
            own = [name for name in pre if "spin_kernel" not in name]
            row = {"age_s": time.perf_counter() - t_start,
                   "lost": len(ref) - len(bare),
                   "where": where_lost(bare, ref),
                   "k6": sum(K6 in name for name in bare),
                   "preamble_kept": kept, "preamble_lost":
                   cs.TRACE_PREAMBLE - kept,
                   "k6_with_preamble": sum(K6 in name for name in own),
                   "lost_with_preamble": len(ref) - len(own)}
            rows.append(row)
            print(f"at {row['age_s']:.1f} s of the process: bare window "
                  f"lost {row['lost']} of {len(ref)} records (at the "
                  f"{row['where']}), K6 {row['k6']}; with the preamble "
                  f"{kept} of its {cs.TRACE_PREAMBLE} records kept, the "
                  f"run's own lost {row['lost_with_preamble']}, K6 "
                  f"{row['k6_with_preamble']}", flush=True)
            if i < n - 1:
                time.sleep(args.every)
    finally:
        dist.destroy_process_group()
    print(card)
    print(json.dumps({"records": len(ref), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
