"""Count K6's launches in ``torch.profiler`` traces of full-width Llama 3.2
1B train steps, window after window: the count that ``chip_smoke.py``
phase 15 (c) holds to the wrapper's counter, repeated to see how often the
trace loses device events, and where.

    python3 tools/k6_trace_count.py [--windows 10] [--steps 3]
    python3 tools/k6_trace_count.py --after-smoke [--windows 6]

Builds phase 15's model and batch (Llama 3.2 1B unreduced, float32 master
weights from seed 0, bfloat16 compute, 8 x 512 ``SyntheticLM`` tokens,
AdamW with bfloat16 moments) and takes two warm-up steps.  Then, for each
sequence and ``--windows`` times, traces ``--steps`` train steps
(``torch.profiler``, CUDA activity) and prints the window's K6 events
against ``flash_attention.launches`` and its device events in all:

* ``forward+sync``: a ``no_grad`` forward (``lm_loss``) and a
  synchronize before the window, phase 15's sequence;
* ``forward``: the same forward with no synchronize, so that its kernels
  still run when the trace starts;
* ``steps``: nothing but the traced steps;
* ``steps+pad``: the traced steps, then inside the trace a spin kernel
  (``torch.cuda._sleep``) and 2,000 small kernels after them, so that
  the steps' events are not the trace's last; only the events before
  the spin kernel are counted;
* ``synced``: the traced steps with a synchronize between the backward
  and the optimizer (the step's gradient hook) and after each step, so
  that the host never runs more than a step's phase ahead of the card.

The events are also counted between consecutive K6 events (the head
before the first, the tail after the last): where a window's segments
differ from the first window's, the segments that differ are printed,
which shows where in the steps the trace lost its events; and each
kernel name whose count differs, with the offsets of its first and last
events.  With ``--after-smoke`` the windows (``forward+sync`` and
``synced``) are taken in the process of a whole ``chip_smoke.py`` run,
just before its phase 15, which then runs as usual.  Ends with one JSON
line of the counts.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
K6 = "flash_attention_kernel"


def by_name(events) -> dict:
    out = {}
    for name, t in events:
        out.setdefault(name, []).append(t)
    return out


def segments(events) -> list:
    """Device events between consecutive K6 events (head and tail
    included)."""
    out, n = [], 0
    for name, _ in events:
        if K6 in name:
            out.append(n)
            n = 0
        else:
            n += 1
    return out + [n]


def traced(run):
    """``run()`` under ``torch.profiler`` (CUDA activity): the device
    events as ``(name, start ns)`` in start order."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sorted(((ev.name(), ev.start_ns())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.device_type() == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e[1])


def windows(modes, n_windows, n_steps) -> dict:
    """The windows of ``modes`` (see the module docstring) on phase 15's
    model, printed; returns ``{mode: [[K6 in the trace, counted, device
    events], ...]}``."""
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, build_train_step,
                                   init_opt_state, lm_loss)

    print(f"threads in this process: {threading.active_count()} Python, "
          f"{len(os.listdir('/proc/self/task'))} in all", flush=True)
    dev = torch.device("cuda")
    cfg = get_config(cs.TR_ARCH)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    data = DataConfig(vocab=cfg.vocab, seq_len=cs.TR_SEQ,
                      global_batch=cs.TR_BATCH, seed=0)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in SyntheticLM(data).batch_at(0).items()}
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=10,
                          total_steps=cs.TR_STEPS)
    state = [params, init_opt_state(params, opt_cfg)]
    step = build_train_step(cfg, opt_cfg)

    def synchronized(g):
        torch.cuda.synchronize()
        return g
    synced_step = build_train_step(cfg, opt_cfg,
                                   grad_transform=synchronized)

    def steps(n, fn=step, sync_each=False):
        for _ in range(n):
            state[0], state[1], _ = fn(state[0], state[1], batch)
            if sync_each:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    steps(2)
    pad = torch.zeros(16, device=dev)

    def padded():
        steps(n_steps)
        torch.cuda._sleep(1_000_000)
        for _ in range(2000):
            pad.add_(1.0)
        torch.cuda.synchronize()
    want = n_steps * cfg.n_layers
    counts, first, first_seg = {}, None, None
    for mode in modes:
        for w in range(n_windows):
            if mode.startswith("forward"):
                with torch.no_grad():
                    lm_loss(state[0], cfg, batch)
                if mode == "forward+sync":
                    torch.cuda.synchronize()
            flash_attention.launches = 0
            if mode == "steps+pad":
                events = traced(padded)
                spin = next(i for i, (name, _) in enumerate(events)
                            if "spin" in name or "sleep" in name)
                events = events[:spin]
            elif mode == "synced":
                events = traced(lambda: steps(n_steps, synced_step, True))
            else:
                events = traced(lambda: steps(n_steps))
            counted = flash_attention.launches
            k6 = [t for name, t in events if K6 in name]
            counts.setdefault(mode, []).append(
                [len(k6), counted, len(events)])
            print(f"{mode} window {w}: K6 {len(k6)} in the trace, "
                  f"{counted} counted (want {want}), {len(events)} device "
                  f"events", flush=True)
            t0 = events[0][1]
            if len(k6) != counted:
                print("  K6 starts (ms): " + " ".join(
                    f"{(t - t0) / 1e6:.2f}" for t in k6), flush=True)
            seg = segments(events)
            if first_seg is None:
                first_seg = seg
            if len(seg) == len(first_seg) and seg != first_seg:
                print("  events between K6 events, against window 0: "
                      + ", ".join(f"segment {i}: {a} ({b})" for i, (a, b)
                                  in enumerate(zip(seg, first_seg))
                                  if a != b), flush=True)
            names = by_name(events)
            if first is None:
                first = {k: len(v) for k, v in names.items()}
            for name in sorted(set(first) | set(names)):
                got = names.get(name, [])
                if len(got) != first.get(name, 0):
                    where = (f"first at {(got[0] - t0) / 1e6:.3f} ms, last "
                             f"at {(got[-1] - t0) / 1e6:.3f} ms"
                             if got else "none")
                    print(f"  {name[:90]}: {len(got)} against "
                          f"{first.get(name, 0)} in window 0 ({where})",
                          flush=True)
    print(json.dumps({"k6_trace_counts": counts, "want": want}),
          flush=True)
    del state, params
    cs.free_device_memory()
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--after-smoke", action="store_true",
                    help="take the windows inside a whole chip_smoke.py "
                         "run, before its phase 15")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if args.after_smoke:
        phase15 = cs.train_phase

        def probed(dev, card):
            windows(("forward+sync", "synced"), args.windows, args.steps)
            return phase15(dev, card)
        cs.train_phase = probed
        return cs.main()
    windows(("forward+sync", "forward", "steps", "steps+pad", "synced"),
            args.windows, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
