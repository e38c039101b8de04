"""How far a bfloat16 roundoff in attention carries through a deep model,
against how far K6 carries it: the yardstick behind ``chip_smoke.py``
phase 13's bound on hymba-1.5b's bfloat16 prefill.

    python3 tools/lm_bf16_drift.py [--arch hymba-1.5b] [--prompts 1536 512]

Needs one card and an arch with attention.  First K6
(``kernels.attention``) alone at the arch's attention shape (1, Hq/Hkv,
S, D) and at three other head groupings, in
float32 and bfloat16, with and without the arch's window, against the
float64 oracle and against its plain version.  Then the arch unreduced
(random weights from seed 0) on a prompt of each length, in float32 and
in bfloat16: the prefill with K6 against the prefill with the plain
version swapped in, and (bfloat16) the plain version with a relative
2^-9 Gaussian on its output (``chip_smoke.lm_roundoff_attention``)
against the plain version, each by relative error norm of the logits and
of each layer's cached keys; and, where the arch has a Mamba mixer, K7
against its plain version.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--prompts", type=int, nargs="+", default=[1536, 512])
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.models import cast_for_compute, init_params, prefill

    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    hq, hkv, d = cfg.n_heads, cfg.n_kv, cfg.head_dim_of
    s = max(args.prompts)
    gen = torch.Generator(device=dev).manual_seed(1)
    for hq_, hkv_ in ((hq, hkv), (4 * hkv, hkv), (24, 6), (32, 8)):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((1, h, s, d), generator=gen, device=dev,
                                   dtype=dt) for h in (hq_, hkv_, hkv_))
            for w in sorted({0, cfg.window}):
                want = attention_plain(q.double(), k.double(), v.double(),
                                       causal=True, window=w)
                got = cs.rel_norms(attention(q, k, v, causal=True,
                                             window=w), want)
                plain = cs.rel_norms(attention_plain(q, k, v, causal=True,
                                                     window=w), want)
                print(f"K6 ({hq_}/{hkv_}, {s}, {d}) {dt} window {w}: "
                      f"against float64 {got[0]:.3e} (largest row "
                      f"{got[1]:.3e}); the plain version against float64 "
                      f"{plain[0]:.3e} ({plain[1]:.3e})", flush=True)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, s), dtype=np.int64), device=dev)

    def keys(a, b):
        return " ".join(f"{cs.rel_norms(a[1]['k'][i], b[1]['k'][i])[0]:.1e}"
                        for i in range(a[1]["k"].shape[0]))
    for dt in (torch.float32, torch.bfloat16):
        p = params if dt == torch.float32 else cast_for_compute(params, cfg,
                                                                dt)
        for n in args.prompts:
            run = dict(smax=s + 512, compute_dtype=dt)
            t = toks[:, :n]
            got = prefill(p, cfg, t, **run)
            ref = cs.lm_run_with(cs.lm_plain_attention, prefill, p, cfg, t,
                                 **run)
            print(f"{dt} S={n}, K6 against the plain version: logits "
                  f"{cs.rel_norms(got[0], ref[0])[0]:.3e}; keys by layer "
                  f"{keys(got, ref)}", flush=True)
            if dt == torch.bfloat16:
                noisy = cs.lm_run_with(cs.lm_roundoff_attention, prefill, p,
                                       cfg, t, **run)
                print(f"{dt} S={n}, the plain version with a 2^-9 roundoff "
                      f"against the plain version: logits "
                      f"{cs.rel_norms(noisy[0], ref[0])[0]:.3e}; keys by "
                      f"layer {keys(noisy, ref)}", flush=True)
            if cfg.mixer != "attn":
                scan = cs.mb_run_with(cs.mb_plain_scan, prefill, p, cfg, t,
                                      **run)
                print(f"{dt} S={n}, K7 against the plain version: logits "
                      f"{cs.rel_norms(got[0], scan[0])[0]:.3e}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
