"""Serving launcher: batched continuous prefill+decode (demo scale).

The port of the JAX package's ``repro.launch.serve``, with its flags and
defaults (a reduced configuration: 2 layers, d_model 128, d_ff 256,
vocab 512, random weights from ``--seed``) and the port's ``--device``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --requests 8 --max-new 16 [--device cpu]

Every configuration of ``repro_torch.configs`` runs:
``--arch falcon-mamba-7b`` serves the Mamba mixer (prefill's selective
scan on K7); ``hymba-1.5b`` runs attention and the Mamba mixer side by
side; ``qwen2-moe-a2.7b`` and ``qwen3-moe-235b-a22b`` the MoE MLP
(``models.moe``).  Without a card, ``--device cuda`` (the default) fails
with one ``error: ... no CUDA device`` line.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..configs import get_config, list_archs
from ..device import resolve_device
from ..models.transformer import init_params
from ..serve.lm_engine import Request, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--smax", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    cfg = get_config(args.arch).reduced(n_layers=2, d_model=128, d_ff=256,
                                        vocab=512)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    eng = ServeEngine(cfg, params, slots=args.slots, smax=args.smax,
                      device=dev)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        eng.submit(Request(rid, rng.integers(0, cfg.vocab, args.prompt_len,
                                             dtype=np.int32),
                           max_new=args.max_new))
    t0 = time.time()
    outs = eng.run(max_steps=args.requests * args.max_new + 16)
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in outs.values())
    print(f"served {len(outs)} requests, {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens/dt:.1f} tok/s) on {dev.type}")
    for rid, toks in sorted(outs.items()):
        print(f"  req {rid}: {toks[:12]}{'...' if len(toks) > 12 else ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
