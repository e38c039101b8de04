"""Training launcher.

The port of the JAX package's ``repro.launch.train``, with its flags and
defaults and the port's ``--device``: it builds the configuration (the
full one, or ``--reduced`` at the given widths), random float32 master
weights from ``--seed``, AdamW with bfloat16 moments, and runs the
fault-tolerant :class:`Trainer` on ``SyntheticLM`` batches, then prints
the JSON summary the JAX launcher prints::

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir DIR [--device cpu]

Without a card, ``--device cuda`` (the default) fails with one
``error: ... no CUDA device`` line.  :func:`run` is the same run for a
caller in the process (it returns the trainer).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from ..configs import get_config, list_archs
from ..data.pipeline import DataConfig
from ..device import resolve_device
from ..models.transformer import init_params
from ..models.tree import leaves
from ..train.optimizer import AdamWConfig, init_opt_state
from ..train.steps import build_train_step
from ..train.trainer import Trainer, TrainerConfig

__all__ = ["main", "parser", "run"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced smoke config (CPU scale)")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--n-layers", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=512)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a fault at this step (tests restart)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap


def run(args) -> Trainer:
    """Build and run the trainer that ``args`` (from :func:`parser`)
    describe; prints the parameter count, returns the trainer."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=args.n_layers, d_model=args.d_model,
                          d_ff=args.d_ff, vocab=args.vocab, seq=args.seq)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    n_params = sum(leaf.value.numel() for leaf in leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M", flush=True)

    opt_cfg = AdamWConfig(lr_peak=args.lr,
                          warmup_steps=max(10, args.steps // 20),
                          total_steps=args.steps)
    opt_state = init_opt_state(params, opt_cfg)
    step_fn = build_train_step(cfg, opt_cfg, microbatches=args.microbatches)

    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    trainer = Trainer(TrainerConfig(total_steps=args.steps,
                                    ckpt_every=args.ckpt_every,
                                    ckpt_dir=args.ckpt_dir),
                      step_fn, params, opt_state, data_cfg, device=dev)
    trainer.run(fail_at=args.fail_at)
    return trainer


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    t0 = time.time()
    trainer = run(args)
    dt = time.time() - t0
    state = trainer.state
    print(json.dumps({"history": trainer.history,
                      "steps": state.step,
                      "restarts": state.restarts,
                      "stragglers": state.stragglers,
                      "wall_s": round(dt, 1)}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
