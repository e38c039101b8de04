"""Fault-tolerant training loop.

The port of the JAX package's ``repro.train.trainer``, behaviour for
behaviour:

* **checkpoint/restart** — periodic checkpoints with atomic manifests; on
  start the trainer resumes from the latest complete step (crash
  mid-write is invisible: incomplete dirs carry .tmp names);
* **failure retry** — a step that raises is retried from the last
  checkpoint up to ``max_restarts`` times, with the data pipeline
  re-seeked by step index (deterministic);
* **straggler detection** — per-step wall-time EWMA; steps slower than
  ``straggler_factor`` x EWMA are recorded in ``state.stragglers``;
* **elastic re-mesh hook** — ``on_resize`` restores the latest
  checkpoint into a new layout: checkpoints hold full arrays, one file a
  leaf, so any reshape that keeps the leaves' shapes is legal.

Batches go to the trainer's device (``device``, the card unless the
caller asks for the CPU) with ``torch.as_tensor``.  A step's wall time
is taken after the step's device work has finished
(``torch.cuda.synchronize``), so the EWMA sees the card's time, not the
launch queue's.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint.checkpointer import (latest_step, restore_checkpoint,
                                       save_checkpoint)
from ..data.pipeline import DataConfig, Prefetcher, make_source
from ..device import resolve_device

__all__ = ["Trainer", "TrainerConfig", "TrainerState", "on_resize"]


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    log_every: int = 10
    max_restarts: int = 3
    straggler_factor: float = 2.5
    ewma_alpha: float = 0.1
    #: seconds to wait for a batch before raising (None: forever)
    data_timeout_s: Optional[float] = None


@dataclass
class TrainerState:
    step: int = 0
    ewma_step_s: float = 0.0
    stragglers: List[int] = field(default_factory=list)
    restarts: int = 0


class Trainer:
    def __init__(self, cfg: TrainerConfig, train_step: Callable,
                 params: Any, opt_state: Any, data_cfg: DataConfig,
                 host_id: int = 0, device="cuda"):
        self.cfg = cfg
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.data_cfg = data_cfg
        self.host_id = host_id
        self.device = resolve_device(device)
        self.state = TrainerState()
        self.history: List[Dict[str, float]] = []

    # -- checkpoint plumbing -------------------------------------------------
    def _save(self, step: int) -> None:
        save_checkpoint(self.cfg.ckpt_dir, step,
                        {"params": self.params, "opt": self.opt_state},
                        host_id=self.host_id, keep=self.cfg.keep)

    def _try_resume(self) -> int:
        last = latest_step(self.cfg.ckpt_dir)
        if last is None:
            return 0
        tree = restore_checkpoint(self.cfg.ckpt_dir, last,
                                  {"params": self.params,
                                   "opt": self.opt_state},
                                  host_id=self.host_id)
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        return last

    def _prefetcher(self, source, start: int) -> Prefetcher:
        return Prefetcher(source, start_step=start,
                          timeout=self.cfg.data_timeout_s)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- main loop ---------------------------------------------------------------
    def run(self, *, fail_at: Optional[int] = None) -> TrainerState:
        """fail_at: inject a fault at that step (tests the restart path)."""
        os.makedirs(self.cfg.ckpt_dir, exist_ok=True)
        start = self._try_resume()
        self.state.step = start
        source = make_source(self.data_cfg)
        prefetch = self._prefetcher(source, start)
        injected = {"armed": fail_at is not None}

        try:
            while True:
                # NOTE: pull explicitly — a `for ... in prefetch` iterator
                # would stay bound to a pre-restart prefetcher and deadlock
                step, batch = next(prefetch)
                if step >= self.cfg.total_steps:
                    break
                t0 = time.monotonic()
                try:
                    if injected["armed"] and step == fail_at:
                        injected["armed"] = False
                        raise RuntimeError("injected fault (test)")
                    batch = {k: torch.as_tensor(v, device=self.device)
                             for k, v in batch.items()}
                    self.params, self.opt_state, metrics = self.train_step(
                        self.params, self.opt_state, batch)
                    self._sync()
                except Exception:
                    self.state.restarts += 1
                    if self.state.restarts > self.cfg.max_restarts:
                        raise
                    prefetch.stop()
                    resumed = self._try_resume()
                    self.state.step = resumed
                    prefetch = self._prefetcher(source, resumed)
                    continue

                dt = time.monotonic() - t0
                st = self.state
                if st.ewma_step_s == 0.0:
                    st.ewma_step_s = dt
                else:
                    a = self.cfg.ewma_alpha
                    if dt > self.cfg.straggler_factor * st.ewma_step_s:
                        st.stragglers.append(step)
                    st.ewma_step_s = (1 - a) * st.ewma_step_s + a * dt
                st.step = step + 1

                if (step + 1) % self.cfg.log_every == 0 or step == 0:
                    loss = float(metrics.get("loss", np.nan))
                    self.history.append({"step": step + 1, "loss": loss,
                                         "step_s": dt})
                if (step + 1) % self.cfg.ckpt_every == 0:
                    self._save(step + 1)
            if self.state.step % self.cfg.ckpt_every:
                self._save(self.state.step)
        finally:
            prefetch.stop()
        return self.state


def on_resize(ckpt_dir: str, like_tree: Any, *, host_id: int = 0) -> Any:
    """Elastic re-mesh: restore the latest checkpoint into the structure,
    dtypes and devices of ``like_tree``.  Checkpoints store full arrays,
    so any layout that preserves shapes is legal."""
    last = latest_step(ckpt_dir)
    if last is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return restore_checkpoint(ckpt_dir, last, like_tree, host_id=host_id)
