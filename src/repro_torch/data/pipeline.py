"""Deterministic token data pipeline (synthetic + memmap-backed).

Production shape: each host reads only its shard of the global batch
(``host_batch = global_batch / n_hosts``), steps are addressable by index
(resume = seek, no state files), and a background prefetch thread keeps one
batch ahead of the training loop.

Two sources:
* ``SyntheticLM`` — counter-seeded random tokens with a learnable bigram
  structure (so loss visibly decreases in the examples);
* ``MemmapLM`` — flat binary token file (np.uint16/uint32 memmap), sliced
  into (batch, seq+1) windows; the standard packed-corpus format.

A copy of the JAX package's ``repro.data.pipeline`` (numpy only; batches
byte-identical), with one addition: ``Prefetcher(timeout=...)`` raises
``TimeoutError`` when no batch arrives in time, where the reference
waits forever.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    path: Optional[str] = None      # memmap file -> MemmapLM

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticLM:
    """Markov-ish synthetic stream: next ~ (5*cur + noise) % vocab."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + cfg.host_id)
        b, s = cfg.host_batch, cfg.seq_len
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, b)
        noise = rng.integers(0, 3, (b, s))
        for t in range(1, s):
            toks[:, t] = (5 * toks[:, t - 1] + noise[:, t]) % cfg.vocab
        return {"inputs": toks, "targets": toks.copy()}


class MemmapLM:
    def __init__(self, cfg: DataConfig, dtype=np.uint16):
        assert cfg.path is not None
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=dtype, mode="r")
        self.n_windows = (len(self.data) - 1) // cfg.seq_len

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b, s = cfg.host_batch, cfg.seq_len
        rng = np.random.default_rng(cfg.seed * 7 + step)
        idx = rng.integers(0, self.n_windows, cfg.global_batch)
        idx = idx[cfg.host_id * b:(cfg.host_id + 1) * b]
        toks = np.stack([np.asarray(self.data[i * s: i * s + s],
                                    dtype=np.int32) for i in idx])
        return {"inputs": toks, "targets": toks.copy()}


class Prefetcher:
    """One-batch-ahead background prefetch with step-indexed resume."""

    def __init__(self, source, start_step: int = 0, depth: int = 2,
                 timeout: Optional[float] = None):
        self.source = source
        self.timeout = timeout
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        try:
            return self.q.get(timeout=self.timeout)
        except queue.Empty:
            raise TimeoutError(f"no batch within {self.timeout} s") from None

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


def make_source(cfg: DataConfig):
    return MemmapLM(cfg) if cfg.path else SyntheticLM(cfg)
