"""LM demo engine: continuous prefill+decode over a token-request queue.

The port of the JAX package's ``repro.serve.lm_engine``, semantics kept:
a fixed decode batch of ``slots``; a finished or empty slot is refilled by
prefilling one queued request at batch 1 and splicing its cache rows into
the slot (every cache leaf whose second dim is ``slots``: k/v and the
Mamba state ``ssm_conv``/``ssm_h``, each cast into the slot's dtype as
JAX's ``.at[:, s].set`` casts); decoding is greedy (the first index on
ties).  Every configuration runs (the ``attn``, ``mamba`` and ``hymba``
mixers, dense and MoE MLPs).  Prefill runs the flash-attention kernel K6
in every self-attention layer and the selective-scan kernel K7 in every
Mamba mixer; decode runs the port's ``blockwise_attention`` over the
cache and the Mamba mixer's one-step recurrence.  The MoE MLP is
row-local: a slot's tokens are dispatched apart from the other slots'.

``cache["len"]`` is one length for all slots: each refill sets it to that
request's prompt length, as the JAX package does.  Attention reads it, so
for the ``attn`` and ``hymba`` mixers the engine is right only when every
prompt has one length and every request one ``max_new`` (a fault of the
JAX demo, kept).  The ``mamba`` mixer (falcon-mamba-7b) reads no
position: there prompts of mixed lengths are served right.

The engine holds a ``compute_dtype`` copy, made once, of the leaves the
model casts at every use (``models.cast_for_compute``).  The device is
resolved when the engine is built: ``device="cuda"`` (the default) raises
without a card.

.. deprecated::
    ``repro_torch.serve`` names the exploration serving subsystem; the
    package-level ``ServeEngine`` / ``Request`` names and
    ``repro_torch.serve.engine`` warn ``DeprecationWarning``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ArchConfig
from ..models.model import decode_step, init_cache, prefill
from ..models.transformer import DecoderLM, cast_for_compute

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params: DecoderLM, *, slots: int = 4,
                 smax: int = 512, compute_dtype=torch.bfloat16,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = cast_for_compute(params, cfg, compute_dtype).to(
            self.device)
        self.slots = slots
        self.smax = smax
        self.compute_dtype = compute_dtype
        self.queue: List[Request] = []
        self.all_requests: List[Request] = []
        self.active: List[Optional[Request]] = [None] * slots
        self.remaining = np.zeros(slots, np.int32)
        self.cache = init_cache(cfg, slots, smax, compute_dtype,
                                device=self.device)
        self.last_tok = torch.zeros((slots,), dtype=torch.int64,
                                    device=self.device)

    def submit(self, req: Request) -> None:
        self.queue.append(req)
        self.all_requests.append(req)

    def _refill(self) -> None:
        for s in range(self.slots):
            if self.active[s] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            toks = torch.as_tensor(np.asarray(req.prompt),
                                   device=self.device)[None]
            logits, c1 = prefill(self.params, self.cfg, toks, smax=self.smax,
                                 compute_dtype=self.compute_dtype)
            # splice the slot's cache rows
            for key, dst in self.cache.items():
                if key != "len" and dst.ndim >= 2 \
                        and dst.shape[1] == self.slots:
                    dst[:, s] = c1[key][:, 0]
            # one length for every slot: the last refill's prompt length
            self.cache["len"] = torch.tensor(len(req.prompt),
                                             dtype=torch.int32)
            tok = torch.argmax(logits[0])
            self.last_tok[s] = tok
            req.out.append(int(tok))
            self.active[s] = req
            self.remaining[s] = req.max_new - 1

    def step(self) -> int:
        """One decode step for the whole batch; returns #active slots."""
        self._refill()
        if all(a is None for a in self.active):
            return 0
        logits, self.cache = decode_step(self.params, self.cfg,
                                         self.last_tok, self.cache,
                                         compute_dtype=self.compute_dtype)
        self.last_tok = torch.argmax(logits, dim=-1)
        n_active = 0
        toks = self.last_tok.cpu().numpy()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(int(toks[s]))
            self.remaining[s] -= 1
            if self.remaining[s] <= 0:
                req.done = True
                self.active[s] = None
            else:
                n_active += 1
        return n_active

    def run(self, max_steps: int = 256) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            if not self.queue and all(a is None for a in self.active):
                break
            self.step()
        return {r.rid: r.out for r in self.all_requests}
