"""Architecture configuration schema for the model zoo.

One frozen dataclass describes every assigned architecture (dense / MoE /
SSM / hybrid / VLM / audio backbones).  A copy of the JAX package's
``repro.models.config``: the port imports nothing of that package.  Exact per-arch values live in
``repro_torch/configs/<id>.py``; reduced smoke variants derive via ``reduced()``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden dim
    n_shared: int = 0              # shared (always-on) experts
    d_shared: int = 0              # shared-expert hidden dim (total)
    capacity_factor: float = 1.25
    router_norm_topk: bool = True  # renormalize top-k probs (qwen)

    @property
    def n_experts_padded(self) -> int:
        """Experts padded up for even expert-parallel sharding (qwen2's 60
        experts pad to 64; the 4 pads are masked with -inf router logits)."""
        n = self.n_experts
        pad = 1
        while pad < n:
            pad *= 2
        return n if n % 16 == 0 else min(pad, ((n + 15) // 16) * 16)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                # d_inner = expand * d_model
    dt_rank: Optional[int] = None  # default ceil(d_model / 16)

    def dt_rank_of(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank is not None else -(-d_model // 16)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                   # 0 for attn-free archs
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # mixer layout ---------------------------------------------------------
    mixer: str = "attn"            # attn | mamba | hymba (parallel attn+ssm)
    layer_pattern: str = "G"       # repeating local/global string, e.g.
                                   # "LLLLLG" (gemma3 5:1), "LG" (gemma2)
    window: int = 0                # sliding-window size for 'L' layers
    ssm: Optional[SSMConfig] = None
    moe: Optional[MoEConfig] = None

    # attention details -----------------------------------------------------
    rope_theta: float = 10000.0
    attn_softcap: float = 0.0      # gemma2: 50.0
    qk_norm: bool = False          # gemma3
    attn_scale: float = 0.0        # 0 -> 1/sqrt(head_dim)

    # mlp -------------------------------------------------------------------
    mlp: str = "swiglu"            # swiglu | gelu | geglu
    # embeddings / output ------------------------------------------------------
    tie_embeddings: bool = True
    final_softcap: float = 0.0     # gemma2: 30.0
    embed_scale: bool = False      # gemma: x *= sqrt(d_model)
    norm_eps: float = 1e-6
    # cross-attention (VLM backbone) -----------------------------------------
    cross_attn_every: int = 0      # insert 1 cross-attn layer per N layers
    encoder_len: int = 0           # stub patch/frame sequence length
    # frontend stub -------------------------------------------------------------
    input_mode: str = "tokens"     # tokens | embeddings (audio/vlm stub)
    # training ---------------------------------------------------------------
    max_seq_len: int = 131072

    # -- derived -------------------------------------------------------------
    @property
    def head_dim_of(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def n_self_layers(self) -> int:
        if self.cross_attn_every:
            g = self.cross_attn_every
            return self.n_layers * (g - 1) // g
        return self.n_layers

    @property
    def n_cross_layers(self) -> int:
        return self.n_layers - self.n_self_layers if self.cross_attn_every else 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic (or window/state-capped) long-context decode."""
        if self.mixer in ("mamba", "hymba"):
            return True
        # mostly-local alternating patterns are window-capped except for a
        # linear number of global-layer reads — linear, not quadratic
        return "L" in self.layer_pattern

    def layer_kinds(self) -> Tuple[int, ...]:
        """Per self-attn-layer flag: 1 = global attention, 0 = local."""
        pat = self.layer_pattern or "G"
        n = self.n_self_layers if self.mixer != "mamba" else self.n_layers
        return tuple(1 if pat[i % len(pat)] == "G" else 0 for i in range(n))

    def reduced(self, *, n_layers: int = 2, d_model: int = 64,
                n_heads: int = 0, d_ff: int = 128, vocab: int = 256,
                seq: int = 0) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        heads = n_heads or max(2, min(4, self.n_heads or 2))
        kv = max(1, min(self.n_kv, heads)) if self.n_kv else heads
        while heads % kv:
            kv -= 1
        if self.cross_attn_every:
            # keep full (g-1 self + 1 cross) groups in the reduced model
            n_layers = self.cross_attn_every * max(
                1, n_layers // self.cross_attn_every)
        updates = dict(
            n_layers=n_layers, d_model=d_model, n_heads=heads if self.n_heads else 0,
            n_kv=kv if self.n_kv else 0, d_ff=d_ff, vocab=vocab,
            head_dim=(d_model // heads) if self.n_heads else 0,
            window=min(self.window, 16) if self.window else 0,
            encoder_len=min(self.encoder_len, 8) if self.encoder_len else 0,
            cross_attn_every=self.cross_attn_every,
            max_seq_len=max(seq, 64),
        )
        if self.moe is not None:
            updates["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=min(2, self.moe.top_k),
                d_expert=32, d_shared=32 if self.moe.n_shared else 0)
        if self.ssm is not None:
            updates["ssm"] = dataclasses.replace(self.ssm, d_state=4, d_conv=2)
        return dataclasses.replace(self, **updates)
