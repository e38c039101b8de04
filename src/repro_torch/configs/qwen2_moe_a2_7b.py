"""qwen2-moe-a2.7b  [moe]  (hf:Qwen/Qwen1.5-MoE-A2.7B; assignment card: 24L
d_model=2048 16H GQA kv=16 d_ff=1408 vocab=151936, MoE 60 experts top-4 +
4 shared experts).

60 routed experts pad to 64 for even expert-parallel sharding over the
16-way model axis (padded experts are masked to -inf in the router).  The 4
shared experts form one dense FFN of 4 x 1408 = 5632 hidden units gated by a
sigmoid (matching the HF reference implementation).
"""

from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    head_dim=128,
    d_ff=0,                      # all FFN capacity lives in the experts
    vocab=151936,
    mixer="attn",
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                  n_shared=4, d_shared=5632, router_norm_topk=True),
    rope_theta=1000000.0,
    mlp="swiglu",
    tie_embeddings=False,
    max_seq_len=32768,
)
