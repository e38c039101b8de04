"""qwen3-moe-235b-a22b  [moe]  (hf:Qwen/Qwen3-235B-A22B family; assignment
card: 94L d_model=4096 64H GQA kv=4 d_ff=1536 vocab=151936, MoE 128 experts
top-8).

128 experts shard exactly 8-per-device over the 16-way model axis.  QK-norm
per qwen3.
"""

from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv=4,
    head_dim=128,
    d_ff=0,
    vocab=151936,
    mixer="attn",
    qk_norm=True,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536,
                  router_norm_topk=True),
    rope_theta=1000000.0,
    mlp="swiglu",
    tie_embeddings=False,
    max_seq_len=131072,
)
