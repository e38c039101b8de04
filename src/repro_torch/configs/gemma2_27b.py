"""gemma2-27b  [dense]  (arXiv:2408.00118; assignment card: 46L
d_model=4608 32H GQA kv=16 d_ff=36864 vocab=256000 — local/global
alternating, logit softcaps).

Alternating 4096-token sliding-window and global layers; attention logits
soft-capped at 50, final logits at 30; attn scale 1/sqrt(d_model/n_heads) =
1/12 per the gemma2 reference (query pre-scaling).
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    mixer="attn",
    layer_pattern="LG",
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    attn_scale=1.0 / (144.0 ** 0.5),   # (d_model/n_heads)^-0.5 = 144^-0.5
    rope_theta=10000.0,
    mlp="geglu",
    tie_embeddings=True,
    embed_scale=True,
    max_seq_len=8192,
)
