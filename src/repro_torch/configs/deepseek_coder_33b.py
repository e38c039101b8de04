"""deepseek-coder-33b  [dense]  (arXiv:2401.14196; assignment card: 62L
d_model=7168 56H GQA kv=8 d_ff=19200 vocab=32256 — llama architecture).
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    head_dim=128,
    d_ff=19200,
    vocab=32256,
    mixer="attn",
    rope_theta=100000.0,
    mlp="swiglu",
    tie_embeddings=False,
    max_seq_len=16384,
)
