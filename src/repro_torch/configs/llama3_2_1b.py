"""llama3.2-1b  [dense]  (hf:meta-llama/Llama-3.2-1B; assignment card: 16L
d_model=2048 32H GQA kv=8 d_ff=8192 vocab=128256).
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv=8,
    head_dim=64,
    d_ff=8192,
    vocab=128256,
    mixer="attn",
    rope_theta=500000.0,
    mlp="swiglu",
    tie_embeddings=True,
    max_seq_len=131072,
)
