"""musicgen-large  [audio]  (arXiv:2306.05284; assignment card: 48L
d_model=2048 32H GQA kv=32 d_ff=8192 vocab=2048 — decoder-only over EnCodec
tokens).

Backbone only: the EnCodec tokenizer/delay-pattern frontend is a stub —
``input_specs`` provides precomputed frame embeddings (sum of the 4 codebook
embeddings), so ``input_mode="embeddings"``.  The LM head predicts one
2048-entry codebook (per-codebook heads are frontend territory).
MusicGen uses full MHA (kv == heads) and GELU MLPs, sinusoidal positions in
the original; we use RoPE as the positional backbone (noted in DESIGN.md).
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    head_dim=64,
    d_ff=8192,
    vocab=2048,
    mixer="attn",
    mlp="gelu",
    tie_embeddings=False,
    input_mode="embeddings",
    max_seq_len=32768,
)
