"""gemma3-27b  [dense]  (hf:google/gemma-3-27b family; assignment card: 62L
d_model=5376 32H GQA kv=16 d_ff=21504 vocab=262144 — 5:1 local:global
alternation, 128k context).

Local layers use a 1024-token sliding window; every 6th layer is global.
QK-norm, GEGLU MLP, embedding scaling per the gemma family.  (Gemma3 uses a
different rope theta for global layers — single theta here, noted in
DESIGN.md.)
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    mixer="attn",
    layer_pattern="LLLLLG",
    window=1024,
    qk_norm=True,
    rope_theta=1000000.0,
    mlp="geglu",
    tie_embeddings=True,
    embed_scale=True,
    max_seq_len=131072,
)
