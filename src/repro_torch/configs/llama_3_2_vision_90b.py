"""llama-3.2-vision-90b  [vlm]  (hf:meta-llama/Llama-3.2-11B-Vision scaled;
assignment card: 100L d_model=8192 64H GQA kv=8 d_ff=28672 vocab=128256,
cross-attn image layers).

Backbone only: the vision tower is a stub — ``input_specs`` provides
precomputed patch embeddings (B, encoder_len, d_model).  One gated
cross-attention layer is inserted every 5 layers (80 self + 20 cross = 100).
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    mixer="attn",
    layer_pattern="G",
    rope_theta=500000.0,
    mlp="swiglu",
    tie_embeddings=False,
    cross_attn_every=5,
    encoder_len=1600,          # ~4 tiles x 400 patches, pre-projected stub
    max_seq_len=131072,
)
