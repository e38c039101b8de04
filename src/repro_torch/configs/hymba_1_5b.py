"""hymba-1.5b  [hybrid]  (arXiv:2411.13676; assignment card: 32L
d_model=1600 25H GQA kv=5 d_ff=5504 vocab=32001, ssm_state=16 — parallel
attention + mamba heads).

Every layer runs attention and an SSM head in parallel on the same input and
averages the outputs.  Hymba uses sliding-window attention in all but 3
full-attention layers (first / middle / last) — encoded in the pattern.
"""

from ..models.config import ArchConfig, SSMConfig

_PAT = ["L"] * 32
for _i in (0, 15, 31):
    _PAT[_i] = "G"

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    mixer="hymba",
    layer_pattern="".join(_PAT),
    window=1024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    rope_theta=10000.0,
    mlp="swiglu",
    tie_embeddings=True,
    max_seq_len=1 << 20,
)
