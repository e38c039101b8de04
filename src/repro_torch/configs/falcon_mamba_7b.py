"""falcon-mamba-7b  [ssm]  (arXiv:2410.05355; assignment card: 64L
d_model=4096 attn-free d_ff=0 vocab=65024, ssm_state=16 — mamba1).

Pure Mamba-1 stack: every layer is norm -> mamba mixer -> residual (no
attention, no MLP; d_inner = 2 x d_model = 8192).  O(1)-state decode makes
this arch the canonical ``long_500k`` runner.
"""

from ..models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv=0,
    d_ff=0,
    vocab=65024,
    mixer="mamba",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=True,
    max_seq_len=1 << 20,
)
