"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128.  [arXiv:2405.21060]
d_inner = 2*d_model = 4096, head_dim 64 -> 64 SSD heads."""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1, n_kv_heads=1,       # no attention layers
    d_ff=0,
    vocab=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk=256),
)
