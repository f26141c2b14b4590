"""starcoder2-3b [dense] — GQA kv=2, RoPE.  30L d_model=3072 24H
d_ff=12288 vocab=49152.  [arXiv:2402.19173]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24, n_kv_heads=2, head_dim=128,
    d_ff=12288,
    vocab=49152,
    ffn_act="gelu",
    ffn_gated=False,        # plain c_fc/c_proj MLP
    tie_embeddings=True,
    rope_theta=100000.0,
)
