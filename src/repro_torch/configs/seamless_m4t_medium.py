"""seamless-m4t-medium [audio] — encoder-decoder, multimodal backbone.
12L (x2: encoder+decoder) d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
[arXiv:2308.11596]  Frontend is a STUB: input_specs provides precomputed
frame embeddings (B, seq/4, d_model); encoder is bidirectional."""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    encdec=True,
    n_layers=12,
    n_enc_layers=12,
    d_model=1024,
    n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096,
    vocab=256206,
    enc_seq_divisor=4,
    block_pattern=(LayerSpec(kind="attn", ffn="dense", cross_attn=True),),
)
