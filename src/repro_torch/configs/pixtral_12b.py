"""pixtral-12b [vlm] — pixtral-ViT frontend (STUB) + mistral-nemo decoder.
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
[hf:mistralai/Pixtral-12B-2409]  1024 patch positions carved out of the
sequence; input_specs provides precomputed patch embeddings."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1000000.0,
    num_media_tokens=1024,
)
