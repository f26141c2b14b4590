"""gemma2-9b [dense] — local+global alternating attention, logit softcaps.
42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.  [arXiv:2408.00118]
head_dim=256, sliding window 4096 on local layers, attn softcap 50,
final-logit softcap 30, pre+post layer norms, GeGLU, tied embeddings."""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336,
    vocab=256000,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_norm=True,
    tie_embeddings=True,
    ffn_act="gelu",
    block_pattern=(LayerSpec(kind="attn", ffn="dense", window=4096),
                   LayerSpec(kind="attn", ffn="dense")),
)
