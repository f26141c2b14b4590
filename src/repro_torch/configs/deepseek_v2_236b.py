"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 160 routed experts top-6
+ 2 shared.  60L d_model=5120 128H vocab=102400 expert d_ff=1536.
First layer dense (d_ff=12288).  [arXiv:2405.04434]"""
from ..models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128, n_kv_heads=128,
    d_ff=1536,
    vocab=102400,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, expert_d_ff=1536,
                  num_shared=2, shared_d_ff=1536, capacity_factor=1.5),
    first_k_dense=1,
    first_dense_d_ff=12288,
)
