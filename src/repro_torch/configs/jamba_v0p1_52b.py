"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.  [arXiv:2403.19887]

Period-8 block: one attention layer per 8 (index 2 ~ Jamba's placement),
MoE FFN on every other layer (odd indices) -> 16 MoE layers total.
"""
from ..models.config import LayerSpec, ModelConfig, MoEConfig, SSMConfig


def _pattern():
    specs = []
    for i in range(8):
        kind = "attn" if i == 2 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        specs.append(LayerSpec(kind=kind, ffn=ffn))
    return tuple(specs)


CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336,
    vocab=65536,
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=14336),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk=256),
    block_pattern=_pattern(),
)
