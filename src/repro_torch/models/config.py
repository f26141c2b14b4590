"""Model configuration for every assigned architecture family.

A single dataclass covers dense / GQA / MLA attention, dense & MoE FFN,
Mamba2 (SSD) blocks, hybrid interleaves, encoder-decoder stacks, and stub
multimodal frontends.  Heterogeneous stacks are expressed as a repeating
``block_pattern`` of :class:`LayerSpec` (scan over periods, unroll within a
period) plus optional un-scanned ``first_k_dense`` prefix layers.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside a repeating block pattern."""

    kind: str = "attn"          # "attn" | "mamba"
    ffn: str = "dense"          # "dense" | "moe" | "none"
    window: Optional[int] = None  # sliding-window size for local attention
    cross_attn: bool = False      # decoder layers of an enc-dec stack


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    expert_d_ff: int = 0          # 0 -> use model d_ff
    num_shared: int = 0           # shared (always-on) experts
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0          # 0 -> full-rank q projection


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64            # P
    expand: int = 2               # d_inner = expand * d_model
    n_groups: int = 1             # B/C groups (G)
    conv_width: int = 4
    chunk: int = 128              # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0             # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False

    # Attention extras
    attn_logit_softcap: float = 0.0      # 0 disables (gemma2: 50.0)
    final_logit_softcap: float = 0.0     # (gemma2: 30.0)
    post_norm: bool = False              # gemma2-style post-layer norms
    mla: Optional[MLAConfig] = None

    # FFN / MoE
    moe: Optional[MoEConfig] = None
    first_k_dense: int = 0               # deepseek-v2: first layer dense
    first_dense_d_ff: int = 0
    ffn_act: str = "silu"                # silu | gelu
    ffn_gated: bool = True               # False -> plain 2-matrix MLP

    # SSM / hybrid
    ssm: Optional[SSMConfig] = None
    block_pattern: Tuple[LayerSpec, ...] = ()   # empty -> homogeneous

    # Encoder-decoder
    encdec: bool = False
    n_enc_layers: int = 0
    enc_seq_divisor: int = 4             # encoder frames = seq // divisor

    # Multimodal stub frontend
    num_media_tokens: int = 0            # vlm: patch positions carved from seq

    # Numerics
    dtype: str = "bfloat16"

    # ---- derived helpers -------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding tables padded to a multiple of 256 so the vocab dim
        shards on 16/256-way meshes.  Padded logit
        columns are masked to -inf in the loss."""
        return -(-self.vocab // 256) * 256

    @property
    def pattern(self) -> Tuple[LayerSpec, ...]:
        if self.block_pattern:
            return self.block_pattern
        ffn = "moe" if (self.moe is not None) else ("none" if self.family == "ssm" else "dense")
        kind = "mamba" if self.family == "ssm" else "attn"
        return (LayerSpec(kind=kind, ffn=ffn),)

    @property
    def n_scanned_layers(self) -> int:
        return self.n_layers - self.first_k_dense

    @property
    def n_periods(self) -> int:
        period = len(self.pattern)
        n = self.n_scanned_layers
        assert n % period == 0, (
            f"{self.name}: {n} scanned layers not divisible by pattern period {period}")
        return n // period

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # A reduced config of the same family for CPU smoke tests.
    def smoke(self) -> "ModelConfig":
        period = len(self.pattern)
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe, num_experts=min(moe.num_experts, 4),
                top_k=min(moe.top_k, 2),
                expert_d_ff=min(moe.expert_d_ff or 128, 128),
                num_shared=min(moe.num_shared, 1),
                shared_d_ff=min(moe.shared_d_ff or 128, 128))
        mla = self.mla
        if mla is not None:
            mla = MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                            v_head_dim=16)
        ssm = self.ssm
        if ssm is not None:
            ssm = dataclasses.replace(ssm, d_state=16, head_dim=8, chunk=16)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        pattern = tuple(
            dataclasses.replace(s, window=(32 if s.window else None))
            for s in self.block_pattern) or ()
        return self.replace(
            name=self.name + "-smoke",
            n_layers=(2 * period + self.first_k_dense
                      if self.first_k_dense else 2 * period),
            d_model=64, n_heads=n_heads, n_kv_heads=n_kv, head_dim=16,
            d_ff=128, vocab=256, moe=moe, mla=mla, ssm=ssm,
            block_pattern=pattern,
            n_enc_layers=min(self.n_enc_layers, 2),
            first_dense_d_ff=128 if self.first_dense_d_ff else 0,
            num_media_tokens=8 if self.num_media_tokens else 0,
        )
