"""Encoder-decoder assembly (seamless-m4t backbone).

Ported from ``repro.models.encdec``.  The modality frontend is a stub,
as in the reference: the encoder takes precomputed frame embeddings
(B, S_enc, D).  The encoder is a stack of bidirectional attention + FFN
layers (``ENC_SPEC``, ``causal=False``, RoPE at ``arange(S_enc)``) and a
final RMSNorm; the decoder is ``transformer.py``'s stack, whose layers
carry cross-attention (``LayerSpec(cross_attn=True)``).

The encoder's layers are one stacked tree of shape (n_enc_layers, ...),
as the reference's ``stack_pspecs``, so its weights carry across one to
one; the reference's ``lax.scan`` over them is a Python loop over
``index_tree(blocks, i)`` (views, no copies).  That scan's carry starts
as the frames cast to bf16 and must keep its dtype, so the reference
raises ``TypeError`` when a layer's weights are not bf16 (bf16 x f32
promotes the carry to f32); :func:`encoder_forward` raises the same
error for the same params before any work.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .config import LayerSpec, ModelConfig
from .layers import init_rmsnorm, rmsnorm
from .params import Initializer, ParamTree, index_tree, stack_draws
from .transformer import init_layer, init_lm_cache, layer_forward, \
    lm_forward, lm_tree

ENC_SPEC = LayerSpec(kind="attn", ffn="dense")
CARRY_DTYPE = torch.bfloat16       # the reference scan's carry


def init_encdec(seed: int, cfg: ModelConfig, device="cuda") -> ParamTree:
    """``{"encoder": {"blocks": (n_enc_layers, ...) stack, "final_norm"},
    "decoder": init_lm's tree}`` in bf16 (norm scales f32), drawn from
    ``seed``, the encoder first; nothing allocated on ``meta``."""
    ini = Initializer(seed, device, dtype=torch.bfloat16)
    encoder = {
        "blocks": stack_draws(lambda: init_layer(ini, cfg, ENC_SPEC),
                              cfg.n_enc_layers),
        "final_norm": init_rmsnorm(ini, cfg.d_model),
    }
    return ParamTree({"encoder": encoder, "decoder": lm_tree(ini, cfg)})


def _leaves(tree, prefix=""):
    if isinstance(tree, ParamTree):
        yield from ((prefix + k, v) for k, v in tree.named_parameters())
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix.rstrip("."), tree


def encoder_forward(params, cfg: ModelConfig,
                    frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_enc, D) stub-frontend embeddings -> (B, S_enc, D) in
    bf16.  Raises ``TypeError`` on a weight that is not bf16 (module
    docstring; the norms' scales are f32 in every tree and cast back)."""
    blocks = params["blocks"]
    wrong = {k: v.dtype for k, v in _leaves(blocks)
             if not k.endswith("scale") and v.dtype != CARRY_DTYPE}
    if wrong:
        raise TypeError(
            f"the encoder's carry is {CARRY_DTYPE} (the frames' cast) and "
            f"these weights would promote it: {wrong}")
    x = frames.to(CARRY_DTYPE)
    for i in range(cfg.n_enc_layers):
        x, _, _ = layer_forward(index_tree(blocks, i), cfg, ENC_SPEC, x, 0,
                                causal=False)
    return rmsnorm(params["final_norm"], x, cfg.rms_eps)


def encdec_forward(params, cfg: ModelConfig, frames: Optional[torch.Tensor],
                   tokens: torch.Tensor, start: int = 0, cache=None,
                   aux_loss: bool = True
                   ) -> Tuple[torch.Tensor, Optional[dict], dict]:
    """Prefill / forward: frames given, the encoder runs and each
    cross-attention layer's projection is written to the cache.  Decode:
    frames None, the decoder reads the cache's (``transformer.py``'s
    rules).  Returns ``lm_forward``'s (logits, cache, metrics)."""
    enc_out = None
    if frames is not None:
        enc_out = encoder_forward(params["encoder"], cfg, frames)
    return lm_forward(params["decoder"], cfg, tokens, start, cache=cache,
                      enc_out=enc_out, aux_loss=aux_loss)


def init_encdec_cache(cfg: ModelConfig, batch: int, cap: int, enc_cap: int,
                      device="cuda"):
    return init_lm_cache(cfg, batch, cap, device, enc_cap=enc_cap)
