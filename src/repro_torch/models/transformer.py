"""Decoder-only transformer assembly, for the dense GQA architectures.

Ported from ``repro.models.transformer``.  As there, ``init_lm`` stacks
each pattern position's layers into ``(n_periods, ...)`` (gemma2's
local/global alternation is a pattern of two), so the reference's
weights carry across one to one.  The reference's ``lax.scan`` over
periods is a Python loop over period ``i`` that indexes the stacked
parameters and caches (views, no copies), with the pattern unrolled
inside.

What the port runs: attention layers (``kind="attn"``) with a dense or
MoE FFN (``models/moe.py::moe_ffn``), with or without gemma2's
post-norms, tied or untied embeddings and the final logit softcap:
gemma2-9b, llama3-8b, deepseek-7b, starcoder2-3b and phi3.5-MoE end to
end.  What raises ``NotImplementedError`` (ROADMAP Queue 1 item 8):
mamba layers (mamba2, jamba), MLA (deepseek-v2), cross-attention and
``encdec.py`` (seamless), ``media_embeds`` (pixtral).

Metrics, as the reference's: ``aux_loss`` and ``dropped`` summed over
the layers, and for a config with ``moe`` set ``expert_counts`` of shape
(n_periods, E), each period's pattern positions summed.  A dense config
launches nothing for them (host zeros, made tensors once at the end).

Caches hold one extra entry beside the reference's tree: ``"filled"``,
a host-side count of the contiguous prefix of slots that prefill and
decode have written (slots ``0..filled-1`` hold positions
``0..filled-1``).  A decode past it raises instead of reading a gap.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .attention import gqa_forward, init_attention
from .config import LayerSpec, ModelConfig
from .layers import embed, ffn, init_embedding, init_ffn, init_rmsnorm, \
    init_unembed, rmsnorm, softcap, unembed
from .moe import init_moe, moe_ffn
from .params import Initializer, ParamTree, index_tree, stack_draws, \
    stack_pspecs

CACHE_DTYPE = torch.bfloat16       # the reference's cache dtype


def _unported(cfg: ModelConfig, spec: LayerSpec) -> None:
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet (ROADMAP Queue 1 "
            f"item 8: models/attention.py mla_forward)")
    if spec.kind != "attn":
        raise NotImplementedError(
            f"{cfg.name}: {spec.kind} layers inside the transformer are not "
            f"ported yet (ROADMAP Queue 1 item 8: mamba layers through "
            f"models/ssd.py)")
    if spec.cross_attn:
        raise NotImplementedError(
            f"{cfg.name}: cross-attention is not ported yet (ROADMAP Queue 1 "
            f"item 8: encdec.py)")


# ---------------------------------------------------------------------------
# Per-layer init
# ---------------------------------------------------------------------------

def init_layer(ini: Initializer, cfg: ModelConfig, spec: LayerSpec,
               d_ff_override: int = 0):
    _unported(cfg, spec)
    p = {"attn_norm": init_rmsnorm(ini, cfg.d_model),
         "attn": init_attention(ini, cfg)}
    if cfg.post_norm:
        p["attn_post_norm"] = init_rmsnorm(ini, cfg.d_model)
    if spec.ffn != "none":
        p["ffn_norm"] = init_rmsnorm(ini, cfg.d_model)
        if spec.ffn == "moe":
            p["ffn"] = init_moe(ini, cfg)
        else:
            p["ffn"] = init_ffn(ini, cfg.d_model,
                                d_ff_override or cfg.d_ff,
                                gated=cfg.ffn_gated)
        if cfg.post_norm:
            p["ffn_post_norm"] = init_rmsnorm(ini, cfg.d_model)
    return p


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, cap: int,
                     device="cuda"):
    """Cache tree for one layer: bf16 k and v, and ``pos`` (-1 = empty)."""
    _unported(cfg, spec)
    shape = (batch, cap, cfg.n_kv_heads, cfg.head_dim_)
    return {"kv": {
        "k": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
        "v": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
        "pos": torch.full((cap,), -1, dtype=torch.int32, device=device),
    }}


# ---------------------------------------------------------------------------
# Per-layer forward
# ---------------------------------------------------------------------------

def layer_forward(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                  start: int = 0, cache=None, enc_out=None,
                  causal: bool = True, aux_loss: bool = True):
    """Returns (x, new_cache, metrics); ``start`` is the position of x's
    first token.  The cache is written in place.  A dense layer adds no
    aux loss and drops nothing: its metrics are host zeros, so a decode
    step launches no kernels for them.  A MoE layer's metrics are
    ``moe_ffn``'s (``aux_loss=False`` skips its load-balance loss)."""
    _unported(cfg, spec)
    if enc_out is not None:
        raise NotImplementedError(
            "enc_out (encoder-decoder stacks) is not ported yet: ROADMAP "
            "Queue 1 item 8")
    new_cache = {} if cache is not None else None
    h = rmsnorm(p["attn_norm"], x, cfg.rms_eps)
    a, kvc = gqa_forward(p["attn"], cfg, h, start, window=spec.window,
                         cache=cache["kv"] if cache is not None else None,
                         causal=causal)
    if cfg.post_norm:
        a = rmsnorm(p["attn_post_norm"], a, cfg.rms_eps)
    x = x + a
    if new_cache is not None:
        new_cache["kv"] = kvc
    metrics = {"aux_loss": 0.0, "dropped": 0.0}
    if spec.ffn != "none":
        h = rmsnorm(p["ffn_norm"], x, cfg.rms_eps)
        if spec.ffn == "moe":
            f, metrics = moe_ffn(p["ffn"], h, cfg, aux_loss)
        else:
            f = ffn(p["ffn"], h, cfg.ffn_act)
        if cfg.post_norm:
            f = rmsnorm(p["ffn_post_norm"], f, cfg.rms_eps)
        x = x + f
    return x, new_cache, metrics


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

def init_lm(seed: int, cfg: ModelConfig, device="cuda") -> ParamTree:
    """Embeddings, the unrolled prefix layers and per-pattern-position
    stacks of shape (n_periods, ...), in bf16 (MoE routers f32), drawn
    from ``seed``.  Each stack is filled one drawn layer at a time, so
    the peak is the params plus one layer.  On the ``meta`` device
    nothing is allocated (parameter counts)."""
    ini = Initializer(seed, device, dtype=torch.bfloat16)
    params = {
        "embed": init_embedding(ini, cfg.padded_vocab, cfg.d_model),
        "final_norm": init_rmsnorm(ini, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_unembed(ini, cfg.d_model, cfg.padded_vocab)
    dense_spec = LayerSpec(kind="attn", ffn="dense")
    for i in range(cfg.first_k_dense):
        params[f"prefix{i}"] = init_layer(
            ini, cfg, dense_spec, d_ff_override=cfg.first_dense_d_ff)
    params["blocks"] = {
        f"pos{pos}": stack_draws(lambda: init_layer(ini, cfg, spec),
                                 cfg.n_periods)
        for pos, spec in enumerate(cfg.pattern)}
    return ParamTree(params)


def init_lm_cache(cfg: ModelConfig, batch: int, cap: int, device="cuda"):
    cache = {}
    dense_spec = LayerSpec(kind="attn", ffn="dense")
    for i in range(cfg.first_k_dense):
        cache[f"prefix{i}"] = init_layer_cache(cfg, dense_spec, batch, cap,
                                               device)
    cache["blocks"] = {
        f"pos{pos}": stack_pspecs([
            init_layer_cache(cfg, spec, batch, cap, device)
            for _ in range(cfg.n_periods)])
        for pos, spec in enumerate(cfg.pattern)}
    cache["filled"] = 0
    return cache


# ---------------------------------------------------------------------------
# Whole-model forward
# ---------------------------------------------------------------------------

def _capacity(cache) -> int:
    """Slots of a cache tree from ``init_lm_cache`` (every layer's the same)."""
    layer = (cache["prefix0"] if "prefix0" in cache
             else next(iter(cache["blocks"].values())))
    return layer["kv"]["pos"].shape[-1]


def lm_forward(params, cfg: ModelConfig, tokens: torch.Tensor,
               start: int = 0, cache=None,
               media_embeds: Optional[torch.Tensor] = None,
               enc_out=None, remat: bool = False, aux_loss: bool = True
               ) -> Tuple[torch.Tensor, Optional[dict], dict]:
    """tokens: (B, S); ``start``: the position of the first token (0 for
    prefill and forward, ``pos`` for a decode step).  ``remat`` changes
    nothing without a backward pass; ``aux_loss=False`` skips the MoE
    layers' load-balance loss (the metric stays 0).  Returns (logits,
    cache, metrics); the cache is written in place and returned."""
    if media_embeds is not None:
        raise NotImplementedError(
            "media_embeds (pixtral's stub frontend) is not ported yet: "
            "ROADMAP Queue 1 item 8")
    if enc_out is not None:
        raise NotImplementedError(
            "enc_out (encoder-decoder stacks) is not ported yet: ROADMAP "
            "Queue 1 item 8")
    B, S = tokens.shape
    if cache is not None and start > cache["filled"]:
        raise ValueError(
            f"a step at position {start} would leave a gap: the cache holds "
            f"the contiguous positions 0..{cache['filled'] - 1}")
    if cache is not None and start + S > _capacity(cache):
        raise ValueError(
            f"a step writing positions {start}..{start + S - 1} overflows "
            f"the cache's {_capacity(cache)} slots")
    x = embed(params["embed"], tokens)

    # host zeros until a MoE layer adds a tensor
    aux, dropped, counts = 0.0, 0.0, []
    dense_spec = LayerSpec(kind="attn", ffn="dense")
    for i in range(cfg.first_k_dense):
        c = cache[f"prefix{i}"] if cache is not None else None
        x, _, m = layer_forward(params[f"prefix{i}"], cfg, dense_spec, x,
                                start, c, aux_loss=aux_loss)
        aux = aux + m["aux_loss"]
    blocks = params["blocks"]
    for i in range(cfg.n_periods):
        period = None
        for pos, spec in enumerate(cfg.pattern):
            key = f"pos{pos}"
            c = (index_tree(cache["blocks"][key], i) if cache is not None
                 else None)
            x, _, m = layer_forward(index_tree(blocks[key], i), cfg, spec, x,
                                    start, c, aux_loss=aux_loss)
            aux = aux + m["aux_loss"]
            dropped = dropped + m["dropped"]
            if "expert_counts" in m:
                period = (m["expert_counts"] if period is None
                          else period + m["expert_counts"])
        if cfg.moe is not None:
            counts.append(period if period is not None else torch.zeros(
                cfg.moe.num_experts, dtype=torch.int32, device=x.device))

    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].t()
        logits = softcap(logits, cfg.final_logit_softcap)
    else:
        logits = unembed(params["unembed"], x, cfg)
    if cache is not None:
        cache["filled"] = max(cache["filled"], start + S)
    metrics = {k: v if isinstance(v, torch.Tensor) else torch.zeros(
        (), dtype=torch.float32, device=logits.device)
        for k, v in (("aux_loss", aux), ("dropped", dropped))}
    if cfg.moe is not None:
        metrics["expert_counts"] = torch.stack(counts)     # (n_periods, E)
    return logits, cache, metrics
