"""Decoder-only transformer assembly.

Ported from ``repro.models.transformer``.  As there, ``init_lm`` stacks
each pattern position's layers into ``(n_periods, ...)`` (gemma2's
local/global alternation is a pattern of two, jamba's 1:7 attention /
mamba interleave one of eight), so the reference's weights carry across
one to one.  The reference's ``lax.scan`` over periods is a Python loop
over period ``i`` that indexes the stacked parameters and caches (views,
no copies), with the pattern unrolled inside.

What the port runs: attention layers (``kind="attn"``: GQA through
``ops.flash_attention``, or MLA's plain blocked loop when ``cfg.mla`` is
set) and Mamba2 layers (``models/ssd.py``; prefill through
``ops.ssd_scan``, decode through the plain ``ops.ssd_decode``), each
with no FFN, a dense one or a MoE one (``models/moe.py::moe_ffn``), the
dense prefix layers (``first_k_dense``), with or without gemma2's
post-norms, tied or untied embeddings and the final logit softcap:
gemma2-9b, llama3-8b, deepseek-7b, starcoder2-3b, phi3.5-MoE,
deepseek-v2, mamba2-1.3b and jamba end to end.  What raises
``NotImplementedError`` (ROADMAP Queue 1 item 8): cross-attention and
``encdec.py`` (seamless), ``media_embeds`` (pixtral).

Metrics, as the reference's: ``aux_loss`` and ``dropped`` summed over
the layers, and for a config with ``moe`` set ``expert_counts`` of shape
(n_periods, E), each period's pattern positions summed.  A dense config
launches nothing for them (host zeros, made tensors once at the end).

Caches hold one extra entry beside the reference's tree: ``"filled"``,
a host-side count of the positions that prefill and decode have taken
in (an attention layer's slots, GQA's k / v or MLA's ``ckv`` /
``k_rope``, ``0..filled-1`` hold positions ``0..filled-1``).  A step
past it raises instead of reading a gap, and one past an attention
layer's slots raises before any write.  A Mamba layer's state has no
slots, and it has already absorbed every token it was given, so a stack
with a Mamba layer cannot roll back: a step at ``0 < start < filled``
raises before any write, and a step at ``start`` 0 restarts the state
from zero and ``filled`` from S (the reference's one-token step would
continue from whatever state the cache holds).  An attention stack, MLA
included, rolls back: a step at any ``start <= filled`` overwrites the
slots from ``start`` on.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .attention import gqa_forward, init_attention, init_mla_attention, \
    mla_forward
from .config import LayerSpec, ModelConfig
from .layers import embed, ffn, init_embedding, init_ffn, init_rmsnorm, \
    init_unembed, rmsnorm, softcap, unembed
from .moe import init_moe, moe_ffn
from .params import Initializer, ParamTree, index_tree, stack_draws, \
    stack_pspecs
from .ssd import init_mamba, init_mamba_cache, mamba_decode, mamba_forward

CACHE_DTYPE = torch.bfloat16       # the reference's cache dtype


def _unported(cfg: ModelConfig, spec: LayerSpec) -> None:
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
    if spec.kind == "attn":
        p = {"attn_norm": init_rmsnorm(ini, cfg.d_model),
             "attn": (init_mla_attention(ini, cfg) if cfg.mla
                      else init_attention(ini, cfg))}
        if cfg.post_norm:
            p["attn_post_norm"] = init_rmsnorm(ini, cfg.d_model)
    else:
        p = {"mamba_norm": init_rmsnorm(ini, cfg.d_model),
             "mamba": init_mamba(ini, cfg)}
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
    """Cache tree for one layer: an attention layer's bf16 k and v (an
    MLA layer's bf16 ``ckv`` (B, cap, r) and ``k_rope`` (B, cap, rope))
    and ``pos`` (-1 = empty), or a Mamba layer's bf16 ``conv`` (B, w-1, C)
    and f32 ``ssm`` (B, H, P, N), as the reference's."""
    _unported(cfg, spec)
    if spec.kind != "attn":
        return {"mamba": init_mamba_cache(cfg, batch, CACHE_DTYPE, device)}
    pos = torch.full((cap,), -1, dtype=torch.int32, device=device)
    if cfg.mla:
        m = cfg.mla
        return {"kv": {
            "ckv": torch.zeros((batch, cap, m.kv_lora_rank),
                               dtype=CACHE_DTYPE, device=device),
            "k_rope": torch.zeros((batch, cap, m.qk_rope_dim),
                                  dtype=CACHE_DTYPE, device=device),
            "pos": pos,
        }}
    shape = (batch, cap, cfg.n_kv_heads, cfg.head_dim_)
    return {"kv": {
        "k": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
        "v": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
        "pos": pos,
    }}


# ---------------------------------------------------------------------------
# Per-layer forward
# ---------------------------------------------------------------------------

def layer_forward(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                  start: int = 0, cache=None, enc_out=None,
                  causal: bool = True, aux_loss: bool = True):
    """Returns (x, new_cache, metrics); ``start`` is the position of x's
    first token.  The cache is written in place (``new_cache`` holds the
    same tensors): a Mamba layer's one-token step over a cache takes
    ``mamba_decode``, anything else ``mamba_forward`` from the zero
    state, as the reference branches.  A dense layer adds no aux loss
    and drops nothing: its metrics are host zeros, so a decode step
    launches no kernels for them.  A MoE layer's metrics are
    ``moe_ffn``'s (``aux_loss=False`` skips its load-balance loss)."""
    _unported(cfg, spec)
    if enc_out is not None:
        raise NotImplementedError(
            "enc_out (encoder-decoder stacks) is not ported yet: ROADMAP "
            "Queue 1 item 8")
    new_cache = {} if cache is not None else None
    if spec.kind == "attn":
        h = rmsnorm(p["attn_norm"], x, cfg.rms_eps)
        kv = cache["kv"] if cache is not None else None
        if cfg.mla:
            a, kvc = mla_forward(p["attn"], cfg, h, start, cache=kv)
        else:
            a, kvc = gqa_forward(p["attn"], cfg, h, start,
                                 window=spec.window, cache=kv, causal=causal)
        if cfg.post_norm:
            a = rmsnorm(p["attn_post_norm"], a, cfg.rms_eps)
        if new_cache is not None:
            new_cache["kv"] = kvc
    else:
        h = rmsnorm(p["mamba_norm"], x, cfg.rms_eps)
        mc = cache["mamba"] if cache is not None else None
        if mc is not None and x.shape[1] == 1:
            a, state = mamba_decode(p["mamba"], cfg, h, mc)
        else:
            a, state = mamba_forward(p["mamba"], cfg, h, cache=mc)
        if mc is not None:
            # lm_forward passes views of the stacked caches and drops what
            # a layer returns: the state must land in the cache's tensors
            for name in ("conv", "ssm"):
                mc[name].copy_(state[name])
            new_cache["mamba"] = mc
    x = x + a
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

def _capacity(cache) -> Optional[int]:
    """Slots of a cache tree from ``init_lm_cache`` (every attention
    layer's the same), or None when no layer has any (a Mamba layer's
    state takes any number of tokens)."""
    layers = [cache[k] for k in cache if k.startswith("prefix")]
    for layer in layers + list(cache["blocks"].values()):
        if "kv" in layer:
            return layer["kv"]["pos"].shape[-1]
    return None


def _mamba_states(cache):
    """The stacked (n_periods, ...) ``conv`` and ``ssm`` tensors of every
    Mamba pattern position."""
    return [t for layer in cache["blocks"].values() if "mamba" in layer
            for t in layer["mamba"].values()]


def _check_step(cache, start: int, S: int, mamba: bool) -> None:
    """The step rules of the module docstring (``mamba``: the stack has a
    Mamba layer); raises before any write."""
    filled = cache["filled"]
    if start > filled:
        raise ValueError(
            f"a step at position {start} would leave a gap: the cache holds "
            f"the contiguous positions 0..{filled - 1}")
    cap = _capacity(cache)
    if cap is not None and start + S > cap:
        raise ValueError(
            f"a step writing positions {start}..{start + S - 1} overflows "
            f"the cache's {cap} slots")
    if mamba and start > 0:
        if start < filled:
            raise ValueError(
                f"a step at position {start} would roll back a Mamba state "
                f"that has taken in positions 0..{filled - 1}; restart at 0")
        if S > 1:
            raise NotImplementedError(
                "chunked prefill (start > 0 with S > 1 over a cache) has no "
                "caller and is not ported: ROADMAP Queue 1 item 8")


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
    mamba = []
    if cache is not None:
        mamba = _mamba_states(cache)
        _check_step(cache, start, S, bool(mamba))
        if start == 0:              # a restart: the state takes in 0..S-1
            for t in mamba:
                t.zero_()
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
        cache["filled"] = (start + S if mamba
                           else max(cache["filled"], start + S))
    metrics = {k: v if isinstance(v, torch.Tensor) else torch.zeros(
        (), dtype=torch.float32, device=logits.device)
        for k, v in (("aux_loss", aux), ("dropped", dropped))}
    if cfg.moe is not None:
        metrics["expert_counts"] = torch.stack(counts)     # (n_periods, E)
    return logits, cache, metrics
