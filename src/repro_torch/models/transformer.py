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
deepseek-v2, mamba2-1.3b and jamba end to end, and the decoder of
``encdec.py`` (seamless), whose cross-attention layers
(``LayerSpec(cross_attn=True)``) attend over the encoder output after
self-attention and before the FFN, as the reference's
``layer_forward``, and a VLM's stub frontend (pixtral): ``lm_forward``'s
``media_embeds`` (B, S_media, D) are prepended to the token embeddings,
as the reference's, so a step covers S_media + S_text positions from
``start`` (the cache's slots and ``filled`` count them) and the logits
cover every position, the media rows included.

Metrics, as the reference's: ``aux_loss`` and ``dropped`` summed over
the layers, and for a config with ``moe`` set ``expert_counts`` of shape
(n_periods, E), each period's pattern positions summed.  A dense config
launches nothing for them (host zeros, made tensors once at the end).

Caches hold an extra entry beside the reference's tree: ``"filled"``,
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

A stack with cross-attention layers keeps each layer's projected
encoder output in its cache as ``xkv`` {k, v} of (B, enc_cap, Hkv, hd)
in bf16, and a second host-side entry, ``"enc_len"``: how many of those
slots the last step with an encoder output wrote.  A step with
``enc_out`` (B, S_enc, D) writes slots ``[:S_enc]`` in place, sets
``enc_len`` to S_enc and attends over the fresh projections (the
reference attends over them too, and returns them as its new ``xkv``,
whose length is then S_enc); a step without one attends over slots
``[:enc_len]``, which is what the reference's decode reads.  A step
without ``enc_out`` over a cache whose ``enc_len`` is 0 (the reference
would attend over zeros), or without either, and a step with S_enc past
``enc_cap``, raise ``ValueError`` before any write.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from .attention import gqa_forward, init_attention, init_mla_attention, \
    mla_forward, project_kv
from .config import LayerSpec, ModelConfig
from .layers import embed, ffn, init_embedding, init_ffn, init_rmsnorm, \
    init_unembed, rmsnorm, softcap, unembed
from .moe import init_moe, moe_ffn
from .params import Initializer, ParamTree, index_tree, stack_draws, \
    stack_pspecs, unbind_tree
from .ssd import init_mamba, init_mamba_cache, mamba_decode, mamba_forward

CACHE_DTYPE = torch.bfloat16       # the reference's cache dtype


# ---------------------------------------------------------------------------
# Per-layer init
# ---------------------------------------------------------------------------

def init_layer(ini: Initializer, cfg: ModelConfig, spec: LayerSpec,
               d_ff_override: int = 0):
    if spec.kind == "attn":
        p = {"attn_norm": init_rmsnorm(ini, cfg.d_model),
             "attn": (init_mla_attention(ini, cfg) if cfg.mla
                      else init_attention(ini, cfg))}
        if cfg.post_norm:
            p["attn_post_norm"] = init_rmsnorm(ini, cfg.d_model)
    else:
        p = {"mamba_norm": init_rmsnorm(ini, cfg.d_model),
             "mamba": init_mamba(ini, cfg)}
    if spec.cross_attn:
        p["cross_norm"] = init_rmsnorm(ini, cfg.d_model)
        p["cross"] = init_attention(ini, cfg)
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
                     device="cuda", enc_cap: int = 0):
    """Cache tree for one layer: an attention layer's bf16 k and v (an
    MLA layer's bf16 ``ckv`` (B, cap, r) and ``k_rope`` (B, cap, rope))
    and ``pos`` (-1 = empty), or a Mamba layer's bf16 ``conv`` (B, w-1, C)
    and f32 ``ssm`` (B, H, P, N), as the reference's; a cross-attention
    layer's bf16 ``xkv`` {k, v} (B, enc_cap, Hkv, hd) beside it."""
    zeros = lambda *shape: torch.zeros(shape, dtype=CACHE_DTYPE,
                                       device=device)
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    if spec.kind != "attn":
        c = {"mamba": init_mamba_cache(cfg, batch, CACHE_DTYPE, device)}
    else:
        pos = torch.full((cap,), -1, dtype=torch.int32, device=device)
        if cfg.mla:
            m = cfg.mla
            c = {"kv": {"ckv": zeros(batch, cap, m.kv_lora_rank),
                        "k_rope": zeros(batch, cap, m.qk_rope_dim),
                        "pos": pos}}
        else:
            c = {"kv": {"k": zeros(batch, cap, hkv, hd),
                        "v": zeros(batch, cap, hkv, hd), "pos": pos}}
    if spec.cross_attn:
        c["xkv"] = {"k": zeros(batch, enc_cap, hkv, hd),
                    "v": zeros(batch, enc_cap, hkv, hd)}
    return c


# ---------------------------------------------------------------------------
# Per-layer forward
# ---------------------------------------------------------------------------

def _check_cross(xkv, enc_out, enc_len: Optional[int]) -> None:
    """The cross-attention rules of the module docstring, before any
    write.  ``xkv``: a cross layer's cache entry (or its stack), None
    without a cache; ``enc_len``: the slots a step without ``enc_out``
    reads."""
    if enc_out is None:
        if xkv is None:
            raise ValueError(
                "a cross-attention layer needs the encoder output or a "
                "cache that holds its projection")
        if enc_len == 0:
            raise ValueError(
                "the cache holds no encoder output: run a step with the "
                "frames (a prefill) first")
    elif xkv is not None and enc_out.shape[1] > xkv["k"].shape[-3]:
        raise ValueError(
            f"an encoder output of {enc_out.shape[1]} frames overflows the "
            f"cache's {xkv['k'].shape[-3]} cross-attention slots")


def layer_forward(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                  start: int = 0, cache=None, enc_out=None,
                  causal: bool = True, aux_loss: bool = True,
                  enc_len: Optional[int] = None, hot_experts=None):
    """Returns (x, new_cache, metrics); ``start`` is the position of x's
    first token.  The cache is written in place (``new_cache`` holds the
    same tensors): a Mamba layer's one-token step over a cache takes
    ``mamba_decode``, anything else ``mamba_forward`` from the zero
    state, as the reference branches.  A cross-attention layer projects
    ``enc_out`` (B, S_enc, D), writes it to ``xkv[:, :S_enc]`` and
    attends over the fresh projection; without ``enc_out`` it attends
    over ``xkv[:, :enc_len]`` (every slot when ``enc_len`` is None).  A
    dense layer adds no aux loss and drops nothing: its metrics are host
    zeros, so a decode step launches no kernels for them.  A MoE layer's
    metrics are ``moe_ffn``'s (``aux_loss=False`` skips its load-balance
    loss; ``hot_experts`` takes its hot-expert branch)."""
    if spec.cross_attn:
        _check_cross(cache["xkv"] if cache is not None else None, enc_out,
                     enc_len)
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
    if spec.cross_attn:
        xc = cache["xkv"] if cache is not None else None
        if enc_out is not None:
            xk, xv = project_kv(p["cross"], enc_out)
            if xc is not None:
                n = xk.shape[1]
                xc["k"][:, :n] = xk.to(xc["k"].dtype)
                xc["v"][:, :n] = xv.to(xc["v"].dtype)
        else:
            n = xc["k"].shape[1] if enc_len is None else enc_len
            xk, xv = xc["k"][:, :n], xc["v"][:, :n]
        h = rmsnorm(p["cross_norm"], x, cfg.rms_eps)
        a, _ = gqa_forward(p["cross"], cfg, h, start, kv_const=(xk, xv))
        x = x + a
        if new_cache is not None:
            new_cache["xkv"] = xc
    metrics = {"aux_loss": 0.0, "dropped": 0.0}
    if spec.ffn != "none":
        h = rmsnorm(p["ffn_norm"], x, cfg.rms_eps)
        if spec.ffn == "moe":
            f, metrics = moe_ffn(p["ffn"], h, cfg, aux_loss, hot_experts)
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
    return ParamTree(lm_tree(Initializer(seed, device, dtype=torch.bfloat16),
                             cfg))


def lm_tree(ini: Initializer, cfg: ModelConfig) -> dict:
    """:func:`init_lm`'s tree as nested dicts, drawn from ``ini``."""
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
    return params


def init_lm_cache(cfg: ModelConfig, batch: int, cap: int, device="cuda",
                  enc_cap: int = 0):
    """The reference's cache tree (``enc_cap`` slots of ``xkv`` in each
    cross-attention layer), the host-side ``"filled"``, and ``"enc_len"``
    when the stack has a cross-attention layer."""
    cache = {}
    dense_spec = LayerSpec(kind="attn", ffn="dense")
    for i in range(cfg.first_k_dense):
        cache[f"prefix{i}"] = init_layer_cache(cfg, dense_spec, batch, cap,
                                               device)
    cache["blocks"] = {
        f"pos{pos}": stack_pspecs([
            init_layer_cache(cfg, spec, batch, cap, device, enc_cap)
            for _ in range(cfg.n_periods)])
        for pos, spec in enumerate(cfg.pattern)}
    cache["filled"] = 0
    if _cross_position(cfg) is not None:
        cache["enc_len"] = 0
    return cache


# ---------------------------------------------------------------------------
# Whole-model forward
# ---------------------------------------------------------------------------

def _cross_position(cfg: ModelConfig) -> Optional[str]:
    """The key of the first cross-attention pattern position, or None."""
    return next((f"pos{pos}" for pos, spec in enumerate(cfg.pattern)
                 if spec.cross_attn), None)


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
               enc_out=None, remat: bool = False, aux_loss: bool = True,
               hot_experts=None
               ) -> Tuple[torch.Tensor, Optional[dict], dict]:
    """tokens: (B, S_text); ``start``: the position of the first token (0
    for prefill and forward, ``pos`` for a decode step).  ``media_embeds``:
    (B, S_media, D) embeddings put before the tokens' (cast to their
    dtype); the step then covers S = S_media + S_text positions and the
    logits (B, S, V) all of them.  ``enc_out``: the
    encoder output (B, S_enc, D) of a stack with cross-attention layers,
    or None to read the cache's (module docstring).  ``remat``: without a
    cache and with autograd recording, each period runs under one
    ``torch.utils.checkpoint`` (non-reentrant), so only the period
    boundaries are kept and the backward recomputes each period's
    forward, as the reference's ``jax.checkpoint(policy=
    nothing_saveable)`` of its scan body; otherwise it changes nothing.
    ``aux_loss=False`` skips the MoE layers' load-balance loss (the metric
    stays 0); ``hot_experts`` takes the MoE layers' hot-expert branch.
    Returns (logits, cache, metrics); the cache is written in place and
    returned."""
    S = tokens.shape[1] + (media_embeds.shape[1] if media_embeds is not None
                           else 0)
    mamba, enc_len, cross = [], None, _cross_position(cfg)
    if cross is not None:
        if cache is not None and enc_out is None:
            enc_len = cache["enc_len"]
        _check_cross(cache["blocks"][cross]["xkv"] if cache is not None
                     else None, enc_out, enc_len)
    if cache is not None:
        mamba = _mamba_states(cache)
        _check_step(cache, start, S, bool(mamba))
        if start == 0:              # a restart: the state takes in 0..S-1
            for t in mamba:
                t.zero_()
    x = embed(params["embed"], tokens)
    if media_embeds is not None:
        x = torch.cat([media_embeds.to(x.dtype), x], dim=1)

    # host zeros until a MoE layer adds a tensor
    aux, dropped, counts = 0.0, 0.0, []
    dense_spec = LayerSpec(kind="attn", ffn="dense")
    for i in range(cfg.first_k_dense):
        c = cache[f"prefix{i}"] if cache is not None else None
        x, _, m = layer_forward(params[f"prefix{i}"], cfg, dense_spec, x,
                                start, c, aux_loss=aux_loss)
        aux = aux + m["aux_loss"]
    # one unbind a stacked leaf (views): its gradient is stacked once
    blocks = {f"pos{pos}": unbind_tree(params["blocks"][f"pos{pos}"],
                                       cfg.n_periods)
              for pos in range(len(cfg.pattern))}

    def run_period(x, i):
        aux, dropped, period = 0.0, 0.0, None
        for pos, spec in enumerate(cfg.pattern):
            key = f"pos{pos}"
            c = (index_tree(cache["blocks"][key], i) if cache is not None
                 else None)
            x, _, m = layer_forward(blocks[key][i], cfg, spec, x, start, c,
                                    enc_out, aux_loss=aux_loss,
                                    enc_len=enc_len, hot_experts=hot_experts)
            aux = aux + m["aux_loss"]
            dropped = dropped + m["dropped"]
            if "expert_counts" in m:
                period = (m["expert_counts"] if period is None
                          else period + m["expert_counts"])
        return x, aux, dropped, period

    checkpoint = remat and cache is None and torch.is_grad_enabled()
    for i in range(cfg.n_periods):
        if checkpoint:
            x, a, d, period = torch.utils.checkpoint.checkpoint(
                run_period, x, i, use_reentrant=False)
        else:
            x, a, d, period = run_period(x, i)
        aux = aux + a
        dropped = dropped + d
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
        if cross is not None and enc_out is not None:
            cache["enc_len"] = enc_out.shape[1]
    metrics = {k: v if isinstance(v, torch.Tensor) else torch.zeros(
        (), dtype=torch.float32, device=logits.device)
        for k, v in (("aux_loss", aux), ("dropped", dropped))}
    if cfg.moe is not None:
        metrics["expert_counts"] = torch.stack(counts)     # (n_periods, E)
    return logits, cache, metrics
