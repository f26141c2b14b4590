"""Attention: GQA (with sliding window and logit softcap) and MLA.

Ported from ``repro.models.attention`` for one device (``mesh=None``).
:func:`attend_blocked` is the plain blocked online-softmax attention with
explicit positions (``kv_pos < 0`` masks an empty cache slot).  It is
the plain version beside the ``flash_attention`` CUDA kernel, not a path
the card takes: :func:`gqa_forward` always goes through
``kernels.ops.flash_attention``, which launches the kernel on a CUDA
tensor and runs ``attend_blocked`` over arange positions on a CPU one.

Positions.  Every caller of the reference passes either ``arange(S)``
(prefill and forward) or one scalar position (decode), so the port's
:func:`gqa_forward` takes the **start position as a Python int** and
builds the positions for RoPE and the cache's ``pos`` array itself:

- start 0, any S (prefill / forward): causal attention over the S new
  keys, read back from the cache's slots ``[:S]`` after the write when
  there is a cache (stored in bf16, as the reference attends over the
  cache).  Cache slots from S on hold ``pos = -1`` or a stale
  ``pos >= S``, which the reference's causal mask masks too.
- S == 1 at ``pos`` with a cache (decode): attention without a mask over
  the cache slots ``[lo, pos]``, ``lo = max(0, pos + 1 - window)`` on a
  windowed layer.  That is the reference's ``kv_pos`` masking as long as
  slots ``0..pos`` hold positions ``0..pos``; ``transformer.lm_forward``
  raises on a decode that would leave a gap.
- start > 0 with S > 1 and a cache (chunked prefill) has no caller and
  raises.

The cache is written **in place** (the reference returns an updated
copy; at gemma2-9b's size a copy is 1.4 GB a decode step), and the
returned cache holds the same tensors.

MLA (deepseek-v2, :func:`mla_forward`) is the reference's blocked
online-softmax loop in plain PyTorch, as the reference computes it in
jnp (no Pallas kernel, and ``flash_attention`` takes one head dim where
MLA's q.k is 192 wide and v 128): the naive form at S > 1, the absorbed
form at S == 1, over the compressed cache written in place.

Cross-attention (``kv_const=(k, v)``, an encoder-decoder stack's
decoder layers): q is projected and RoPE'd at ``start .. start+S-1``
and attends without a mask over the given k and v, which are taken as
they stand (no RoPE, no cache write), through ``ops.flash_attention``.
The reference passes ``kv_pos = arange(S_enc)`` and ``causal=False``
there, so its mask drops nothing.  The sequence-parallel decode of a
mesh is not ported yet: it has no branch.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import MLAConfig, ModelConfig
from .layers import apply_rope, dot_f32
from .params import Initializer

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_attention(ini: Initializer, cfg: ModelConfig):
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return {
        "wq": ini.normal((d, h, hd)),
        "wk": ini.normal((d, hkv, hd)),
        "wv": ini.normal((d, hkv, hd)),
        "wo": ini.normal((h, hd, d), fan_in=h * hd),
    }


def init_mla_attention(ini: Initializer, cfg: ModelConfig):
    """The reference's MLA leaves: ``wq`` (d, H, nope + rope), the
    down-projections ``w_dkv`` (d, r) and ``w_krope`` (d, rope), the
    up-projections ``w_uk`` / ``w_uv`` (r, H, nope / v) and ``wo``."""
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq": ini.normal((d, h, qk)),
        "w_dkv": ini.normal((d, m.kv_lora_rank)),
        "w_krope": ini.normal((d, m.qk_rope_dim)),
        "w_uk": ini.normal((m.kv_lora_rank, h, m.qk_nope_dim),
                           fan_in=m.kv_lora_rank),
        "w_uv": ini.normal((m.kv_lora_rank, h, m.v_head_dim),
                           fan_in=m.kv_lora_rank),
        "wo": ini.normal((h, m.v_head_dim, d), fan_in=h * m.v_head_dim),
    }


# ---------------------------------------------------------------------------
# Blocked attention (plain PyTorch; the kernel's plain version)
# ---------------------------------------------------------------------------

def attend_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_pos: torch.Tensor, kv_pos: torch.Tensor,
                   causal: bool = True, window: Optional[int] = None,
                   logit_softcap: float = 0.0,
                   block: int = 512) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Sk,Hkv,D); q_pos: (Sq,), kv_pos: (Sk,).

    kv entries with position < 0 are masked out (empty cache slots).
    Walks the KV blocks carrying (max, sumexp, acc) in f32; ``p`` is
    rounded to v's dtype before ``p . v``.  Returns q's dtype."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)

    nb = -(-Sk // block)
    pad = nb * block - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    qg = q.reshape(B, Sq, Hkv, G, D)

    f32 = torch.float32
    m_run = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=f32, device=q.device)
    l_run = torch.zeros((B, Hkv, G, Sq), dtype=f32, device=q.device)
    acc = torch.zeros((B, Sq, Hkv, G, D), dtype=f32, device=q.device)
    for i in range(nb):
        sl = slice(i * block, (i + 1) * block)
        kblk, vblk, posblk = k[:, sl], v[:, sl], kv_pos[sl]
        # logits: (B, Hkv, G, Sq, block)
        logits = dot_f32("bshgd,bthd->bhgst", qg, kblk) * scale
        if logit_softcap:
            logits = logit_softcap * torch.tanh(logits / logit_softcap)
        mask = (posblk >= 0)[None, :]
        if causal:
            mask = mask & (posblk[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (q_pos[:, None] - posblk[None, :] < window)
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m_run, logits.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(logits - m_new[..., None])
        p = torch.where(mask, p, 0.0)                       # m_new == -inf
        l_run = l_run * alpha + p.sum(dim=-1)
        pv = dot_f32("bhgst,bthd->bshgd", p.to(vblk.dtype), vblk)
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
        m_run = m_new
    l_run = l_run.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    out = (acc / l_run).reshape(B, Sq, H, D)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA forward (prefill / decode / forward)
# ---------------------------------------------------------------------------

def project_kv(params, kv_in: torch.Tensor):
    """kv_in: (B,S,d) -> k, v: (B,S,Hkv,hd) in kv_in's dtype."""
    B, S, d = kv_in.shape
    wk, wv = params["wk"], params["wv"]
    k = (kv_in @ wk.reshape(d, -1)).reshape(B, S, *wk.shape[1:])
    v = (kv_in @ wv.reshape(d, -1)).reshape(B, S, *wv.shape[1:])
    return k, v


def gqa_forward(params, cfg: ModelConfig, x: torch.Tensor, start: int = 0,
                *, window: Optional[int] = None, cache=None, kv_const=None,
                causal: bool = True, rope: bool = True):
    """x: (B,S,D); ``start``: the position of x's first token (an int).

    cache: {"k": (B,cap,Hkv,hd), "v": ..., "pos": (cap,)}, written in
    place at ``start .. start+S-1``.  ``kv_const``: (k, v) of shape
    (B, S_enc, Hkv, hd) to attend over without a mask (cross-attention;
    only q takes RoPE, and the cache is not read).  Returns (out (B,S,D),
    cache), the cache None with ``kv_const``."""
    B, S, d = x.shape
    wq = params["wq"]
    H, hd = wq.shape[1], wq.shape[2]
    q = (x @ wq.reshape(d, -1)).reshape(B, S, H, hd)
    positions = torch.arange(start, start + S, dtype=torch.int32,
                             device=x.device)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    softcap = cfg.attn_logit_softcap
    wo = params["wo"]
    if kv_const is not None:
        k, v = kv_const
        out = ops.flash_attention(q, k, v, causal=False, window=None,
                                  logit_softcap=softcap)
        return out.reshape(B, S, H * hd) @ wo.reshape(H * hd, -1), None
    k, v = project_kv(params, x)
    if rope:
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        # positions shift q and k alike: the mask depends on q_pos - k_pos
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  logit_softcap=softcap)
    else:
        if start > 0 and S > 1:
            raise NotImplementedError(
                "chunked prefill (start > 0 with S > 1 over a cache) has no "
                "caller and is not ported: ROADMAP Queue 1 item 8")
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        ck[:, start:start + S] = k.to(ck.dtype)
        cv[:, start:start + S] = v.to(cv.dtype)
        cpos[start:start + S] = positions
        if S == 1 and start > 0:
            lo = max(0, start + 1 - window) if window is not None else 0
            out = ops.flash_attention(
                q, ck[:, lo:start + 1], cv[:, lo:start + 1], causal=False,
                window=None, logit_softcap=softcap)
        else:
            out = ops.flash_attention(q, ck[:, :S], cv[:, :S],
                                      causal=causal, window=window,
                                      logit_softcap=softcap)
        cache = {"k": ck, "v": cv, "pos": cpos}
    out = out.reshape(B, S, H * hd) @ wo.reshape(H * hd, -1)
    return out, cache


# ---------------------------------------------------------------------------
# MLA forward (naive at prefill, absorbed at decode)
# ---------------------------------------------------------------------------

def mla_forward(params, cfg: ModelConfig, x: torch.Tensor, start: int = 0,
                *, cache=None, block: int = 512):
    """x: (B,S,D); ``start``: the position of x's first token (an int).

    cache: {"ckv": (B,cap,r), "k_rope": (B,cap,rope), "pos": (cap,)},
    written in place at ``start .. start+S-1``.  Returns (out (B,S,D),
    cache).  At S == 1 the *absorbed* form: q projected into the rank-r
    latent space (``q_lat``) attends against the compressed cache, and
    the context goes up through ``w_uv`` after.  At S > 1 the *naive*
    form: k and v are up-projected from the compressed cache one block of
    ``block`` keys at a time inside the loop.  The loop, its f32
    contractions (``dot_f32``), the -1 padding of ``pos`` to whole blocks
    and the mask ``0 <= pos <= position`` are the reference's.

    Over a cache it reads slots ``[:start+S]`` only: slot i is written at
    position i alone, so a slot past them holds -1 or a position past
    every query, which the mask drops (a block of it adds p = 0 and keeps
    the running max).  The logits block is (B, H, S, block) in f32, 2.15
    GB at deepseek-v2's prefill of 2 x 4096: it is updated in place, in
    the reference's order of operations."""
    m: MLAConfig = cfg.mla
    B, S, d = x.shape
    wq = params["wq"]
    H = wq.shape[1]
    q = (x @ wq.reshape(d, -1)).reshape(B, S, H, wq.shape[2])
    q_nope, q_rope = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    positions = torch.arange(start, start + S, dtype=torch.int32,
                             device=x.device)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = x @ params["w_dkv"]                                  # (B,S,r)
    k_rope = apply_rope((x @ params["w_krope"])[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]            # (B,S,rope)

    if cache is not None:
        if start > 0 and S > 1:
            raise NotImplementedError(
                "chunked prefill (start > 0 with S > 1 over a cache) has no "
                "caller and is not ported: ROADMAP Queue 1 item 8")
        cc, cr, cpos = cache["ckv"], cache["k_rope"], cache["pos"]
        if start + S > cpos.shape[0]:
            raise ValueError(
                f"a step writing positions {start}..{start + S - 1} "
                f"overflows the cache's {cpos.shape[0]} slots")
        cc[:, start:start + S] = ckv.to(cc.dtype)
        cr[:, start:start + S] = k_rope.to(cr.dtype)
        cpos[start:start + S] = positions
        cache = {"ckv": cc, "k_rope": cr, "pos": cpos}
        n = start + S
        ckv, k_rope, kv_pos = cc[:, :n], cr[:, :n], cpos[:n]
    else:
        kv_pos = positions

    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    absorb = S == 1
    Sk = ckv.shape[1]
    nb = -(-Sk // block)
    pad = nb * block - Sk
    if pad:
        ckv = F.pad(ckv, (0, 0, 0, pad))
        k_rope = F.pad(k_rope, (0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)

    w_uk, w_uv = params["w_uk"], params["w_uv"]
    if absorb:
        # q into the latent space, in x's dtype as the reference leaves it
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
    else:
        q_nope = q_nope.float()          # the reference's astype, hoisted
    q_rope = q_rope.float()              # dot_f32's upcast, hoisted
    f32 = torch.float32
    acc_dim = m.kv_lora_rank if absorb else m.v_head_dim
    m_run = torch.full((B, H, S), NEG_INF, dtype=f32, device=x.device)
    l_run = torch.zeros((B, H, S), dtype=f32, device=x.device)
    acc = torch.zeros((B, S, H, acc_dim), dtype=f32, device=x.device)
    for i in range(nb):
        sl = slice(i * block, (i + 1) * block)
        cblk, rblk, posblk = ckv[:, sl], k_rope[:, sl], kv_pos[sl]
        if absorb:
            logits = dot_f32("bshr,btr->bhst", q_lat, cblk)
        else:
            k_nope = dot_f32("btr,rhn->bthn", cblk, w_uk)
            v_blk = dot_f32("btr,rhv->bthv", cblk, w_uv)
            logits = dot_f32("bshn,bthn->bhst", q_nope, k_nope)
        masked = ~((posblk >= 0)[None, :]
                   & (posblk[None, :] <= positions[:, None]))   # (S,block)
        if logits.requires_grad:
            # autograd keeps what the in-place updates would overwrite:
            # the same operations out of place (a training step)
            logits = (logits + dot_f32("bshr,btr->bhst", q_rope, rblk)
                      ) * scale
            logits = logits.masked_fill(masked, NEG_INF)
            m_new = torch.maximum(m_run, logits.amax(dim=-1))
            p = (logits - m_new[..., None]).exp().masked_fill(masked, 0.0)
        else:
            logits += dot_f32("bshr,btr->bhst", q_rope, rblk)
            logits *= scale
            logits.masked_fill_(masked, NEG_INF)
            m_new = torch.maximum(m_run, logits.amax(dim=-1))
            p = logits.sub_(m_new[..., None]).exp_().masked_fill_(masked,
                                                                   0.0)
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + p.sum(dim=-1)
        if absorb:
            pv = dot_f32("bhst,btr->bshr", p.to(cblk.dtype), cblk)
        else:
            pv = dot_f32("bhst,bthv->bshv", p, v_blk)
        acc = acc * alpha.permute(0, 2, 1)[..., None] + pv
        m_run = m_new
        del logits, p           # freed before the next block's is made
    ctx = acc / l_run.clamp_min(1e-30).permute(0, 2, 1)[..., None]
    ctx = ctx.to(x.dtype)
    if absorb:
        ctx = torch.einsum("bshr,rhv->bshv", ctx, w_uv)
    wo = params["wo"]
    out = ctx.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    return out, cache
