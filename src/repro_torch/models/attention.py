"""Attention: GQA with sliding window and logit softcap.

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

MLA (deepseek-v2), cross-attention (``kv_const``) and the
sequence-parallel decode of a mesh are not ported yet: they raise.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
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
    place at ``start .. start+S-1``.  Returns (out (B,S,D), cache)."""
    if kv_const is not None:
        raise NotImplementedError(
            "cross-attention (kv_const) is not ported yet: ROADMAP Queue 1 "
            "item 8 (encdec.py, seamless)")
    B, S, d = x.shape
    wq = params["wq"]
    H, hd = wq.shape[1], wq.shape[2]
    q = (x @ wq.reshape(d, -1)).reshape(B, S, H, hd)
    positions = torch.arange(start, start + S, dtype=torch.int32,
                             device=x.device)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    k, v = project_kv(params, x)
    if rope:
        k = apply_rope(k, positions, cfg.rope_theta)

    softcap = cfg.attn_logit_softcap
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
    wo = params["wo"]
    out = out.reshape(B, S, H * hd) @ wo.reshape(H * hd, -1)
    return out, cache
