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
there, so its mask drops nothing.

Sequence-parallel decode (a :class:`~repro_torch.distributed.meshctx.\
MeshPolicy` with a mesh, passed as ``policy=``): a one-token step over a
cache whose slots split evenly over the sequence shards takes
:func:`_gqa_decode_seq_parallel` (GQA) or :func:`_mla_decode_seq_parallel`
(MLA's absorbed form), the reference's explicit flash-decoding branches.
Each KV shard owns a contiguous range of cache slots; the shard's slots
are intersected with the decode's visible range ``[lo, start + 1)`` (what
the single-device decode slices), a shard with none is skipped, and the
shards' partials are combined in f32 in shard order.  GQA's partials are
``ops.flash_attention(..., return_lse=True)`` — the ``flash_attention``
kernel on the card, once per KV shard — weighted by ``exp2(lse - max)``;
MLA's are the reference's ``(max, sum, acc)`` partials in plain PyTorch.
The cache itself stays whole on the mesh's home device, and each shard
reads its slots in place (a copy only where a shard's device differs).
Batch rows split over the batch axes when they divide; otherwise (batch
1) the ``"data"`` axis joins the model axis in splitting the sequence.

Partitioned (:func:`gqa_forward_tp`, the tensor-parallel layout of
``distributed/tensor_parallel.py``): each coordinate projects its query
heads and the kv heads they read, writes the cache's placed blocks
(heads to sequence, one all-to-all each for k and v), attends its heads
at prefill, and at decode attends every head (q all-gathered over the
model axis) over its own block's visible slots, the blocks' partials of
its heads combined as above; ``wo``'s partials are summed over the
model axis.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed import compat
from ..kernels import ops
from .config import MLAConfig, ModelConfig
from .layers import apply_rope, dot_f32
from .params import Initializer

NEG_INF = -1e30
LOG2E = 1.4426950408889634


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
                   block: int = 512, return_lse: bool = False):
    """q: (B,Sq,H,D); k,v: (B,Sk,Hkv,D); q_pos: (Sq,), kv_pos: (Sk,).

    kv entries with position < 0 are masked out (empty cache slots).
    Walks the KV blocks carrying (max, sumexp, acc) in f32; ``p`` is
    rounded to v's dtype before ``p . v``.  Returns q's dtype; with
    ``return_lse`` also each row's logsumexp from the same running max
    and sum, f32 (B, H, Sq) in log2 units (``NEG_INF`` for a row that
    sees no key), what the ``flash_attention`` kernel writes."""
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
    out = (acc / l_run.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
           ).reshape(B, Sq, H, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l_run > 0,
                      (m_run + torch.log(l_run)) * LOG2E,
                      torch.full_like(l_run, NEG_INF))
    return out, lse.reshape(B, H, Sq)



# ---------------------------------------------------------------------------
# Sequence-parallel decode over a mesh
# ---------------------------------------------------------------------------

def _seq_split(pol, B: int, mla: bool):
    """``(batch_axes, seq_axes)`` of a sequence-parallel decode: the
    batch split over the policy's batch axes when B divides (and there
    is more than one batch shard), else unsplit with ``"data"`` joining
    the model axis in the sequence split (MLA splits the sequence over
    the model axis only, as the reference)."""
    mesh, mdl = pol.mesh, pol.model_axis
    model = tuple(a for a in (mdl,) if a in mesh.shape)
    if pol.n_batch_shards > 1 and B % pol.n_batch_shards == 0:
        return tuple(pol.batch_axes), model
    if mla:
        return (), model
    return (), tuple(a for a in ("data", mdl) if a in mesh.shape)


def n_seq_shards(pol, B: int, mla: bool = False) -> int:
    """How many KV shards a decode over ``pol``'s mesh cuts the cache
    into (1 without a mesh)."""
    if pol is None or pol.mesh is None:
        return 1
    return pol.mesh.axes_size(_seq_split(pol, B, mla)[1])


def _seq_shards(pol, B: int, cap: int, lo: int, hi: int, mla: bool):
    """Yield ``(b, rows, a, e, device, coord)`` per sequence shard with
    visible slots, in shard order: batch chunk ``b`` (rows ``rows``),
    cache slots ``[a, e)`` = the shard's range intersected with
    ``[lo, hi)``, at mesh coordinate ``coord``, where the caller's loop
    body runs (``compat.at``, for a recorder)."""
    mesh = pol.mesh
    batch_axes, seq_axes = _seq_split(pol, B, mla)
    nb, ns = mesh.axes_size(batch_axes), mesh.axes_size(seq_axes)
    L, Bl = cap // ns, B // nb
    for i, c in enumerate(mesh.shard_coords(batch_axes + seq_axes)):
        b, s = divmod(i, ns)
        a, e = max(s * L, lo), min((s + 1) * L, hi)
        if a < e:
            with compat.at(c):
                yield (b, slice(b * Bl, (b + 1) * Bl), a, e,
                       mesh.device_at(c), c)


def _gqa_decode_seq_parallel(pol, q, k, v, start: int, *, window,
                             logit_softcap):
    """Sequence-parallel flash decode for GQA: q (B, 1, H, hd) at
    position ``start`` over the cache k, v (B, cap, Hkv, hd) whose slot i
    holds position i.  Each KV shard attends its visible slots through
    ``ops.flash_attention(..., return_lse=True)``; per batch chunk the
    partials combine in f32 in shard order, weighted by
    ``exp2(lse - max)``.  Returns (B, 1, H, hd) in q's dtype on q's
    device."""
    B, cap = q.shape[0], k.shape[1]
    hi = start + 1
    lo = max(0, hi - window) if window is not None else 0
    home = q.device
    parts: dict = {}
    for b, rows, a, e, dev, _ in _seq_shards(pol, B, cap, lo, hi, False):
        out, lse = ops.flash_attention(
            q[rows].to(dev), k[rows, a:e].to(dev), v[rows, a:e].to(dev),
            causal=False, window=None, logit_softcap=logit_softcap,
            return_lse=True)
        parts.setdefault(b, []).append((out.to(home), lse.to(home)))
    outs = []
    for b in sorted(parts):
        lses = [lse for _, lse in parts[b]]                  # (Bl, H, 1)
        outs.append(_lse_combine(parts[b], compat.pmax(lses, home)))
    return torch.cat(outs).to(q.dtype)


def _lse_combine(parts, m: torch.Tensor) -> torch.Tensor:
    """KV shards' partials ``(out (B, 1, H, hd), lse (B, H, 1))``, in
    shard order, combined in f32 with weights ``exp2(lse - m)``, ``m``
    their maximum."""
    num, den = None, None
    for out, lse in parts:
        w = torch.exp2(lse - m)
        t = out.float() * w.permute(0, 2, 1)[..., None]
        num = t if num is None else num + t
        den = w if den is None else den + w
    return num / den.permute(0, 2, 1)[..., None]


def _mla_decode_seq_parallel(pol, q_lat, q_rope, ckv, k_rope, start: int,
                             scale: float):
    """Flash decoding over the model axis for MLA's absorbed form:
    q_lat (B, 1, H, r) and q_rope (B, 1, H, rope) at position ``start``
    over the compressed cache ckv (B, cap, r), k_rope (B, cap, rope).
    Each shard's logits over its visible slots; the max over the shards
    (in shard order), then each shard's ``exp`` sums and ``p . ckv`` in
    f32, summed in shard order — the reference's pmax / psum stages.
    Returns ctx_lat (B, 1, H, r) in f32 on q's device."""
    B, cap = q_lat.shape[0], ckv.shape[1]
    home = q_lat.device
    shards = []
    for b, rows, a, e, dev, at in _seq_shards(pol, B, cap, 0, start + 1,
                                              True):
        c = ckv[rows, a:e].to(dev)
        logits = (dot_f32("bshr,btr->bhst", q_lat[rows].to(dev), c)
                  + dot_f32("bshr,btr->bhst", q_rope[rows].to(dev),
                            k_rope[rows, a:e].to(dev))) * scale
        shards.append((b, c, logits, at))
    outs = []
    for b in sorted({s[0] for s in shards}):
        mine = [(c, lg, at) for bb, c, lg, at in shards if bb == b]
        maxes = []
        for _, lg, at in mine:
            with compat.at(at):
                maxes.append(lg.amax(dim=-1))
        m_glob = compat.pmax(maxes, home)
        ls, accs = [], []
        for c, lg, at in mine:
            with compat.at(at):
                p = torch.exp(lg - m_glob.to(lg.device)[..., None])
                ls.append(p.sum(dim=-1))
                accs.append(dot_f32("bhst,btr->bshr", p.to(c.dtype), c))
        l_glob = compat.psum(ls, home)
        acc = compat.psum(accs, home)
        outs.append(acc / l_glob.clamp_min(1e-30).permute(0, 2, 1)[..., None])
    return torch.cat(outs)


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
                causal: bool = True, rope: bool = True, policy=None):
    """x: (B,S,D); ``start``: the position of x's first token (an int).

    cache: {"k": (B,cap,Hkv,hd), "v": ..., "pos": (cap,)}, written in
    place at ``start .. start+S-1``.  ``kv_const``: (k, v) of shape
    (B, S_enc, Hkv, hd) to attend over without a mask (cross-attention;
    only q takes RoPE, and the cache is not read).  ``policy``: a
    :class:`MeshPolicy` whose mesh sends a one-token step over a cache
    through the sequence-parallel decode (module docstring).  Returns
    (out (B,S,D), cache), the cache None with ``kv_const``."""
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
        n_seq = n_seq_shards(policy, B)
        if (S == 1 and n_seq > 1 and ck.shape[1] % n_seq == 0):
            out = _gqa_decode_seq_parallel(policy, q, ck, cv, start,
                                           window=window,
                                           logit_softcap=softcap)
        elif S == 1 and start > 0:
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
# GQA over the partitioned layout
# ---------------------------------------------------------------------------

def _tp_heads(run, cfg: ModelConfig, sh) -> dict:
    """``{c: (q0, q1, k0, k1)}``: the query heads ``[q0, q1)`` whose
    ``wq`` block coordinate c holds, and the kv heads ``[k0, k1)`` they
    read (``h // G``).  Where ``wk`` is split, its block must be those kv
    heads; where it is replicated, c projects only them.  Raises where
    the local query heads do not map onto the local kv heads by one
    group size (a split the zoo's configs never make)."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    G = H // Hkv
    out = {}
    for c in run.coords:
        q0, q1 = sh["wq"].range_at(c, 2, H)
        k0, k1 = q0 // G, (q1 - 1) // G + 1
        n = q1 - q0
        if not ((q0 % G == 0 and n % G == 0) or (G % n == 0
                                                and k1 - k0 == 1)):
            raise NotImplementedError(
                f"query heads {q0}..{q1 - 1} of {H} straddle kv groups of "
                f"{G} unevenly")
        b0, b1 = sh["wk"].range_at(c, 2, Hkv)
        if (b0, b1) != (0, Hkv) and (b0, b1) != (k0, k1):
            raise ValueError(f"wk's block holds kv heads {b0}..{b1 - 1}, "
                             f"its query heads read {k0}..{k1 - 1}")
        out[c] = (q0, q1, k0, k1)
    return out


def _wide(run, ksh) -> bool:
    """True where the cache's slots split over more than the model axis
    (a batch the batch axes do not divide: ``seq_kv`` over ``("data",
    "model")``), so coordinates of one model class hold other slots."""
    entry = ksh.spec[2] if len(ksh.spec) > 2 else None
    axes = entry if isinstance(entry, tuple) else (entry,)
    return any(a is not None and a != run.model_axis for a in axes)


def gqa_forward_tp(run, cfg: ModelConfig, p: dict, sh, h: dict, start: int,
                   *, window: Optional[int], kv: dict, kv_sh, pos_at,
                   cap: int, kv_at=None) -> dict:
    """:func:`gqa_forward` over a cache, partitioned
    (``distributed/tensor_parallel.py``): ``h[c]`` is coordinate c's
    rows (B_l, S, D), ``p[c]`` its blocks of the layer's ``wq`` / ``wk``
    / ``wv`` / ``wo``, ``kv[c]`` its blocks of the layer's ``k`` / ``v``
    cache (B_l, L, Hb, hd), ``pos_at(c)`` any coordinate's block of its
    ``pos`` (written at every coordinate), ``kv_at(d, name)`` any mesh
    coordinate's block of its ``k`` / ``v`` (needed where the slots split
    over more than the model axis), ``sh`` / ``kv_sh`` the stacked
    leaves' shardings, ``cap`` the cache's slots.  Returns ``{c: (B_l, S,
    D)}``.

    * q is column-parallel: c projects its query heads, and its kv heads
      (:func:`_tp_heads`), and applies RoPE to both.
    * The cache is written by blocks: c's block holds its rows, a range
      of slots and of kv heads (with ``seq_kv`` on the model axis, every
      head of a slice of slots), so it receives, from the members of its
      model group that projected them, the new positions' k and v of
      its heads (its own first, else the first holder in model order) in
      one all-to-all each.
    * Prefill: ``ops.flash_attention`` on the local heads over the new
      keys, as the cache stores them.
    * Decode (S == 1), where the cache splits its slots over the model
      axis (each block then holds every kv head): q's heads are
      all-gathered over the group, each coordinate attends every head
      over its block's visible slots (``[lo, start + 1)``; none: no
      call) through ``ops.flash_attention(return_lse=True)``, and each
      receives every block's partials of its own heads and combines them
      in model order with weights ``exp2(lse - max)``.  Where the slots
      are whole (a capacity the model axis does not divide), each block
      holds every slot of its kv heads (split with the query heads, or
      all of them), and c attends its own heads over it alone.
    * A batch the batch axes do not divide (a batch of 1) is not split,
      and the slots split over ``("data", "model")``: every coordinate
      holds a block of its own.  Each block that takes new positions
      receives them at its coordinate from that coordinate's model
      group (every data coordinate projected the same rows,
      ``TPRun.deliver``); at decode each coordinate attends every head
      over its block's visible slots, and each receives its own heads'
      partials from every block across model groups, in row-major block
      order (``TPRun.gather_all``), combined as above.
    * ``wo`` is row-parallel: c's partial output over its heads, summed
      over the group (one all-reduce); an unsplit ``wo`` needs none."""
    if start > 0 and next(iter(h.values())).shape[1] > 1:
        raise NotImplementedError(
            "chunked prefill (start > 0 with S > 1 over a cache) has no "
            "caller and is not ported: ROADMAP Queue 1 item 8")
    heads = _tp_heads(run, cfg, sh)
    Hkv, hd, theta = cfg.n_kv_heads, cfg.head_dim_, cfg.rope_theta
    softcap = cfg.attn_logit_softcap
    ksh, psh = kv_sh["k"], kv_sh["pos"]

    def project(c):
        x, w = h[c], p[c]
        B, S, d = x.shape
        q0, q1, k0, k1 = heads[c]
        b0 = sh["wk"].range_at(c, 2, Hkv)[0]
        pos = torch.arange(start, start + S, dtype=torch.int32,
                           device=x.device)
        q = (x @ w["wq"].reshape(d, -1)).reshape(B, S, q1 - q0, hd)
        k, v = project_kv({"wk": w["wk"][:, k0 - b0:k1 - b0],
                           "wv": w["wv"][:, k0 - b0:k1 - b0]}, x)
        return (apply_rope(q, pos, theta), apply_rope(k, pos, theta), v)
    qkv = run.each(project)
    S = next(iter(qkv.values()))[0].shape[1]

    def slots(c):
        a, e = ksh.range_at(c, 2, cap)
        return a, e, max(a, start), min(e, start + S)

    def pieces(which, c, group):
        """The new positions' k (``which`` 1) or v (2) of the kv heads
        c's block holds, from the members of ``group`` that projected
        them (c itself first; any coordinate by its class's heads)."""
        a, e, p0, p1 = slots(c)
        if p0 >= p1:
            return []
        return run.pieces(
            c, group, *ksh.range_at(c, 3, Hkv),
            lambda g: heads[run.rep[g]][2:],
            lambda src, i, j: qkv[run.rep[src]][which][
                :, p0 - start:p1 - start, i:j])

    wide = _wide(run, ksh)
    if wide and kv_at is None:
        raise ValueError(f"the cache's slots split over {ksh.spec[2]}: "
                         f"each block is written at its own coordinate, "
                         f"so gqa_forward_tp needs kv_at")
    if wide:
        # each block at its own coordinate, from its model group
        for o in ksh.coords:
            a, e, p0, p1 = slots(o)
            if p0 >= p1:
                continue
            for name, which in (("k", 1), ("v", 2)):
                with compat.at(o):
                    ps = pieces(which, o, run.model_group(o))
                new = run.deliver(o, ps, 2)
                with compat.at(o):
                    blk = kv_at(o, name)
                    blk[:, p0 - a:p1 - a] = new.to(blk.dtype)
    else:
        new_k = run.exchange(lambda c, g: pieces(1, c, g), 2)
        new_v = run.exchange(lambda c, g: pieces(2, c, g), 2)

        def write(c):
            a, e, p0, p1 = slots(c)
            if p0 < p1:
                kv[c]["k"][:, p0 - a:p1 - a] = new_k[c].to(kv[c]["k"].dtype)
                kv[c]["v"][:, p0 - a:p1 - a] = new_v[c].to(kv[c]["v"].dtype)
        run.each(write)

    def write_pos(c):
        a, e = psh.range_at(c, 1, cap)
        w0, w1 = max(a, start), min(e, start + S)
        if w0 < w1:
            blk = pos_at(c)
            blk[w0 - a:w1 - a] = torch.arange(w0, w1, dtype=torch.int32,
                                              device=blk.device)
    run.every(write_pos)

    if S > 1:
        def attend(c):
            q, k, v = qkv[c]
            dt = kv[c]["k"].dtype
            return ops.flash_attention(q, k.to(dt), v.to(dt), causal=True,
                                       window=window, logit_softcap=softcap)
        out = run.each(attend)
    else:
        out = _gqa_decode_tp(run, cfg, heads, qkv, kv, ksh, slots, start,
                             window=window, logit_softcap=softcap,
                             kv_at=kv_at if wide else None)

    def project_out(c):
        o = out[c]
        B = o.shape[0]
        wo = p[c]["wo"]
        return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    y = run.each(project_out)
    return run.all_reduce(y) if sh["wo"].spec else y


def _gqa_decode_tp(run, cfg: ModelConfig, heads: dict, qkv: dict, kv: dict,
                   ksh, slots, start: int, *, window, logit_softcap,
                   kv_at=None) -> dict:
    """:func:`gqa_forward_tp`'s one-token attention over the placed
    blocks (``ksh`` the cache's ``k`` sharding, stacked); returns
    ``{c: (B_l, 1, Hl, hd)}`` in q's dtype.  ``kv_at``: where the slots
    split over more than the model axis, any coordinate's block of the
    layer's ``k`` / ``v``: each block is attended at its own coordinate
    and every block's partials go to every coordinate."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    hi = start + 1
    lo = max(0, hi - window) if window is not None else 0
    if len(ksh.spec) < 3 or ksh.spec[2] is None:
        # every slot in each block: c's own heads over the kv heads they
        # read, which its block holds (split alongside them, or whole)
        def own(c):
            q0, q1, k0, k1 = heads[c]
            b0, b1 = ksh.range_at(c, 3, Hkv)
            if not b0 <= k0 < k1 <= b1:
                raise ValueError(
                    f"the cache block at {c} holds kv heads {b0}..{b1 - 1}, "
                    f"its query heads read {k0}..{k1 - 1}")
            k = kv[c]["k"][:, lo:hi, k0 - b0:k1 - b0]
            v = kv[c]["v"][:, lo:hi, k0 - b0:k1 - b0]
            return ops.flash_attention(
                qkv[c][0], k, v, causal=False, window=None,
                logit_softcap=logit_softcap).to(qkv[c][0].dtype)
        return run.each(own)
    if any(q1 - q0 < H for q0, q1, _, _ in heads.values()):
        qf = run.exchange(lambda c, g: [(s, qkv[s][0]) for s in g], 2,
                          "all-gather")
    else:
        qf = {c: qkv[c][0] for c in run.coords}

    def attend(c, q, k, v):
        a, e, _, _ = slots(c)
        s0, s1 = max(a, lo), min(e, hi)
        if s0 >= s1:
            return None
        return ops.flash_attention(
            q, k[:, s0 - a:s1 - a], v[:, s0 - a:s1 - a], causal=False,
            window=None, logit_softcap=logit_softcap, return_lse=True)

    # each coordinate's own heads of a block's (out, lse), on a new
    # leading dim
    def out_of(c, t):
        return t[0][:, :, heads[c][0]:heads[c][1]][None]

    def lse_of(c, t):
        return t[1][:, heads[c][0]:heads[c][1]][None]

    if kv_at is None:
        part = run.each(lambda c: attend(c, qf[c], kv[c]["k"], kv[c]["v"]))
        # every block of the group's, stacked in model order
        outs = run.exchange(lambda c, g: [
            (s, out_of(c, part[s])) for s in g if part[s] is not None], 0)
        lses = run.exchange(lambda c, g: [
            (s, lse_of(c, part[s])) for s in g if part[s] is not None], 0)
    else:
        # every block at its own coordinate (q from its class), and each
        # coordinate's heads from every block in row-major block order
        blocks = ksh.coords
        part = {}
        for d in blocks:
            with compat.at(d):
                part[d] = attend(d, qf[run.rep[d]].to(run.device(d)),
                                 kv_at(d, "k"), kv_at(d, "v"))
        outs = run.gather_all(lambda c, d: None if part[d] is None
                              else out_of(c, part[d]), blocks, 0)
        lses = run.gather_all(lambda c, d: None if part[d] is None
                              else lse_of(c, part[d]), blocks, 0)

    def combine(c):
        ls = list(lses[c])
        return _lse_combine(list(zip(outs[c], ls)), functools.reduce(
            torch.maximum, ls)).to(qkv[c][0].dtype)
    return run.each(combine)


# ---------------------------------------------------------------------------
# MLA forward (naive at prefill, absorbed at decode)
# ---------------------------------------------------------------------------

def mla_forward(params, cfg: ModelConfig, x: torch.Tensor, start: int = 0,
                *, cache=None, block: int = 512, policy=None):
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
    the running max).  ``policy``: a :class:`MeshPolicy` whose mesh
    sends a one-token step over a cache through
    :func:`_mla_decode_seq_parallel`.  The logits block is (B, H, S,
    block) in f32, 2.15 GB at deepseek-v2's prefill of 2 x 4096: it is
    updated in place, in the reference's order of operations."""
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
        n_seq = n_seq_shards(policy, B, mla=True)
        if S == 1 and n_seq > 1 and cc.shape[1] % n_seq == 0:
            scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
            q_lat = torch.einsum("bshn,rhn->bshr", q_nope, params["w_uk"])
            ctx_lat = _mla_decode_seq_parallel(policy, q_lat, q_rope, cc,
                                               cr, start, scale)
            ctx = torch.einsum("bshr,rhv->bshv", ctx_lat.to(x.dtype),
                               params["w_uv"])
            wo = params["wo"]
            return ctx.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1]), \
                cache
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
