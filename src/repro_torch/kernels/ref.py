"""Plain PyTorch versions of the kernels on the serving path.

These are the semantics of record, ported from ``repro.kernels.ref``:
the CPU takes them directly (``kernels.ops``), and the CUDA kernels are
held against them on the card (``hot_gather`` bit for bit, ``ssd_scan``
and ``flash_attention`` within stated tolerances: their sums run in
another order).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        logit_softcap: float = 0.0,
                        block: int = 512, return_lse: bool = False):
    """The blocked attention ``models.attention.attend_blocked`` over
    the implicit positions ``arange(Sq)`` and ``arange(Sk)`` (so causal
    masking is top-left aligned).  q: (B, Sq, H, D); k, v: (B, Sk, Hkv,
    D) -> (B, Sq, H, D) in q's dtype, and with ``return_lse`` the rows'
    log2-unit logsumexp (B, H, Sq), f32, from the same running sums."""
    from ..models.attention import attend_blocked
    Sq, Sk = q.shape[1], k.shape[1]
    return attend_blocked(
        q, k, v,
        q_pos=torch.arange(Sq, dtype=torch.int32, device=q.device),
        kv_pos=torch.arange(Sk, dtype=torch.int32, device=q.device),
        causal=causal, window=window, logit_softcap=logit_softcap,
        block=block, return_lse=return_lse)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            logit_softcap: float = 0.0, block: int = 512):
    """``(dq, dk, dv)``: autograd through :func:`flash_attention_ref` at
    q, k, v with cotangent ``dout`` — the plain version of the
    ``flash_attention_bwd`` kernel (the reference differentiates its
    plain attention the same way)."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = flash_attention_ref(qq, kk, vv, causal=causal, window=window,
                                  logit_softcap=logit_softcap, block=block)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


LOG2E = 1.4426950408889634


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            logit_softcap: float = 0.0,
                            block: int = 512) -> torch.Tensor:
    """Each row's logsumexp over its visible keys in log2 units, f32
    (B, H, Sq): ``log2 sum 2^(s log2 e)`` with s the forward's logit
    (scale, softcap) and the mask of :func:`flash_attention_ref`;
    ``NEG_INF`` for a row that sees no key.  The plain version of what
    the ``flash_attention`` kernels write with ``return_lse=True`` and
    the backward reads, in query blocks of ``block`` rows."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kk = k.float().repeat_interleave(H // Hkv, dim=2)
    kpos = torch.arange(Sk, device=q.device)
    out = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    for i0 in range(0, Sq, block):
        qb = q[:, i0:i0 + block].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qb, kk) / math.sqrt(D)
        if logit_softcap:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        qpos = torch.arange(i0, i0 + qb.shape[1], device=q.device)
        mask = torch.ones((qb.shape[1], Sk), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
        lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, :, i0:i0 + block] = torch.where(
            mask.any(-1), lse * LOG2E, torch.tensor(NEG_INF))
    return out


SPLIT_TILE = 64    # the decode kernel plans its splits in 64-key tiles


def split_keys(Sk: int, splits: int) -> int:
    """Keys each of ``splits`` contiguous ranges takes: whole 64-key tiles,
    split ``s`` covering ``[s * n, min((s + 1) * n, Sk))``.  A split past
    ``Sk`` is empty."""
    tiles = -(-Sk // SPLIT_TILE)
    return max(1, -(-tiles // max(1, splits))) * SPLIT_TILE


def softcap_exp2(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(x / cap)`` as the CUDA kernels compute it:
    ``cap * (1 - 2 / (exp2(2 log2(e) x / cap) + 1))``, one exp2 and one
    reciprocal, finite at +-inf and at the -1e30 mask (-> +-cap)."""
    e = torch.exp2(x * (2.0 * LOG2E / cap))
    return cap * (1.0 - 2.0 / (e + 1.0))


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, splits: int,
                              causal: bool = True,
                              window: Optional[int] = None,
                              logit_softcap: float = 0.0) -> torch.Tensor:
    """The split-K decode kernel's arithmetic in plain PyTorch: each of
    ``splits`` contiguous key ranges (:func:`split_keys`) gives f32
    partials ``(m_s, l_s, acc_s)`` (``p = exp(x - m_s)`` rounded to v's
    type before ``p . v``, ``l_s`` the sum of the unrounded ``p``; a split
    that sees no key gives ``m_s = -1e30, l_s = 0``), combined in split
    order: ``m = max m_s``, ``l = sum l_s e^(m_s - m)``, ``out = sum acc_s
    e^(m_s - m) / max(l, 1e-30)``.  Positions are the implicit aranges.
    Only the tests use it."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    f32 = torch.float32
    qg = q.reshape(B, Sq, Hkv, G, D).to(f32)
    qp = torch.arange(Sq, device=q.device)[:, None]
    n = split_keys(Sk, splits)
    ms, ls, accs = [], [], []
    for s in range(splits):
        lo, hi = min(s * n, Sk), min((s + 1) * n, Sk)
        kp = torch.arange(lo, hi, device=q.device)[None, :]
        x = torch.einsum("bshgd,bthd->bhgst", qg, k[:, lo:hi].to(f32))
        x = x / math.sqrt(D)
        if logit_softcap:
            x = logit_softcap * torch.tanh(x / logit_softcap)
        mask = torch.ones((Sq, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kp <= qp)
        if window is not None:
            mask = mask & (qp - kp < window)
        x = torch.where(mask, x, NEG_INF)
        m = x.amax(dim=-1) if hi > lo else torch.full(
            (B, Hkv, G, Sq), NEG_INF, dtype=f32, device=q.device)
        p = torch.where(mask, torch.exp(x - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhgst,bthd->bhgsd", p.to(v.dtype).to(f32),
                                 v[:, lo:hi].to(f32)))
    m = torch.stack(ms).amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(accs[0])
    for m_s, l_s, a_s in zip(ms, ls, accs):
        w = torch.exp(m_s - m)
        l = l + l_s * w
        acc = acc + a_s * w[..., None]
    out = acc / l.clamp_min(1e-30)[..., None]          # (B, Hkv, G, Sq, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                 init_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD (arXiv:2405.21060 §6) chunked scan, one chunk at a time with
    the state carried across chunks.

    x: (B, S, H, P); dt: (B, S, H) softplus'd steps (> 0); A: (H,)
    negative decays; Bm/Cm: (B, S, G, N), head ``h`` reading group
    ``h // (H // G)``; init_state: (B, H, P, N) or None (the zero state,
    bitwise the same as explicit zeros).  Returns y (B, S, H, P) in
    ``x.dtype`` and the final state (B, H, P, N) in float32.  It computes
    in float32, or in float64 where x is float64 (an evaluation to hold
    f32 rounding against).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = chunk
    S_orig = S
    if S % Q:
        # padded steps have dt = 0: exp(dt*A) = 1 and zero input weight,
        # so they leave the state exactly as it was
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        S += pad
    rep = H // G
    f32 = torch.promote_types(x.dtype, torch.float32)
    tri = torch.ones((Q, Q), dtype=torch.bool,
                     device=x.device).tril()[None, :, :, None]
    state = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    Af = A.to(f32)
    ys = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xq = x[:, sl].to(f32)                                 # (B,Q,H,P)
        dtq = dt[:, sl].to(f32)                               # (B,Q,H)
        Bh = Bm[:, sl].to(f32).repeat_interleave(rep, dim=2)  # (B,Q,H,N)
        Ch = Cm[:, sl].to(f32).repeat_interleave(rep, dim=2)
        da = dtq * Af                                         # <= 0
        da_cs = torch.cumsum(da, dim=1)
        da_tot = da_cs[:, -1, :]                              # (B,H)

        # intra-chunk: mask BEFORE exp (the upper triangle's positive
        # sums overflow)
        seg = da_cs[:, :, None, :] - da_cs[:, None, :, :]     # (B,Q,Q,H)
        L = torch.exp(torch.where(tri, seg, -1e9))
        cb = torch.einsum("bihn,bjhn->bijh", Ch, Bh)
        att = cb * L * dtq[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", att, xq)

        # inter-chunk contribution from the carried state
        y = y + torch.einsum("bqh,bqhn,bhpn->bqhp", torch.exp(da_cs), Ch,
                             state)

        w = torch.exp(da_tot[:, None, :] - da_cs) * dtq       # (B,Q,H)
        state = (state * torch.exp(da_tot)[:, :, None, None]
                 + torch.einsum("bqh,bqhn,bqhp->bhpn", w, Bh, xq))
        ys.append(y.to(x.dtype))
    if not ys:
        return x.new_empty((Bsz, 0, H, P)), state
    return torch.cat(ys, dim=1)[:, :S_orig], state


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: the card's ``cvt.rna.tf32.f32``, as a mask of the low 13 bits of
    the rounded bit pattern."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor,
                terms: int = 3) -> torch.Tensor:
    """``a @ b`` (f32) as the tensor cores compute it from TF32 inputs.
    ``terms=3`` is the 3xTF32 split: each operand is ``hi + lo`` with
    both TF32, and ``lo . hi + hi . lo + hi . hi`` is summed in f32 (the
    ``lo . lo`` term, ~2^-22 of the product, is dropped).  ``terms=1`` is
    plain TF32, ``hi . hi`` alone."""
    ah, bh = round_tf32(a), round_tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = round_tf32(a - ah), round_tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def ssd_scan_blocked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                         init_state: Optional[torch.Tensor] = None, *,
                         tf32_terms: int = 3
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the ``ssd_scan`` CUDA kernel computes, in plain PyTorch: the
    function of :func:`ssd_scan_ref` in the kernel's three passes and with
    its tensor-core arithmetic (:func:`matmul_tf32`, ``tf32_terms`` TF32
    products a term).

    1. Per chunk and head, in parallel: ``da_cs``, the weights ``w_q =
       exp(da_tot - da_cs_q) dt_q`` and the chunk's own state increment
       ``(w x)^T . B``.
    2. The state pass, the only sequential part: ``s <- s exp(da_tot) +
       increment``, giving the state entering each chunk.
    3. Per chunk: ``C . B^T`` once per group (the kernel forms it once per
       block of heads that share the group, which gives the same values),
       then per head ``L = (C . B^T) exp(da_cs_i - da_cs_j) dt_j`` masked
       to ``j <= i`` before the exp, and ``y = exp(da_cs_i) (C . state^T)
       + L . x``.

    bf16 inputs are exact in TF32 (8 mantissa bits of 10), so their low
    halves are zero.  Only the tests use it."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q, rep = chunk, H // G
    f32 = torch.float32
    nc = -(-S // Q)
    pad = nc * Q - S
    # padded steps: dt = 0, x = B = C = 0 (they leave the state alone)
    xq = F.pad(x.to(f32), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, Q, H, P)
    dtq = F.pad(dt.to(f32), (0, 0, 0, pad)).reshape(Bsz, nc, Q, H)
    Bq = F.pad(Bm.to(f32), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, Q, G, N)
    Cq = F.pad(Cm.to(f32), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, Q, G, N)
    mm = lambda a, b: matmul_tf32(a, b, tf32_terms)
    grp = torch.arange(H, device=x.device) // rep

    # pass 1: (B, nc, H, ...) with heads moved before the step axis
    da_cs = torch.cumsum(dtq * A.to(f32), dim=2).permute(0, 1, 3, 2)
    dth = dtq.permute(0, 1, 3, 2)                            # (B,nc,H,Q)
    w = torch.exp(da_cs[..., -1:] - da_cs) * dth
    xh = xq.permute(0, 1, 3, 2, 4)                           # (B,nc,H,Q,P)
    Bh = Bq.permute(0, 1, 3, 2, 4)[:, :, grp]                # (B,nc,H,Q,N)
    Ch = Cq.permute(0, 1, 3, 2, 4)[:, :, grp]
    inc = mm((xh * w[..., None]).transpose(-1, -2), Bh)     # (B,nc,H,P,N)

    # pass 2
    s = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    entering = []
    for c in range(nc):
        entering.append(s)
        s = s * torch.exp(da_cs[:, c, :, -1])[..., None, None] + inc[:, c]
    states = torch.stack(entering, dim=1)                    # (B,nc,H,P,N)

    # pass 3
    cb = mm(Cq.permute(0, 1, 3, 2, 4),
            Bq.permute(0, 1, 3, 4, 2))[:, :, grp]            # (B,nc,H,Q,Q)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = torch.where(tri, da_cs[..., :, None] - da_cs[..., None, :], 0.0)
    L = torch.where(tri, cb * torch.exp(seg) * dth[..., None, :], 0.0)
    y = (mm(Ch, states.transpose(-1, -2)) * torch.exp(da_cs)[..., None]
         + mm(L, xh))                                        # (B,nc,H,Q,P)
    y = y.permute(0, 1, 3, 2, 4).reshape(Bsz, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), s


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                     dy: torch.Tensor, dfinal: Optional[torch.Tensor] = None,
                     init_state: Optional[torch.Tensor] = None):
    """``(dx, ddt, dA, dB, dC, dinit)``: autograd through
    :func:`ssd_scan_ref` with cotangents ``dy`` for y and ``dfinal`` for
    the final state (None: unused) — the plain version of the
    ``ssd_scan_bwd`` kernel (the reference differentiates its
    ``ssd_scan_ref`` the same way).  ``dinit`` is None without an
    ``init_state``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (x, dt, A, Bm, Cm)]
        s0 = (None if init_state is None
              else init_state.detach().requires_grad_(True))
        y, fin = ssd_scan_ref(*ins, chunk, init_state=s0)
        outs, cots = [y], [dy]
        if dfinal is not None:
            outs.append(fin)
            cots.append(dfinal)
        wrt = ins + ([] if s0 is None else [s0])
        grads = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, wrt)]
    return (*grads[:5], grads[5] if s0 is not None else None)


def ssd_scan_bwd_blocked_ref(x: torch.Tensor, dt: torch.Tensor,
                             A: torch.Tensor, Bm: torch.Tensor,
                             Cm: torch.Tensor, chunk: int, dy: torch.Tensor,
                             dfinal: Optional[torch.Tensor] = None,
                             init_state: Optional[torch.Tensor] = None, *,
                             hblk: int = 1, tf32_terms: int = 3):
    """What the ``ssd_scan_bwd`` CUDA kernel computes, in plain PyTorch:
    the function of :func:`ssd_scan_bwd_ref` in the kernel's passes and
    sums, with its tensor-core arithmetic (:func:`matmul_tf32` for every
    product: ``tf32_terms=3`` splits each f32 operand into TF32 halves;
    a bf16 operand is exact in TF32, its low half zero, so its term
    vanishes; ``tf32_terms=1`` is plain TF32).  Per chunk c with ``cs``
    the running sum of ``dt A``, ``tot`` its last value, S_c the state
    entering the chunk (recomputed here as the forward kernel computes
    it; the kernel reads the forward's) and dS_c its gradient:

    1. ``local_c = (exp(cs) dy)^T C``, per chunk in parallel.
    2. The state pass, backwards over chunks from ``dfinal``: chunk c
       takes ``dS_{c+1}`` (the gradient of the state it leaves), then
       ``dS_c = exp(tot_c) dS_{c+1} + local_c``; ``dinit = dS_0``; and
       ``<dS_{c+1}, S_{c+1}>``, the gradient of ``tot_c``.
    3. Per chunk, ``C . B^T`` once per group (the kernel forms it once
       per block of heads that share the group, which gives the same
       values); per head ``dy . x^T``, and with ``L_ij = exp(cs_i -
       cs_j)`` for j <= i (masked before the exp) and ``w_j = exp(tot -
       cs_j) dt_j`` the scores ``t1 = (C . B^T) L`` and ``t2 = (dy . x^T)
       L dt_j``; ``dx / dt = t1^T dy + exp(tot - cs) B dS^T``, the head's
       ``dB = w x dS + t2^T C`` and ``dC = exp(cs) dy S + t2 B``; each
       gives its share of ``d cs``.
    4. ``d da`` is the reverse running sum of ``d cs``; ``ddt = x.dx/dt
       + A d da``, ``dA = sum d da dt``; dB and dC are summed over each
       block of ``hblk`` heads in head order (as the kernel does in
       registers), then over the blocks of a group in order.  ``hblk``
       divides H/G; the kernel's is ``ssd_scan.head_block(H // G)``.

    Padded steps of a ragged last chunk read as dt = x = B = C = dy = 0.
    Only the tests use it."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q, rep = chunk, H // G
    if rep % hblk:
        raise ValueError(f"hblk={hblk} does not divide H/G={rep}")
    f32 = torch.float32
    nc = -(-S // Q)
    pad = nc * Q - S
    grp = torch.arange(H, device=x.device) // rep
    exact = x.dtype != f32             # bf16 operands: exact in TF32

    def mm(a, b, both_exact=False):
        return matmul_tf32(a, b, 1 if both_exact else tf32_terms)

    def rows(t, width):        # (B, S, ., width) -> (B, nc, ., Q, width)
        t = F.pad(t.to(f32), (0, 0, 0, 0, 0, pad))
        return t.reshape(Bsz, nc, Q, t.shape[2], width).permute(0, 1, 3, 2,
                                                                 4)
    xh, dyh = rows(x, P), rows(dy, P)                        # (B,nc,H,Q,P)
    Bg, Cg = rows(Bm, N), rows(Cm, N)                        # (B,nc,G,Q,N)
    Bh, Ch = Bg[:, :, grp], Cg[:, :, grp]
    dth = F.pad(dt.to(f32), (0, 0, 0, pad)).reshape(
        Bsz, nc, Q, H).permute(0, 1, 3, 2)                   # (B,nc,H,Q)
    Af = A.to(f32)
    cs = torch.cumsum(dth * Af[:, None], dim=-1)
    tot = cs[..., -1]                                        # (B,nc,H)
    w = torch.exp(tot[..., None] - cs) * dth

    # the forward's states: entering each chunk, and the final one
    inc = mm((xh * w[..., None]).transpose(-1, -2), Bh)      # (B,nc,H,P,N)
    s = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    entering = []
    for c in range(nc):
        entering.append(s)
        s = s * torch.exp(tot[:, c])[..., None, None] + inc[:, c]
    states, final = torch.stack(entering, dim=1), s

    # pass 1
    local = mm((dyh * torch.exp(cs)[..., None]).transpose(-1, -2), Ch)
    # pass 2
    d = (torch.zeros_like(final) if dfinal is None else dfinal.to(f32))
    dso, dtot = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        nxt = states[:, c + 1] if c + 1 < nc else final
        dso[c] = d
        dtot[c] = (d * nxt).sum(dim=(-1, -2))
        d = d * torch.exp(tot[:, c])[..., None, None] + local[:, c]
    dS, dtot = torch.stack(dso, dim=1), torch.stack(dtot, dim=1)

    # pass 3
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = torch.where(tri, cs[..., :, None] - cs[..., None, :], 0.0)
    L = torch.where(tri, torch.exp(seg), 0.0)                # [.., i, j]
    cb = mm(Cg, Bg.transpose(-1, -2), exact)[:, :, grp]      # once a group
    dyx = mm(dyh, xh.transpose(-1, -2), exact)
    t1 = cb * L
    t2 = dyx * L * dth[..., None, :]
    e = t2 * cb
    v = mm(Bh, dS.transpose(-1, -2))                         # (B,nc,H,Q,P)
    dxu = (mm(t1.transpose(-1, -2), dyh)
           + torch.exp(tot[..., None] - cs)[..., None] * v)
    dB = w[..., None] * mm(xh, dS) + mm(t2.transpose(-1, -2), Ch)
    dcs = -e.sum(dim=-2) - w * (xh * v).sum(dim=-1)
    dCi = torch.exp(cs)[..., None] * mm(dyh, states)
    dC = dCi + mm(t2, Bh)
    dcs = dcs + e.sum(dim=-1) + (Ch * dCi).sum(dim=-1)
    # pass 4
    dcs[..., -1] += dtot
    dda = torch.flip(torch.cumsum(torch.flip(dcs, [-1]), dim=-1), [-1])
    ddt = (xh * dxu).sum(dim=-1) + dda * Af[:, None]
    dA = (dda * dth).sum(dim=(0, 1, 3))

    def steps(t):              # (B, nc, ., Q, w) -> (B, S, ., w)
        return t.permute(0, 1, 3, 2, 4).reshape(Bsz, nc * Q, t.shape[2],
                                                t.shape[4])[:, :S]

    def by_group(t):           # (B, S, H, N): head blocks, then blocks
        t = t.reshape(Bsz, S, G, rep // hblk, hblk, N)
        blocks = t[:, :, :, :, 0]
        for k in range(1, hblk):
            blocks = blocks + t[:, :, :, :, k]
        out = blocks[:, :, :, 0]
        for k in range(1, rep // hblk):
            out = out + blocks[:, :, :, k]
        return out
    dx = steps(dth[..., None] * dxu).to(x.dtype)
    ddt = ddt.permute(0, 1, 3, 2).reshape(Bsz, nc * Q, H)[:, :S]
    dB = by_group(steps(dB)).to(Bm.dtype)
    dC = by_group(steps(dC)).to(Cm.dtype)
    return dx, ddt, dA, dB, dC, (None if init_state is None else d)


def ssd_decode_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSM update.  x: (B, H, P), dt: (B, H), Bm/Cm:
    (B, G, N), state: (B, H, P, N) -> y (B, H, P) in ``x.dtype``, new
    state in float32."""
    H, G = x.shape[1], Bm.shape[1]
    rep = H // G
    f32 = torch.float32
    Bh = Bm.to(f32).repeat_interleave(rep, dim=1)                # (B,H,N)
    Ch = Cm.to(f32).repeat_interleave(rep, dim=1)
    da = dt.to(f32) * A.to(f32)                                  # (B,H)
    new_state = (state.to(f32) * torch.exp(da)[:, :, None, None]
                 + torch.einsum("bh,bhn,bhp->bhpn", dt.to(f32), Bh,
                                x.to(f32)))
    y = torch.einsum("bhn,bhpn->bhp", Ch, new_state)
    return y.to(x.dtype), new_state


def hot_gather_ref(table: torch.Tensor, hot_rows: torch.Tensor,
                   hot_ids: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The fast-path cache's semantics: rows whose id appears in
    ``hot_ids`` come from ``hot_rows`` (the first matching position),
    every other row from ``table`` at ``idx`` clipped to ``[0, V-1]``.
    With ``hot_rows`` a verbatim copy the result equals ``table[idx]``.

    table: (V, D); hot_rows: (Hn, D); hot_ids: (Hn,); idx: (T,) -> (T, D).
    """
    match = idx[:, None] == hot_ids[None, :]                    # (T, Hn)
    hit = match.any(dim=1)
    # argmax over a 0/1 int tensor returns the first maximal position
    hot_pos = match.to(torch.int32).argmax(dim=1)
    from_hot = hot_rows.index_select(0, hot_pos)
    from_table = table.index_select(
        0, idx.clamp(0, table.shape[0] - 1))
    return torch.where(hit[:, None], from_hot, from_table)


def onehot_lookup_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (V, D), idx: (T,) -> (T, D) via a one-hot matmul (the
    data-structure specialization for small V)."""
    onehot = F.one_hot(idx.long(), table.shape[0]).to(table.dtype)
    return onehot @ table
