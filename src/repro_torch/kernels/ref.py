"""Plain PyTorch versions of the kernels on the serving path.

These are the semantics of record, ported from ``repro.kernels.ref``:
the CPU takes them directly (``kernels.ops``), and the CUDA kernels are
held against them on the card (``hot_gather`` bit for bit, ``ssd_scan``
and ``flash_attention`` within stated tolerances: their sums run in
another order).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        logit_softcap: float = 0.0,
                        block: int = 512) -> torch.Tensor:
    """The blocked attention ``models.attention.attend_blocked`` over
    the implicit positions ``arange(Sq)`` and ``arange(Sk)`` (so causal
    masking is top-left aligned).  q: (B, Sq, H, D); k, v: (B, Sk, Hkv,
    D) -> (B, Sq, H, D) in q's dtype."""
    from ..models.attention import attend_blocked
    Sq, Sk = q.shape[1], k.shape[1]
    return attend_blocked(
        q, k, v,
        q_pos=torch.arange(Sq, dtype=torch.int32, device=q.device),
        kv_pos=torch.arange(Sk, dtype=torch.int32, device=q.device),
        causal=causal, window=window, logit_softcap=logit_softcap,
        block=block)


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
    ``x.dtype`` and the final state (B, H, P, N) in float32.
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
    f32 = torch.float32
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
