"""Mixture-of-Experts FFN, single device.

``moe_ffn_local`` is the reference's dropless MoE (``repro.models.moe``):
sort tokens by expert, run each expert's gated FFN on its contiguous row
group, unsort, combine.  The reference's ``jax.lax.ragged_dot`` has no
PyTorch twin; here a group is one ``torch.matmul`` per expert weight on
a view of that expert's slice (``w1[e]``).  Slicing needs the group
sizes on the host — one device-to-host read per MoE layer.

The Morpheus hot-expert fast path
(``core/passes/branch_inject.py::moe_ffn_hotpath``) goes through the same
:func:`_dispatch` with the hot experts' groups, so for a batch whose
tokens all route to hot experts both paths issue the same GEMM on the
same rows per expert and agree bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .config import MoEConfig
from .layers import _act


def route(w_router, x2d: torch.Tensor, top_k: int, bias=None):
    """x2d: (T,D) -> gates (T,K) fp32, ids (T,K) int32, logits (T,E) fp32.
    ``bias``: additive per-expert routing bias."""
    logits = x2d.float() @ w_router.float()
    if bias is not None:
        logits = logits + bias.float()
    gates, ids = torch.topk(logits, top_k, dim=-1)
    gates = torch.softmax(gates, dim=-1)
    return gates, ids.to(torch.int32), logits


def load_balance_loss(logits: torch.Tensor, ids: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss (per-shard; caller averages)."""
    probs = torch.softmax(logits, dim=-1)                    # (T,E)
    density_proxy = probs.mean(dim=0)                        # (E,)
    onehot = F.one_hot(ids.long(), n_experts).float()
    density = onehot.sum(dim=(0, 1)) / ids.numel()           # (E,)
    return n_experts * (density * density_proxy).sum()


def _expert_compute(xs: torch.Tensor, group_sizes: Sequence[int],
                    w1, w3, w2, act: str = "silu",
                    experts: Optional[Sequence[int]] = None
                    ) -> torch.Tensor:
    """xs: (N,D) sorted by group; ``group_sizes`` (host ints) give the
    row count of each group; group g runs expert ``experts[g]`` (default:
    group g is expert g) of the stacked weights.  Returns (N,D)."""
    experts = range(len(group_sizes)) if experts is None else experts
    out = []
    start = 0
    for e, g in zip(experts, group_sizes):
        if g == 0:
            continue
        rows = xs[start:start + g]
        h = _act(rows @ w1[e], act) * (rows @ w3[e])
        out.append(h @ w2[e])
        start += g
    if not out:
        return xs.new_zeros(xs.shape)
    return torch.cat(out)


def _dispatch(params, x2d: torch.Tensor, gates: torch.Tensor,
              keys: torch.Tensor, group_sizes: Sequence[int],
              experts: Sequence[int], top_k: int, act: str) -> torch.Tensor:
    """Sort the T*K (token, choice) pairs by ``keys`` (a stable sort, as
    ``jnp.argsort``), run the groups, unsort and combine with the gates."""
    T, D = x2d.shape
    order = torch.argsort(keys, stable=True)
    xs = x2d[order // top_k]
    ys = _expert_compute(xs, group_sizes, params["w1"], params["w3"],
                         params["w2"], act, experts)
    y = torch.empty_like(ys)
    y[order] = ys                                            # unsort
    y = (y.reshape(T, top_k, D) * gates[..., None].to(y.dtype)).sum(dim=1)
    return y.to(x2d.dtype)


def moe_ffn_local(params, x2d: torch.Tensor, moe: MoEConfig,
                  act: str = "silu"):
    E, K = moe.num_experts, moe.top_k
    gates, ids, logits = route(params["w_router"], x2d, K,
                               params.get("b_router"))
    flat_ids = ids.reshape(-1).long()                        # (T*K,)
    group_sizes = torch.bincount(flat_ids, minlength=E)
    y = _dispatch(params, x2d, gates, flat_ids, group_sizes.tolist(),
                  range(E), K, act)
    aux = load_balance_loss(logits, ids, E)
    return y, {"aux_loss": aux,
               "dropped": torch.zeros((), device=x2d.device),
               "expert_counts": group_sizes.to(torch.int32)}
