"""Mixture-of-Experts FFN, single device.

``moe_ffn_local`` is the reference's dropless MoE (``repro.models.moe``):
sort tokens by expert, run each expert's gated FFN on its contiguous row
group, unsort, combine.  The reference's ``jax.lax.ragged_dot`` has no
PyTorch twin; here a group is one ``torch.matmul`` per expert weight on
a view of that expert's slice (``w1[e]``).  Slicing needs the group
sizes on the host — one device-to-host read per MoE layer, and no other
(the counts are a ``scatter_add_``: ``torch.bincount`` on the card reads
its input's min and max on the host first).

:func:`moe_ffn` is the transformer's entry, for one device only: the
reference's expert-parallel ``moe_ffn_sharded`` (a mesh; ROADMAP Queue 1
item 12) and its hot-expert branch, reached only through
``meshctx.use_moe_hot`` in the training step (item 10), are not ported.

Routing ties: ``jax.lax.top_k`` returns the lower expert id first among
equal logits.  :func:`route` takes the first k of a stable descending
sort, which keeps that order (``torch.topk`` promises none).

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

from .config import MoEConfig, ModelConfig
from .layers import _act, ffn, init_ffn
from .params import Initializer


def init_moe(ini: Initializer, cfg: ModelConfig):
    """The reference's tree: an f32 router (also in a bf16 model), expert
    stacks ``w1`` / ``w3`` (E, D, F) and ``w2`` (E, F, D), and ``shared``
    (a gated FFN of ``num_shared`` experts' width) when it is set."""
    moe: MoEConfig = cfg.moe
    d = cfg.d_model
    f = moe.expert_d_ff or cfg.d_ff
    E = moe.num_experts
    p = {
        "w_router": ini.normal((d, E), dtype=torch.float32),
        "b_router": ini.zeros((E,), dtype=torch.float32),
        "w1": ini.normal((E, d, f)),
        "w3": ini.normal((E, d, f)),
        "w2": ini.normal((E, f, d), fan_in=f),
    }
    if moe.num_shared:
        p["shared"] = init_ffn(ini, d, moe.num_shared *
                               (moe.shared_d_ff or f))
    return p


def route(w_router, x2d: torch.Tensor, top_k: int, bias=None):
    """x2d: (T,D) -> gates (T,K) fp32, ids (T,K) int32, logits (T,E) fp32.
    ``bias``: additive per-expert routing bias."""
    logits = x2d.float() @ w_router.float()
    if bias is not None:
        logits = logits + bias.float()
    gates, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :top_k], ids[:, :top_k]
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
                  act: str = "silu", aux_loss: bool = True):
    """(y, metrics); ``aux_loss=False`` skips the load-balance loss (its
    metric is then a host 0.0), for callers that discard it."""
    E, K = moe.num_experts, moe.top_k
    gates, ids, logits = route(params["w_router"], x2d, K,
                               params.get("b_router"))
    flat_ids = ids.reshape(-1).long()                        # (T*K,)
    group_sizes = torch.zeros(E, dtype=torch.long, device=x2d.device
                              ).scatter_add_(0, flat_ids,
                                             torch.ones_like(flat_ids))
    y = _dispatch(params, x2d, gates, flat_ids, group_sizes.tolist(),
                  range(E), K, act)
    aux = load_balance_loss(logits, ids, E) if aux_loss else 0.0
    return y, {"aux_loss": aux, "dropped": 0.0,
               "expert_counts": group_sizes.to(torch.int32)}


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig,
            aux_loss: bool = True):
    """x: (B,S,D) -> (y, metrics), the reference's ``moe_ffn`` with no
    mesh and no hot-expert set: ``moe_ffn_local`` over the B*S tokens,
    plus the shared experts' FFN when ``num_shared`` is set."""
    moe = cfg.moe
    B, S, D = x.shape
    y, metrics = moe_ffn_local(params, x.reshape(B * S, D), moe,
                               cfg.ffn_act, aux_loss)
    y = y.reshape(B, S, D)
    if moe.num_shared:
        y = y + ffn(params["shared"], x, cfg.ffn_act)
    return y, metrics
