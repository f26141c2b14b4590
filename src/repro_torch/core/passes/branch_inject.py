"""Branch injection (§4.3.5) — the MoE hot-expert fast path.

The router table is the `vip_map`: instrumentation finds heavy-hitter
experts; we inject a cheap whole-batch predicate BEFORE the generic
dispatch:

    all(top-k expert ids in hot set) ?  grouped compute over |H| hot experts
                                      : full dispatch over every expert

The predicate is the injected branch; the hot-expert path is the
specialized code; the generic path is the deopt target.  It is
traffic-dependent and self-guarding: it re-validates per batch, so router
drift degrades to the generic path instead of computing garbage.

The reference branches on the device (``lax.cond``).  Here the predicate
is read on the host in the same device-to-host read that brings the
group sizes the per-expert GEMMs need — one read per MoE layer either
way.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ...models.config import ModelConfig
from ...models.moe import _dispatch, load_balance_loss, route
from ..instrument import SketchConfig
from ..specialize import SiteSpec
from .registry import SpecializationPass


def plan_moe_fastpath(hot: np.ndarray, coverage: float,
                      cfg: SketchConfig) -> Optional[Tuple[int, ...]]:
    if len(hot) == 0 or coverage < cfg.hot_coverage:
        return None
    return tuple(int(k) for k in hot)


class MoEFastPathPass(SpecializationPass):
    """Claims the router table's lookup site with a ``moe_fastpath``
    SiteSpec whose ``hot_keys`` are the heavy-hitter experts.  The data
    plane reads them back via ``ctx.hot_experts(table)`` and runs the
    branch-injected hot path; the router lookup itself dispatches as a
    plain gather."""

    name = "moe_fastpath"

    def __init__(self, router_table: Optional[str]):
        self.router_table = router_table

    def match(self, site):
        return (site.kind == "lookup"
                and self.router_table is not None
                and site.table == self.router_table)

    def plan(self, site, snapshot, stats):
        hot, coverage = stats.hot_for(site.site_id)
        keys = plan_moe_fastpath(hot, coverage, stats.sketch)
        if keys is None:
            return None
        return SiteSpec(impl="moe_fastpath", hot_keys=keys)


@functools.lru_cache(maxsize=64)
def _remap(hot_experts: Tuple[int, ...], E: int,
           dev: torch.device) -> torch.Tensor:
    """Global expert id -> hot slot (or -1), on ``dev``: built and copied
    to the device once per hot set and device, not per call."""
    host = np.full((E,), -1, np.int64)
    host[list(hot_experts)] = np.arange(len(hot_experts))
    return torch.as_tensor(host).to(dev)


def moe_ffn_hotpath(params, x2d: torch.Tensor, cfg: ModelConfig,
                    hot_experts: Tuple[int, ...], act: str = "silu"):
    """Specialized MoE FFN: when every token's top-k experts are hot,
    only the hot experts' groups run (weights indexed as views of the
    expert stacks); otherwise the full dispatch runs.  Returns
    (y, metrics) like ``moe_ffn_local``.  The device work before the
    branch is the generic path's: the routing and one count per expert,
    read to the host once; the predicate (every (token, choice) pair on a
    hot expert) and the hot groups' sizes are taken from those counts on
    the host."""
    moe = cfg.moe
    E, K = moe.num_experts, moe.top_k
    dev = x2d.device
    gates, ids, logits = route(params["w_router"], x2d, K,
                               params.get("b_router"))
    flat = ids.reshape(-1).long()
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat, torch.ones_like(flat))
    # the one device-to-host read of the layer, as the generic path's
    sizes = counts.tolist()
    hot_sizes = [sizes[e] for e in hot_experts]
    all_hot = sum(hot_sizes) == flat.numel()
    if all_hot:
        slots = _remap(hot_experts, E, dev)[flat]
        y = _dispatch(params, x2d, gates, slots, hot_sizes, hot_experts, K,
                      act)
    else:
        y = _dispatch(params, x2d, gates, flat, sizes, range(E), K, act)
    aux = load_balance_loss(logits, ids, E)
    return y, {"aux_loss": aux, "dropped": 0.0,
               "expert_counts": counts.to(torch.int32),
               "fastpath_hit": int(all_hot)}
