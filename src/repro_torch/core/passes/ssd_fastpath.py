"""Branch injection for SSD-scan state restore — the Mamba2/Jamba fast
path's planning half.

An SSM serving plane keeps per-slot recurrent state in an RW table with a
``count`` write counter.  Fresh slots (count 0) hold all-zero state, so
a batch of only fresh slots can start the scan from zeros instead of
gathering saved state.  This pass claims the state table's cheap
``count`` lookup site with an ``ssd_fastpath`` SiteSpec whose
``hot_keys`` are the heavy-hitter slots, when they cover enough traffic
and are all still fresh.  The data plane reads the claim back through
``ctx.fastpath_keys(table, "ssd_fastpath")`` and builds its initial
state with :func:`ssd_init_state_hotpath`:

    all(count[slot] == 0) ?  zero init (no state gather at all)
                          :  gather saved rows from the state table

The reference branches on the device (``lax.cond``).  Here the predicate
is read on the host: one device-to-host read per SSM block per step, the
same pattern as the MoE fast path's ``all_hot`` read.

Invariant required of the plane: ``count[slot] == 0`` implies the saved
``state`` row is all zeros (plane writes bump the counter in the same
``ctx.update``; control writes flush or warm both together).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..instrument import SketchConfig
from ..specialize import SiteSpec
from .registry import SpecializationPass


def plan_ssd_fastpath(hot: np.ndarray, coverage: float,
                      cfg: SketchConfig,
                      counts: np.ndarray) -> Optional[Tuple[int, ...]]:
    """Claim when the observed hot slots cover enough traffic AND the
    control plane's view of every hot slot is still fresh (count == 0)."""
    if len(hot) == 0 or coverage < cfg.hot_coverage:
        return None
    n = counts.shape[0]
    for k in hot:
        k = int(k)
        if k >= n or int(counts[k]) != 0:
            return None
    return tuple(int(k) for k in hot)


class SSDFastPathPass(SpecializationPass):
    """Claims the SSM state table's ``count`` lookup site with a
    ``ssd_fastpath`` SiteSpec whose ``hot_keys`` are the heavy-hitter
    slots; the count lookup itself dispatches as a plain gather."""

    name = "ssd_fastpath"

    def __init__(self, state_table: Optional[str],
                 count_field: str = "count"):
        self.state_table = state_table
        self.count_field = count_field

    def match(self, site):
        return (site.kind == "lookup"
                and self.state_table is not None
                and site.table == self.state_table
                and self.count_field in (site.fields or ()))

    def plan(self, site, snapshot, stats):
        tab = snapshot.get(self.state_table)
        if tab is None or self.count_field not in tab.fields:
            return None
        hot, coverage = stats.hot_for(site.site_id)
        counts = np.asarray(tab.fields[self.count_field])
        keys = plan_ssd_fastpath(hot, coverage, stats.sketch, counts)
        if keys is None:
            return None
        return SiteSpec(impl="ssd_fastpath", hot_keys=keys)


def ssd_init_state_hotpath(counts: torch.Tensor,
                           gather_state: Callable[[], torch.Tensor],
                           shape: Tuple[int, ...]) -> torch.Tensor:
    """The injected branch: a whole-batch freshness predicate selecting
    the SSD scan's initial state.  ``counts`` are the batch slots' write
    counters (already looked up: the cheap, instrumented site);
    ``gather_state`` gathers the saved rows from the raw state table and
    is called only on the slow branch, so the fast branch never touches
    the wide state table; ``shape`` is the (B, H, P, N) init-state shape.
    Exact: fresh slots hold all-zero rows by the table's write invariant,
    and the scan from explicit zeros is bitwise the zero-init scan."""
    if bool((counts == 0).all()):
        return torch.zeros(shape, dtype=torch.float32, device=counts.device)
    return gather_state().to(torch.float32).reshape(shape)
