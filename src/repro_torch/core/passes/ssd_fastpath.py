"""Branch injection for SSD-scan state restore — the Mamba2/Jamba fast
path's planning half.

An SSM serving plane keeps per-slot recurrent state in an RW table with a
``count`` write counter.  Fresh slots (count 0) hold all-zero state, so
a batch of only fresh slots can start the scan from zeros instead of
gathering saved state.  This pass claims the state table's cheap
``count`` lookup site with an ``ssd_fastpath`` SiteSpec whose
``hot_keys`` are the heavy-hitter slots, when they cover enough traffic
and are all still fresh.  The data plane's injected branch
(``ssd_init_state_hotpath`` in the reference) waits for the arch-zoo
slice of the port; the pass is here so the default registry plans what
the reference plans.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

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
