"""Traffic-dependent fast path (§4.3.1 JIT of heavy hitters).

Given instrumentation stats for a lookup site, if a small hot set covers
enough traffic, front the table with a hot-row cache: the CUDA ``hot_gather`` kernel
stages the hot rows in shared memory; cold keys are read from the table
in device memory.
RO sites need no guard (program-level guard covers control-plane writes);
RW sites get an in-graph guard (decided by guard_elision)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..instrument import SketchConfig
from ..specialize import SiteSpec
from ..tables import Table
from .registry import SpecializationPass


class TrafficFastPathPass(SpecializationPass):
    name = "fastpath"

    def plan(self, site, snapshot, stats):
        hot, coverage = stats.hot_for(site.site_id)
        return propose_fastpath(snapshot[site.table],
                                stats.mut(site.table), hot, coverage,
                                stats.sketch)


def propose_fastpath(table: Table, mutability: str, hot: np.ndarray,
                     coverage: float, cfg: SketchConfig
                     ) -> Optional[SiteSpec]:
    if len(hot) == 0 or coverage < cfg.hot_coverage:
        return None
    if table.n_valid <= table.max_inline:
        return None                      # already inlined wholesale
    return SiteSpec(impl="hot_cache",
                    hot_keys=tuple(int(k) for k in hot[: cfg.max_hot]))
