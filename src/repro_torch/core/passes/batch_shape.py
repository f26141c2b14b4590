"""Batch-shape specialization from the observed arrival process.

The serving frontend pads ragged request groups to a pad bucket and
fuses up to K batches into one ``step_many`` window.  Which buckets,
and how deep a window, are traffic-dependent choices — exactly the kind
of decision Morpheus makes from instrumentation instead of at deploy
time.  This plan-level pass reads the frontend's arrival profile
(``PlanInputs.profile``: batch-size histogram, arrival rate, the
batcher's bucket ladder and wait budget) and bakes the chosen
``(pad buckets, window depth K)`` into the plan as a *pseudo-site*
spec:

  * the site id ``__frontend__#batch_shape`` never occurs as a real
    table call site, so lookup dispatch never sees it — but it IS part
    of ``plan.sites`` and therefore of the plan *signature*: a bucket
    shift produces a genuinely new plan, new executables, and an atomic
    swap, and the batcher reads its current shape straight off the
    active plan (:func:`plan_batch_shape`);
  * misprediction deopts through the EXISTING program guard: when the
    observed sizes drift off the planned buckets, the batcher bumps the
    table version — every specialized executable deopts to generic and
    the next recompile cycle re-selects buckets from the fresh
    histogram.  No new guard machinery.

Selection policy (deliberately simple, monotone in the data):

  * primary bucket: the smallest ladder bucket covering the
    ``coverage`` quantile (default p95) of observed group sizes — big
    enough that almost every formed group fits without splitting;
  * secondary bucket: the smallest ladder bucket covering the median,
    kept when it is strictly smaller — off-peak groups then pad to the
    small bucket instead of the big one (pad occupancy, not tail
    latency, is what the second bucket buys);
  * window depth K: how many primary-bucket batches the observed
    arrival rate can fill within one batcher wait budget —
    ``clamp(rate x max_wait / primary, 1, k_max)`` — so fused windows
    deepen under load and collapse to single steps when traffic is
    light;
  * hysteresis: when the profile carries the currently-serving shape
    (``prev_shape``, injected by the runtime at each recompile cycle)
    and the fresh primary sits within one ladder step of the serving
    primary, the pass unions the fresh buckets with every serving
    bucket the traffic still touches instead of flipping between
    near-equal selections — a quantile hovering at a bucket edge then
    converges to a stable superset (supersets never introduce
    mispredicts) rather than swapping the plan signature every cycle.
    Abandoned buckets (zero observed fit-mass) drop out, and a primary
    moving two or more ladder steps is a regime change that takes the
    fresh selection outright; a one-step K shrink holds the serving
    depth, deeper shifts apply immediately.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..specialize import SiteSpec
from .registry import PlanDraft, SpecializationPass

# pseudo-site id: the "#"-qualified form real sites use, under a table
# name that cannot exist (TableSet names never start with "__")
BATCH_SHAPE_SITE = "__frontend__#batch_shape"


class BatchShapePass(SpecializationPass):
    """Plan-level pass: select pad buckets + fused window depth from the
    frontend's observed arrival profile.  No-op (plan unchanged) until a
    profile with at least ``min_batches`` formed groups is attached."""

    name = "batch_shape"

    def __init__(self, min_batches: int = 16, coverage: float = 0.95):
        self.min_batches = int(min_batches)
        self.coverage = float(coverage)

    def match(self, site) -> bool:          # never claims a real site
        return False

    def finalize(self, draft: PlanDraft, snapshot, stats) -> None:
        prof = stats.profile
        if not prof:
            return
        ladder = tuple(int(b) for b in prof.get("ladder", ()))
        hist = np.asarray(prof.get("size_hist", ()), np.int64)
        total = int(hist.sum()) if hist.size else 0
        if not ladder or total < self.min_batches:
            return

        # size_hist[i] counts formed groups of size i+1 (ragged group
        # sizes BEFORE padding).  Quantiles over that distribution pick
        # the buckets.
        cdf = np.cumsum(hist) / total
        last = hist.size - 1
        s_cov = int(min(np.searchsorted(cdf, self.coverage), last)) + 1
        s_med = int(min(np.searchsorted(cdf, 0.5), last)) + 1

        def fit(n: int) -> int:
            for b in ladder:
                if b >= n:
                    return b
            return ladder[-1]

        primary = fit(s_cov)
        secondary = fit(s_med)
        buckets = ((secondary, primary) if secondary < primary
                   else (primary,))

        rate = float(prof.get("arrival_rate_hz", 0.0))
        max_wait = float(prof.get("max_wait_s", 0.0))
        k_max = max(int(prof.get("window_k_max", 1)), 1)
        k = 1
        if rate > 0.0 and max_wait > 0.0:
            k = int(rate * max_wait / primary)
            k = max(1, min(k, k_max))

        prev = prof.get("prev_shape")
        if prev:
            pbuckets = tuple(int(b) for b in prev[0])
            pk = int(prev[1])
            li = {b: i for i, b in enumerate(ladder)}
            pp = pbuckets[-1] if pbuckets else None
            if (pp in li and primary in li
                    and abs(li[pp] - li[primary]) <= 1):
                # hysteresis: the same traffic regime (primary within
                # one ladder step of the serving shape) must not flip
                # the plan signature every cycle just because a
                # quantile hovers at a bucket edge.  Accumulate instead
                # of flipping: union the fresh selection with every
                # serving bucket that still has observed mass — a
                # superset never introduces mispredicts (more buckets
                # offered, never fewer), and edge-hovering converges to
                # a stable set within one cycle.  Buckets the traffic
                # has abandoned (zero fit-mass) drop out; a primary
                # moving two or more ladder steps is a regime change
                # and takes the fresh selection outright.
                mass: dict = {}
                for s, n in enumerate(hist.tolist(), start=1):
                    if n:
                        b = fit(s)
                        mass[b] = mass.get(b, 0) + int(n)
                keep = [b for b in pbuckets
                        if b in li and mass.get(b, 0) > 0]
                buckets = tuple(sorted(set(buckets) | set(keep)))
                if pk - k == 1:
                    # same damping for the window depth: a one-step K
                    # shrink holds; growth and deeper shrinks apply
                    k = pk

        draft.specs[BATCH_SHAPE_SITE] = SiteSpec(
            impl="batch_shape", hot_keys=buckets,
            const_fields=(("window_k", int(k)),))
        # pseudo-site is plan metadata, not a table access: mark it RO
        # so guard elision never counts it as a guarded RW site
        draft.site_mut[BATCH_SHAPE_SITE] = "ro"
        draft.count(self.name)


def plan_batch_shape(plan) -> Optional[Tuple[Tuple[int, ...], int]]:
    """Read the active plan's batch-shape choice: ``(pad buckets
    ascending, window depth K)``, or None when the plan carries no
    batch-shape site (generic plan, or no profile observed yet)."""
    spec = plan.site(BATCH_SHAPE_SITE) if plan is not None else None
    if spec is None or spec.impl != "batch_shape":
        return None
    k = dict(spec.const_fields).get("window_k", 1)
    return tuple(int(b) for b in spec.hot_keys), int(k)
