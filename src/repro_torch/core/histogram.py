"""Streaming histogram — the one quantile implementation in the repo.

Both step latency (the serve loops) and per-request latency (the
serving frontend's SLO accounting) need p50/p99 over an unbounded
stream.  A reservoir would do, but a fixed geometric-bucket histogram
is strictly better here: O(1) observe, O(buckets) quantile, *mergeable*
across planes (fleet-level SLO attainment is a bucket-wise sum, not a
re-sample), and bounded error known up front — the relative error of
any quantile is at most the bucket ratio (~5.1% with the default 512
buckets over 11 decades).

Values are assumed positive (latencies, sizes).  Non-positive values
clamp into the underflow bucket.  The class is NOT internally locked:
:class:`~repro_torch.core.runtime.RuntimeStats` wraps every ``observe`` in
its own lock, same as the scalar counters.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

__all__ = ["StreamingHistogram"]


class StreamingHistogram:
    """Fixed geometric buckets over ``[lo, hi)`` plus under/overflow.

    Bucket 0 holds everything ``<= lo``; bucket ``n-1`` everything
    ``>= hi``; the interior buckets are geometric.  Quantiles
    interpolate geometrically inside the hit bucket and clamp to the
    exact observed ``[min, max]``, so small-count histograms (a test
    observing three values) stay sane.
    """

    __slots__ = ("lo", "hi", "n", "_log_lo", "_log_ratio", "counts",
                 "count", "total", "vmin", "vmax")

    def __init__(self, lo: float = 1e-7, hi: float = 1e4,
                 buckets: int = 512):
        if not (0 < lo < hi) or buckets < 3:
            raise ValueError("need 0 < lo < hi and >= 3 buckets")
        self.lo = float(lo)
        self.hi = float(hi)
        self.n = int(buckets)
        self._log_lo = math.log(self.lo)
        self._log_ratio = (math.log(self.hi) - self._log_lo) / (self.n - 2)
        self.counts = np.zeros(self.n, np.int64)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # ---- recording ----------------------------------------------------
    def _index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        if v >= self.hi:
            return self.n - 1
        return 1 + int((math.log(v) - self._log_lo) / self._log_ratio)

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        self.counts[self._index(v)] += 1

    def observe_all(self, values: Iterable[float]) -> None:
        for v in values:
            self.observe(v)

    def merge(self, other: "StreamingHistogram") -> None:
        """Bucket-wise sum (fleet aggregation).  Parameters must match."""
        if (other.lo, other.hi, other.n) != (self.lo, self.hi, self.n):
            raise ValueError("cannot merge histograms with different "
                             "bucket layouts")
        self.counts += other.counts
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    # ---- readout ------------------------------------------------------
    def _edge(self, i: int) -> float:
        """Lower edge of interior bucket ``i`` (1 <= i <= n-1)."""
        return math.exp(self._log_lo + (i - 1) * self._log_ratio)

    def quantile(self, q: float) -> float:
        """The q-quantile (0 <= q <= 1) of everything observed so far,
        geometrically interpolated within the hit bucket and clamped to
        the observed [min, max].  NaN on an empty histogram."""
        if self.count == 0:
            return math.nan
        q = min(max(float(q), 0.0), 1.0)
        # rank in [1, count]; cumulative walk finds the bucket
        rank = max(1, int(math.ceil(q * self.count)))
        cum = 0
        for i in range(self.n):
            c = int(self.counts[i])
            if c == 0:
                continue
            if cum + c >= rank:
                if i == 0:
                    val = self.lo
                elif i == self.n - 1:
                    val = self.hi
                else:
                    frac = (rank - cum - 0.5) / c
                    lo_e, hi_e = self._edge(i), self._edge(i + 1)
                    val = lo_e * (hi_e / lo_e) ** frac
                return min(max(val, self.vmin), self.vmax)
            cum += c
        return self.vmax          # unreachable, defensively

    def quantiles(self, qs: Sequence[float]) -> List[float]:
        return [self.quantile(q) for q in qs]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def summary(self) -> Dict[str, float]:
        """Plain-dict digest (what ``RuntimeStats.snapshot`` embeds)."""
        if self.count == 0:
            return {"count": 0}
        return {"count": self.count, "mean": self.mean,
                "min": self.vmin, "max": self.vmax,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}

    def copy(self) -> "StreamingHistogram":
        h = StreamingHistogram(self.lo, self.hi, self.n)
        h.counts = self.counts.copy()
        h.count = self.count
        h.total = self.total
        h.vmin = self.vmin
        h.vmax = self.vmax
        return h

    def __repr__(self) -> str:
        if self.count == 0:
            return "StreamingHistogram(empty)"
        return (f"StreamingHistogram(count={self.count}, "
                f"mean={self.mean:.3g}, p50={self.quantile(.5):.3g}, "
                f"p99={self.quantile(.99):.3g})")
