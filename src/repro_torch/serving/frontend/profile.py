"""Arrival-profile snapshot — the request-level analogue of the sketch.

Ported from ``repro.serving.frontend.profile`` (host-only; copied so
the port imports nothing of the reference).

Morpheus instruments *key* distributions per lookup site; the serving
frontend instruments the *arrival process*: how fast requests arrive,
how big the ragged groups the batcher forms are, and how much of each
dispatched pad bucket is real work.  :meth:`ArrivalProfile.snapshot`
reduces all of it to a plain dict that
:meth:`~repro_torch.core.runtime.MorpheusRuntime.attach_profile` merges into
the controller's traffic snapshot at every recompile cycle — the input
of :class:`~repro_torch.core.passes.batch_shape.BatchShapePass`.

Thread-safe: arrivals are recorded on submitter threads, batches on the
batcher thread, snapshots on the controller's recompile workers.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple


class ArrivalProfile:
    """Rolling profile of the arrival process feeding one frontend.

    ``size_hist[i]`` counts formed request groups of ragged size
    ``i + 1`` (before padding) — group sizes, not raw arrivals, because
    the pad bucket must fit what the *batcher* forms under its wait
    budget, which already folds the arrival process and the previous
    bucket choice together.  The arrival rate is measured over a sliding
    window of the last ``rate_window`` arrival timestamps."""

    def __init__(self, ladder: Tuple[int, ...], max_wait_s: float,
                 window_k_max: int, rate_window: int = 512):
        self.ladder = tuple(sorted(int(b) for b in ladder))
        self.max_wait_s = float(max_wait_s)
        self.window_k_max = int(window_k_max)
        self._lock = threading.Lock()
        self._arrivals: Deque[float] = deque(maxlen=int(rate_window))
        self._n_arrivals = 0
        max_size = self.ladder[-1] * max(self.window_k_max, 1)
        self._size_hist = [0] * max_size
        self._bucket_hist: Dict[int, int] = {}
        self._batches = 0
        self._real_rows = 0
        self._pad_rows = 0
        self._mispredicts = 0

    # ---- recording ----------------------------------------------------
    def record_arrival(self, ts: Optional[float] = None) -> None:
        if ts is None:
            ts = time.monotonic()
        with self._lock:
            self._arrivals.append(float(ts))
            self._n_arrivals += 1

    def record_batch(self, n_real: int, bucket: int,
                     mispredict: bool = False) -> None:
        """One formed batch: ``n_real`` ragged rows padded to
        ``bucket``.  ``mispredict`` marks a batch whose ideal ladder
        bucket was not among the active plan's buckets."""
        with self._lock:
            idx = min(max(int(n_real), 1), len(self._size_hist)) - 1
            self._size_hist[idx] += 1
            self._bucket_hist[int(bucket)] = \
                self._bucket_hist.get(int(bucket), 0) + 1
            self._batches += 1
            self._real_rows += int(n_real)
            self._pad_rows += int(bucket) - int(n_real)
            if mispredict:
                self._mispredicts += 1

    # ---- readout ------------------------------------------------------
    def arrival_rate_hz(self) -> float:
        """Arrivals/sec over the sliding timestamp window (0.0 until two
        arrivals have landed)."""
        with self._lock:
            return self._rate_locked()

    def _rate_locked(self) -> float:
        if len(self._arrivals) < 2:
            return 0.0
        span = self._arrivals[-1] - self._arrivals[0]
        if span <= 0.0:
            return 0.0
        return (len(self._arrivals) - 1) / span

    def snapshot(self) -> Dict:
        """Plain-dict profile for ``PlanInputs.profile`` — everything
        :class:`BatchShapePass` consults, plus occupancy diagnostics."""
        with self._lock:
            rows = self._real_rows + self._pad_rows
            return {
                "ladder": self.ladder,
                "max_wait_s": self.max_wait_s,
                "window_k_max": self.window_k_max,
                "arrival_rate_hz": self._rate_locked(),
                "arrivals": self._n_arrivals,
                "size_hist": tuple(self._size_hist),
                "bucket_hist": dict(self._bucket_hist),
                "batches": self._batches,
                "occupancy": (self._real_rows / rows) if rows else 1.0,
                "mispredicts": self._mispredicts,
            }
