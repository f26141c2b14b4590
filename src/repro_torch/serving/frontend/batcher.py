"""Dynamic batch formation feeding the fused dispatch fast path.

Ported from ``repro.serving.frontend.batcher``.  One
:meth:`DynamicBatcher.pump` forms ONE serving window: it reads the
active plan's batch shape (``(pad buckets, fused depth K)`` selected by
:class:`~repro_torch.core.passes.batch_shape.BatchShapePass`, or the
config ladder with K=1 before any profile has been observed), fills up
to ``K x primary_bucket`` requests from the queue — waiting at most
``cfg.max_wait_s`` once the first request is in hand — packs them into
padded+masked batches (:func:`repro_torch.serving.dataplane.\
make_request_batch`), and dispatches through the fused fast path:
``place_batch(..., fused=True)``, then ONE
:meth:`~repro_torch.core.runtime.MorpheusRuntime.step_many` call for the
whole window.  Windows retire through a bounded in-flight deque
(``cfg.inflight``), so the host forms window N+1 while the device runs
window N.

Retiring a window waits for that window alone: a CUDA event recorded on
the current stream right after its ``step_many`` (on the host there is
nothing to wait for).  Fan-back copies the stacked output to the host
once per window and slices each request's rows there, then records
queue-wait / batch-wait / execute / total into the runtime's
:class:`~repro_torch.core.histogram.StreamingHistogram` series — ONE
locked stats call per retired window, same discipline as dispatch.

Bucket misprediction is detected here: each formed batch whose ideal
ladder bucket is missing from the active plan's bucket set counts as a
mispredict; past ``cfg.mispredict_deopt`` over a
``cfg.mispredict_window`` of batches, the batcher bumps the table
version — the EXISTING program-level guard deopts every specialized
executable to generic, and the next recompile cycle re-selects buckets
from the drifted profile.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Tuple

import torch

from ...core.passes.batch_shape import plan_batch_shape
from ..dataplane import make_request_batch


class DynamicBatcher:
    """Forms, dispatches and retires serving windows for one runtime.
    NOT thread-safe for concurrent ``pump`` calls — one batcher thread
    (or one synchronous test driver) per frontend."""

    def __init__(self, runtime, queue, profile, cfg, clock,
                 *, keep_outputs: bool = True):
        self.rt = runtime
        self.queue = queue
        self.profile = profile
        self.cfg = cfg
        self.clock = clock
        self.keep_outputs = keep_outputs
        self._ladder = cfg.ladder_resolved()
        # (device_out, done_event, chunks, t_dispatch, bucket, mispredicts)
        self._inflight: Deque[tuple] = deque()
        # rows taken from the queue and not yet in _inflight (or failed)
        self._holding = False
        self._mis_batches = 0
        self._mis_hits = 0

    # ---- plan consultation -------------------------------------------
    def current_shape(self) -> Tuple[Tuple[int, ...], int]:
        """The active plan's ``(pad buckets, window K)`` — the full
        config ladder at K=1 until BatchShapePass has planned one."""
        shape = plan_batch_shape(self.rt.plan)
        if shape is not None:
            return shape
        return self._ladder, 1

    def _fit(self, ladder: Tuple[int, ...], n: int) -> int:
        for b in ladder:
            if b >= n:
                return b
        return ladder[-1]

    # ---- window formation --------------------------------------------
    def pump(self, wait_s: float = 0.0) -> int:
        """Form and dispatch at most one window (blocking up to
        ``wait_s`` for the first request, then up to ``cfg.max_wait_s``
        to fill); returns the number of requests dispatched.  An empty
        pump retires all in-flight windows instead, so pumping an idle
        frontend drains it."""
        if not self.queue.wait_nonempty(wait_s):
            self._retire(0)
            return 0
        buckets, k = self.current_shape()
        primary = buckets[-1]
        target = primary * max(k, 1)
        fill_deadline = self.clock() + self.cfg.max_wait_s
        rows: List = []
        self._holding = True       # before take() empties the queue
        try:
            while True:
                ready, shed = self.queue.take(target - len(rows),
                                              self.clock())
                self._finish_shed(shed)
                rows.extend(ready)
                if len(rows) >= target:
                    break
                remaining = fill_deadline - self.clock()
                if remaining <= 0:
                    break
                if not self.queue.wait_nonempty(remaining):
                    break
            if not rows:
                self._retire(0)
                return 0
            self._dispatch(rows, buckets)
        finally:
            self._holding = False
        return len(rows)

    def _finish_shed(self, shed: List) -> None:
        if not shed:
            return
        now = self.clock()
        for r in shed:
            r.finish("shed", timing={
                "queue_wait_s": now - r.arrival_ts,
                "total_s": now - r.arrival_ts},
                reason="DEADLINE_EXPIRED")
        self.rt.stats.bump(requests_shed=len(shed))

    def _fail_window(self, chunks: List[List], exc: BaseException
                     ) -> None:
        """A dispatch raised mid-window: every request in the window
        terminates "failed" with an accounted reason — no request is
        silently lost, and the batcher thread survives to serve on."""
        now = self.clock()
        n = 0
        for chunk in chunks:
            for r in chunk:
                r.finish("failed", timing={
                    "queue_wait_s": (r._taken_ts or now) - r.arrival_ts,
                    "total_s": now - r.arrival_ts},
                    reason="PLANE_FAULT")
                n += 1
        self.rt.stats.bump(requests_failed=n)

    # ---- dispatch -----------------------------------------------------
    def _dispatch(self, rows: List, buckets: Tuple[int, ...]) -> None:
        primary = buckets[-1]
        if len(rows) <= primary:
            chunks = [rows]
            bucket = self._fit(buckets, len(rows))
        else:
            # a fused window is ONE executable: every batch in it shares
            # one shape, so an overflowing window chunks to the primary
            chunks = [rows[i:i + primary]
                      for i in range(0, len(rows), primary)]
            bucket = primary
        now = self.clock()
        mispredicts = 0
        for chunk in chunks:
            ideal = self._fit(self._ladder, len(chunk))
            mis = ideal not in buckets
            mispredicts += bool(mis)
            self.profile.record_batch(len(chunk), bucket,
                                      mispredict=mis)
            for r in chunk:
                r._taken_ts = r._taken_ts if r._taken_ts is not None \
                    else now
        self._maybe_deopt(len(chunks), mispredicts)

        raw = [make_request_batch([r.payload for r in chunk], bucket)
               for chunk in chunks]
        placed = self.rt.place_batch(raw, fused=True)
        t_disp = self.clock()
        try:
            out = self.rt.step_many(placed, k=len(chunks))
        except Exception as e:
            # the runtime aborted the window's claim; account for its
            # requests and keep serving
            self._fail_window(chunks, e)
            return
        done = None
        if out.is_cuda:
            # this window's own completion: retiring it must not wait
            # for windows dispatched after it
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(out.device))
        self._inflight.append((out, done, chunks, t_disp, bucket,
                               mispredicts))
        # bounded pipelining: keep at most cfg.inflight windows
        # un-retired so the host forms the next window while the device
        # runs this one — but never unboundedly many
        self._retire(max(self.cfg.inflight - 1, 0))

    def _maybe_deopt(self, n_batches: int, mispredicts: int) -> None:
        self._mis_batches += n_batches
        self._mis_hits += mispredicts
        if self._mis_batches < self.cfg.mispredict_window:
            return
        frac = self._mis_hits / self._mis_batches
        self._mis_batches = 0
        self._mis_hits = 0
        if (frac > self.cfg.mispredict_deopt
                and plan_batch_shape(self.rt.plan) is not None):
            # drifted arrival process: deopt through the program guard
            # (specialized executables fall back to generic) and let the
            # next recompile cycle re-select buckets from the profile
            self.rt.tables.bump_version("frontend:bucket-mispredict")
            self.rt.controller.notify_update(self.rt)

    # ---- retirement / fan-back ---------------------------------------
    @property
    def inflight(self) -> int:
        return len(self._inflight)

    @property
    def busy(self) -> bool:
        """Whether some taken request is not yet finished: a window
        being filled or dispatched, or one not yet retired (a window
        leaves ``_inflight`` only after its requests are finished)."""
        return self._holding or bool(self._inflight)

    def retire_all(self) -> None:
        self._retire(0)

    def _retire(self, limit: int) -> None:
        while len(self._inflight) > limit:
            out, done, chunks, t_disp, bucket, mispredicts = \
                self._inflight[0]
            try:
                if done is not None:
                    done.synchronize()
                # one device-to-host copy per window; requests slice the
                # host copy
                host = out.cpu() if self.keep_outputs else None
                t_done = self.clock()
                series = {"request_queue_wait_s": [],
                          "request_batch_wait_s": [],
                          "request_execute_s": [],
                          "request_total_s": []}
                completed = met = missed = pad = 0
                for j, chunk in enumerate(chunks):
                    pad += bucket - len(chunk)
                    for i, r in enumerate(chunk):
                        output = host[j, i] if self.keep_outputs else None
                        taken = r._taken_ts if r._taken_ts is not None \
                            else t_disp
                        timing = {
                            "queue_wait_s": taken - r.arrival_ts,
                            "batch_wait_s": t_disp - taken,
                            "execute_s": t_done - t_disp,
                            "total_s": t_done - r.arrival_ts,
                        }
                        slo = None
                        if r.deadline is not None:
                            slo = t_done <= r.deadline
                            met += bool(slo)
                            missed += not slo
                        completed += 1
                        series["request_queue_wait_s"].append(
                            timing["queue_wait_s"])
                        series["request_batch_wait_s"].append(
                            timing["batch_wait_s"])
                        series["request_execute_s"].append(
                            timing["execute_s"])
                        series["request_total_s"].append(timing["total_s"])
                        r.finish("ok", output=output, timing=timing,
                                 slo_met=slo)
                # ONE locked stats call per retired window: all four
                # histogram series + every counter delta together
                self.rt.stats.observe_many(
                    series, requests_completed=completed, slo_met=met,
                    slo_missed=missed, batches_formed=len(chunks),
                    pad_rows=pad, shape_mispredicts=mispredicts)
            finally:
                # only now: drain waits for the requests to be finished
                self._inflight.popleft()
