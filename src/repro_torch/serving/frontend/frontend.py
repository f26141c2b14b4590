"""Request queue + admission control + the frontend facade.

Ported from ``repro.serving.frontend.frontend``.

The request path, end to end::

    submit() -> RequestQueue (bounded; reject when full)
            -> DynamicBatcher (shed expired; pad to a plan bucket;
               place_batch prefetch; step_many fused window)
            -> fan-back (per-request outputs, SLO accounting)

A :class:`Request` is the unit of traffic: an opaque payload (a dict of
per-request arrays, one table-key row — see
:func:`repro_torch.serving.dataplane.make_request_rows`), an arrival
timestamp, and an optional absolute deadline.  Admission control is the
bounded queue: a full queue REJECTS at submit (the caller sees it
immediately — load shedding at the door), while a request whose
deadline expires before the batcher reaches it is SHED at take time
(it would burn a batch slot to produce a provably late answer).

:class:`ServingFrontend` wires one queue + batcher + arrival profile to
one :class:`~repro_torch.core.runtime.MorpheusRuntime`, attaches the profile
to the runtime (so recompile cycles see the arrival process), and
optionally runs the batcher on a background thread (:meth:`start`) —
or synchronously via :meth:`pump` for deterministic tests.  All clocks
are injectable (``clock=``) for virtual-time testing.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from .batcher import DynamicBatcher
from .profile import ArrivalProfile


def default_ladder(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to ``max_batch`` (inclusive, appended when not
    itself a power of two) — the bucket ladder the batcher may pad to
    before :class:`~repro_torch.core.passes.batch_shape.BatchShapePass` has
    observed enough traffic to narrow it."""
    out: List[int] = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return tuple(out)


@dataclass(frozen=True)
class FrontendConfig:
    """Static knobs of one serving frontend."""
    capacity: int = 256           # queue bound (admission control)
    max_batch: int = 16           # largest pad bucket
    ladder: Optional[Tuple[int, ...]] = None   # None => powers of two
    max_wait_s: float = 2e-3      # batch-formation wait budget
    window_k_max: int = 4         # deepest fused step_many window
    inflight: int = 2             # un-retired windows (pipelining bound)
    default_slo_s: Optional[float] = None      # deadline when submit()
                                               # passes none
    shed_expired: bool = True     # drop deadline-expired queued requests
    # bucket-mispredict deopt: after every `mispredict_window` formed
    # batches, if more than `mispredict_deopt` of them would have fit a
    # ladder bucket the active plan does not offer, bump the table
    # version — the program guard deopts every specialized executable
    # and the next recompile re-selects buckets from the fresh profile
    mispredict_window: int = 64
    mispredict_deopt: float = 0.5

    def ladder_resolved(self) -> Tuple[int, ...]:
        if self.ladder is not None:
            return tuple(sorted(int(b) for b in self.ladder))
        return default_ladder(self.max_batch)


@dataclass
class Request:
    """One in-flight request.  ``payload`` is the per-request row dict
    the data plane consumes; ``deadline`` is absolute (same clock as the
    frontend's).  Terminal state lands in ``status`` ("ok", "rejected",
    "shed", "failed"), ``output`` (the per-request slice of the batch
    output), ``timing`` (queue_wait_s / batch_wait_s / execute_s /
    total_s), ``slo_met`` (None for deadline-less requests) and
    ``reason`` (the machine-readable *why* of a non-"ok" terminal state
    — ``QUEUE_FULL``, ``PLANE_DEGRADED``, ``DEADLINE_EXPIRED``,
    ``PLANE_FAULT``); :meth:`wait` blocks until then."""
    id: int
    payload: Any
    arrival_ts: float
    deadline: Optional[float] = None
    status: str = "pending"
    output: Any = None
    timing: Dict[str, float] = field(default_factory=dict)
    slo_met: Optional[bool] = None
    reason: Optional[str] = None
    _done: threading.Event = field(default_factory=threading.Event,
                                   repr=False)
    _taken_ts: Optional[float] = field(default=None, repr=False)

    def finish(self, status: str, output: Any = None,
               timing: Optional[Dict[str, float]] = None,
               slo_met: Optional[bool] = None,
               reason: Optional[str] = None) -> None:
        self.status = status
        self.output = output
        if timing:
            self.timing = timing
        self.slo_met = slo_met
        if reason is not None:
            self.reason = reason
        self._done.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request reaches a terminal state."""
        return self._done.wait(timeout)


class RequestQueue:
    """Bounded FIFO with admission control and deadline shedding.

    ``submit`` is non-blocking: False when the queue is at capacity (or
    closed) — the frontend turns that into a REJECTED request.  ``take``
    pops up to ``max_n`` requests in strict FIFO order, splitting off
    the ones whose deadline already passed (``shed``) so the batcher
    never spends a batch slot on a provably late answer."""

    def __init__(self, capacity: int, shed_expired: bool = True):
        self.capacity = int(capacity)
        self.shed_expired = bool(shed_expired)
        self._dq: Deque[Request] = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    def submit(self, req: Request) -> bool:
        with self._cond:
            if self._closed or len(self._dq) >= self.capacity:
                return False
            self._dq.append(req)
            self._cond.notify()
            return True

    def take(self, max_n: int, now: float
             ) -> Tuple[List[Request], List[Request]]:
        """Pop up to ``max_n`` live requests; returns ``(ready, shed)``.
        Shed requests do not count toward ``max_n`` — they were never
        going to occupy a batch slot."""
        ready: List[Request] = []
        shed: List[Request] = []
        with self._lock:
            while self._dq and len(ready) < max_n:
                req = self._dq[0]
                if (self.shed_expired and req.deadline is not None
                        and now >= req.deadline):
                    shed.append(self._dq.popleft())
                    continue
                ready.append(self._dq.popleft())
        return ready, shed

    def wait_nonempty(self, timeout: Optional[float]) -> bool:
        """Block until the queue holds at least one request (True) or
        the timeout expires / the queue closes while empty (False)."""
        with self._cond:
            if self._dq:
                return True
            if self._closed or (timeout is not None and timeout <= 0):
                return False
            self._cond.wait(timeout)
            return bool(self._dq)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


class ServingFrontend:
    """One request frontend bound to one runtime (one data plane).

    ``clock`` must be monotonic; inject a virtual clock for
    deterministic tests.  ``keep_outputs=False`` drops per-request
    output slices after completion (load benchmarks that only measure
    latency skip the host-side slicing cost)."""

    def __init__(self, runtime, cfg: Optional[FrontendConfig] = None,
                 *, clock: Callable[[], float] = time.monotonic,
                 keep_outputs: bool = True):
        self.rt = runtime
        self.cfg = cfg or FrontendConfig()
        self.clock = clock
        self.queue = RequestQueue(self.cfg.capacity,
                                  self.cfg.shed_expired)
        self.profile = ArrivalProfile(self.cfg.ladder_resolved(),
                                      self.cfg.max_wait_s,
                                      self.cfg.window_k_max)
        # recompile cycles now see the arrival process (BatchShapePass)
        runtime.attach_profile(self.profile)
        self.batcher = DynamicBatcher(runtime, self.queue, self.profile,
                                      self.cfg, clock,
                                      keep_outputs=keep_outputs)
        self._ids = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # the plane's health state machine, resolved lazily: stub
        # runtimes (tests) and explicit exec_cache-only setups have no
        # controller-registered health — the gate then admits everything
        self._plane_health: Any = None

    # ---- fleet health ------------------------------------------------
    def _health(self):
        if self._plane_health is None:
            try:
                self._plane_health = self.rt.controller.health_for(
                    self.rt.plane_id)
            except Exception:
                self._plane_health = False      # resolved: none
        return self._plane_health or None

    @property
    def plane_healthy(self) -> bool:
        """True when this frontend's plane currently admits new
        requests — the fleet driver's reroute predicate.  A RECOVERING
        plane reads healthy (it admits, token-bucket ramped)."""
        h = self._health()
        return h is None or h.state not in ("degraded", "quarantined")

    # ---- the submit path ---------------------------------------------
    def submit(self, payload, deadline: Optional[float] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Admit one request.  ``deadline`` is absolute (frontend
        clock); ``deadline_s`` is relative to now; with neither,
        ``cfg.default_slo_s`` applies (or no deadline at all).  Always
        returns the Request — check ``status`` for an immediate
        rejection (``reason``: ``PLANE_DEGRADED`` while the plane is
        faulted/ramping, ``QUEUE_FULL`` at capacity)."""
        now = self.clock()
        if deadline is None:
            rel = (deadline_s if deadline_s is not None
                   else self.cfg.default_slo_s)
            deadline = now + rel if rel is not None else None
        req = Request(next(self._ids), payload, now, deadline)
        self.profile.record_arrival(now)
        health = self._health()
        if health is not None and not health.admit():
            # shed at the door: a degraded plane serves only what is
            # already in flight; a recovering one re-admits through the
            # token-bucket ramp — either way the caller learns *why*
            req.finish("rejected", reason="PLANE_DEGRADED")
            self.rt.stats.bump(requests_submitted=1,
                               requests_rejected=1,
                               requests_rejected_degraded=1)
        elif self.queue.submit(req):
            self.rt.stats.bump(requests_submitted=1)
        else:
            req.finish("rejected", reason="QUEUE_FULL")
            self.rt.stats.bump(requests_submitted=1,
                               requests_rejected=1)
        return req

    # ---- synchronous serving (tests, drains) -------------------------
    def pump(self, wait_s: float = 0.0) -> int:
        """Form and dispatch at most one window; returns the number of
        requests dispatched.  When nothing is pending, retires any
        in-flight windows instead (so repeated ``pump()`` calls drain
        the frontend completely)."""
        return self.batcher.pump(wait_s)

    def drain(self, timeout: float = 60.0) -> bool:
        """Serve until the queue is empty and every taken request is
        finished (no window in formation, dispatch or flight).  With a
        background thread running this only polls; otherwise it pumps
        inline."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._thread is None:
                self.pump(0.0)
            if len(self.queue) == 0 and not self.batcher.busy:
                return True
            if self._thread is not None:
                time.sleep(1e-3)
        return False

    # ---- background serving ------------------------------------------
    def start(self) -> "ServingFrontend":
        """Run the batcher on a background thread until :meth:`stop`."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self.pump(wait_s=0.01)

        self._thread = threading.Thread(target=loop,
                                        name="morpheus-frontend",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the background thread (after a full drain by default)
        and close the queue — later submits are rejected."""
        if drain:
            self.drain(timeout)
        self._stop.set()
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        # nothing may hang forever: retire in-flight windows, and shed
        # whatever was still queued (drain=False teardown)
        self.batcher.retire_all()
        ready, shed = self.queue.take(self.cfg.capacity, self.clock())
        leftovers = ready + shed
        for r in leftovers:
            r.finish("shed", reason="FRONTEND_STOPPED")
        if leftovers:
            self.rt.stats.bump(requests_shed=len(leftovers))
