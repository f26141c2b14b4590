"""Recompile scheduler — one bounded worker pool for N data planes.

Before the controller split every :class:`MorpheusRuntime` spawned its
own ad-hoc daemon thread per ``recompile(block=False)`` call: N planes
under churn meant N unbounded compile threads fighting over cores while
the data planes tried to serve.  :class:`RecompileScheduler` replaces
that with one pool shared by every plane the controller drives:

  * **bounded** — at most ``workers`` cycles run at once, lazily spawned
    (a controller that only ever sees blocking recompiles starts no
    threads);
  * **prioritized** — when more planes are pending than workers, the
    pool picks the plane with the largest ``staleness x traffic``
    product (see ``MorpheusRuntime.recompile_priority``): a plane whose
    tables drifted three versions while serving heavy traffic recompiles
    before an idle one that drifted once;
  * **coalesced** — submitting a plane already pending is a no-op (one
    entry per plane), and a plane whose cycle is *running* stays
    eligible to be re-queued so updates arriving mid-cycle get a fresh
    cycle afterwards — but the pool never runs two cycles for the same
    plane concurrently (the per-plane mutex in the runtime backstops
    this for blocking callers too);
  * **weakly referencing** — pending entries hold weakrefs, so a plane
    dropped by its owner is skipped, never resurrected.

  * **retrying** — a failed cycle is not silently dropped: with
    ``max_retries > 0`` the plane is re-queued under exponential
    backoff (``backoff_base_s * 2**(streak-1)``, capped at
    ``backoff_cap_s``) and retried up to ``max_retries`` times; a
    plane whose cycle keeps failing is *given up* — the ``on_give_up``
    callback fires (the controller quarantines the plan signature) and
    the per-plane ``last_errors`` entry stays visible in
    :meth:`stats` until a later cycle succeeds.

The scheduler is duck-typed over planes: anything with
``_recompile_now()`` and ``recompile_priority()`` schedules (tests use
stubs).
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple


class RecompileScheduler:
    """Bounded, priority-ordered worker pool for recompile cycles.

    ``max_retries=0`` (the bare default) preserves fire-and-forget
    semantics: a failed cycle counts and gives up immediately.  The
    controller constructs its pool with the fleet's
    :class:`~repro_torch.core.controller.health.HealthConfig` backoff knobs,
    so controller-driven cycles retry."""

    def __init__(self, workers: int = 2,
                 name: str = "morpheus-recompile", *,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0,
                 max_retries: int = 0,
                 on_give_up: Optional[Callable[[str, BaseException],
                                               None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        assert workers >= 1
        self.workers = workers
        self._name = name
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.max_retries = int(max_retries)
        self.on_give_up = on_give_up
        self.clock = clock
        self._cond = threading.Condition()
        self._pending: Dict[str, "weakref.ref"] = {}
        self._running: set = set()
        self._threads: List[threading.Thread] = []
        self._stopped = False
        # per-plane failure bookkeeping (under _cond)
        self._streak: Dict[str, int] = {}        # consecutive failures
        self._not_before: Dict[str, float] = {}  # backoff deadlines
        self.last_errors: Dict[str, str] = {}    # plane id -> last error
        # counters (under _cond)
        self.scheduled = 0
        self.coalesced = 0
        self.completed = 0
        self.failed = 0
        self.retries = 0
        self.gave_up = 0
        self.last_error: Optional[BaseException] = None

    # ---- producer side ----------------------------------------------------
    def submit(self, plane_id: str, plane: Any) -> bool:
        """Queue one recompile cycle for ``plane``.  Returns True when a
        new entry was queued, False when an identical request was already
        pending (coalesced).  Worker threads spawn lazily, capped at
        ``workers``."""
        with self._cond:
            if self._stopped:
                raise RuntimeError("recompile scheduler closed")
            if plane_id in self._pending:
                self._pending[plane_id] = weakref.ref(plane)
                self.coalesced += 1
                return False
            self._pending[plane_id] = weakref.ref(plane)
            self.scheduled += 1
            if len(self._threads) < self.workers:
                t = threading.Thread(
                    target=self._run, daemon=True,
                    name=f"{self._name}-{len(self._threads)}")
                self._threads.append(t)
                t.start()
            self._cond.notify()
            return True

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until no cycle is pending or running (or timeout)."""
        with self._cond:
            return self._cond.wait_for(
                lambda: self._stopped or (not self._pending
                                          and not self._running),
                timeout=timeout)

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {"scheduled": self.scheduled,
                    "coalesced": self.coalesced,
                    "completed": self.completed,
                    "failed": self.failed,
                    "retries": self.retries,
                    "gave_up": self.gave_up,
                    "pending": len(self._pending),
                    "running": len(self._running),
                    "workers": len(self._threads),
                    "last_errors": dict(self.last_errors)}

    # ---- worker side ------------------------------------------------------
    def _pick(self) -> Optional[Tuple[str, Any]]:
        """Highest-priority pending plane not currently running and not
        inside a backoff window; drops dead weakrefs.  Called under
        ``_cond``."""
        best: Optional[Tuple[str, Any]] = None
        best_prio = None
        now = self.clock()
        for pid in list(self._pending):
            if pid in self._running:
                continue              # never two cycles for one plane
            if self._not_before.get(pid, 0.0) > now:
                continue              # backing off a failed cycle
            plane = self._pending[pid]()
            if plane is None:
                del self._pending[pid]     # owner dropped the runtime
                self._not_before.pop(pid, None)
                self._streak.pop(pid, None)
                continue
            try:
                prio = plane.recompile_priority()
            except Exception:
                prio = 0.0
            if best_prio is None or prio > best_prio:
                best, best_prio = (pid, plane), prio
        return best

    def _wait_timeout(self) -> Optional[float]:
        """How long a worker may sleep before the soonest backoff
        deadline among pending planes expires (None = indefinitely).
        Called under ``_cond``."""
        deadlines = [t for pid, t in self._not_before.items()
                     if pid in self._pending and pid not in self._running]
        if not deadlines:
            return None
        return max(min(deadlines) - self.clock(), 1e-3)

    def _on_failure(self, pid: str, plane: Any,
                    e: BaseException) -> Optional[BaseException]:
        """Failure bookkeeping for one cycle: bounded exponential-
        backoff retry, then give up.  Returns the exception when the
        plane was given up (the caller fires ``on_give_up`` OUTSIDE the
        lock)."""
        give_up: Optional[BaseException] = None
        with self._cond:
            self.failed += 1
            self.last_error = e
            self.last_errors[pid] = repr(e)
            streak = self._streak.get(pid, 0) + 1
            self._streak[pid] = streak
            if streak > self.max_retries:
                # exhausted: drop the backoff state but KEEP last_errors
                # (ControllerStats surfaces it) — the controller's
                # give-up hook quarantines the plan signature
                self.gave_up += 1
                self._streak.pop(pid, None)
                self._not_before.pop(pid, None)
                give_up = e
            elif not self._stopped:
                # re-queue under exponential backoff; an explicit
                # re-submit meanwhile coalesces into this entry
                delay = min(self.backoff_base_s * (2.0 ** (streak - 1)),
                            self.backoff_cap_s)
                self._not_before[pid] = self.clock() + delay
                if pid not in self._pending:
                    self._pending[pid] = weakref.ref(plane)
                self.retries += 1
        return give_up

    def _run(self) -> None:
        while True:
            with self._cond:
                item = self._pick()
                while not self._stopped and item is None:
                    self._cond.wait(self._wait_timeout())
                    item = self._pick()
                if self._stopped:
                    return
                pid, plane = item
                del self._pending[pid]
                self._running.add(pid)
            give_up: Optional[BaseException] = None
            try:
                plane._recompile_now()
                with self._cond:
                    self.completed += 1
                    self._streak.pop(pid, None)
                    self._not_before.pop(pid, None)
                    self.last_errors.pop(pid, None)
            except BaseException as e:      # a dead plane must not kill
                give_up = self._on_failure(pid, plane, e)   # the pool
            finally:
                if give_up is not None and self.on_give_up is not None:
                    try:
                        self.on_give_up(pid, give_up)
                    except Exception:
                        pass                # a bad hook must not kill
                plane = None                # drop the strong ref
                with self._cond:
                    self._running.discard(pid)
                    # the same plane may have been re-queued mid-cycle
                    self._cond.notify_all()

    def close(self) -> None:
        """Stop the pool.  Pending cycles are dropped; the running ones
        finish (their planes' recompile mutexes stay consistent).
        Idempotent."""
        with self._cond:
            if self._stopped:
                return
            self._stopped = True
            self._pending.clear()
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=30.0)
