"""Per-plane health: the fleet's fault-recovery state machine.

Morpheus' safety contract — guarded specialized code that can always
deopt to the generic executable — is exactly what a serving fleet needs
to *survive faults*, not just mispredictions.  This module is the
control-plane half of that story: one :class:`PlaneHealth` per
registered data plane, owned by
:class:`~repro_torch.core.controller.MorpheusController`, tracking

::

    HEALTHY ──fault──▶ DEGRADED ──probe──▶ RECOVERING ──swap──▶ HEALTHY
       ▲                  ▲                                        │
       │                  └──control update─── QUARANTINED ◀──give-up

  * **HEALTHY** — specialized dispatch active, full admission.
  * **DEGRADED** — a dispatch-layer fault (injected device loss, OOM,
    simulated compile error, straggler mitigation) swapped the plane to
    generic-only dispatch (:meth:`MorpheusRuntime.degrade_to_generic`).
    The frontend sheds new admissions with an explicit
    ``PLANE_DEGRADED`` rejection; the plane keeps serving whatever the
    caller still pushes at it, through the generic executable.
  * **RECOVERING** — the health probe passed (``min_downtime_s``
    elapsed AND ``probe_steps`` steps served since the fault), so the
    controller scheduled a re-specialization cycle; admission ramps
    back gradually through a :class:`TokenBucket` so the returning
    plane is not immediately re-faulted under full load.
  * **QUARANTINED** — the recompile scheduler exhausted its bounded
    retries for this plane: the poisoned plan *signature* is
    quarantined in the shared :class:`~repro_torch.core.execcache.\
ExecutableCache` (never re-attempted — the plane falls through to
    generic forever) until a control update moves the specialization
    basis, which drops the plane back to DEGRADED for a fresh attempt.

Every transition is driven by the layers that observe the evidence:
the runtime's dispatch fault boundary reports faults
(``controller.on_plane_fault``), successful re-specialization swaps
report recovery (``controller.on_plane_recovered``), the scheduler's
give-up callback quarantines, and ``controller.schedule`` runs the
probe as its admission gate.  The machine itself is passive and
thread-safe; clocks are injectable for virtual-time tests.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

HEALTHY = "healthy"
DEGRADED = "degraded"
RECOVERING = "recovering"
QUARANTINED = "quarantined"

HEALTH_STATES = (HEALTHY, DEGRADED, RECOVERING, QUARANTINED)


@dataclass
class HealthConfig:
    """Knobs of one fleet's health machinery (shared by every plane).

    ``probe_steps``/``min_downtime_s`` define the recovery probe: a
    degraded plane must have served that many steps (in any dispatch
    mode — degraded planes serve generic) since its fault AND have been
    down that long before the controller schedules re-specialization.
    ``ramp_*`` shape the token-bucket re-admission ramp; ``backoff_*``
    and ``max_retries`` parameterize the recompile scheduler's bounded
    exponential-backoff retry (exhaustion quarantines the plan
    signature).  ``clock`` must be monotonic; inject a virtual clock
    for deterministic tests."""
    probe_steps: int = 2
    min_downtime_s: float = 0.0
    ramp_rate: float = 200.0       # tokens/s while re-admitting
    ramp_burst: float = 16.0
    ramp_s: float = 0.5            # ramp window after full recovery
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    max_retries: int = 3
    clock: Callable[[], float] = time.monotonic


class TokenBucket:
    """A plain thread-safe token bucket (injectable clock).  Used for
    the post-recovery admission ramp: ``try_take`` admits while tokens
    last and refills at ``rate`` per second up to ``burst``."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic,
                 initial: float = 1.0):
        assert rate > 0 and burst >= 1
        self.rate = float(rate)
        self.burst = float(burst)
        self.clock = clock
        self._tokens = min(float(initial), self.burst)
        self._last = clock()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self.clock()
            self._tokens = min(self.burst,
                               self._tokens
                               + max(now - self._last, 0.0) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


class PlaneHealth:
    """The per-plane health state machine (see module docstring).

    Thread-safe: the dispatch fault boundary, the scheduler's worker
    threads, the frontend's submit path and the controller's probe all
    call in concurrently."""

    def __init__(self, cfg: Optional[HealthConfig] = None,
                 plane_id: str = ""):
        self.cfg = cfg or HealthConfig()
        self.plane_id = plane_id
        self._lock = threading.Lock()
        self._state = HEALTHY
        self._since = self.cfg.clock()
        self._last_fault: Optional[str] = None
        self._steps_at_fault: Optional[int] = None
        self._bucket: Optional[TokenBucket] = None
        self._ramp_until: Optional[float] = None
        self.faults = 0
        self.recoveries = 0
        self.quarantines = 0

    # ---- transitions ------------------------------------------------------
    def _to(self, state: str) -> None:        # under _lock
        self._state = state
        self._since = self.cfg.clock()

    def on_fault(self, reason: str, steps: Optional[int] = None) -> None:
        """A dispatch-layer fault degraded the plane to generic-only
        dispatch.  ``steps`` is the runtime's step counter at the fault
        — the probe's baseline.  QUARANTINED planes stay quarantined
        (their signature is poisoned regardless of new faults)."""
        with self._lock:
            self.faults += 1
            self._last_fault = str(reason)
            self._steps_at_fault = steps
            self._bucket = None
            self._ramp_until = None
            if self._state != QUARANTINED:
                self._to(DEGRADED)

    def gate_schedule(self, steps_now: Optional[int] = None) -> bool:
        """The controller's scheduling gate: True when a recompile may
        be queued for this plane now.  A DEGRADED plane passes only
        when the health probe does — and passing transitions it to
        RECOVERING and arms the re-admission token bucket."""
        with self._lock:
            if self._state in (HEALTHY, RECOVERING):
                return True
            if self._state == QUARANTINED:
                return False
            # DEGRADED: the probe
            if (self.cfg.clock() - self._since
                    < self.cfg.min_downtime_s):
                return False
            if (self.cfg.probe_steps and steps_now is not None
                    and self._steps_at_fault is not None
                    and (steps_now - self._steps_at_fault
                         < self.cfg.probe_steps)):
                return False
            self._to(RECOVERING)
            self._bucket = TokenBucket(self.cfg.ramp_rate,
                                       self.cfg.ramp_burst,
                                       clock=self.cfg.clock)
            return True

    def on_recovered(self) -> None:
        """A re-specialization cycle swapped specialized code back in
        while the plane was degraded: back to HEALTHY, with the
        admission ramp kept up for ``ramp_s`` more seconds."""
        with self._lock:
            if self._state == QUARANTINED:
                return
            self.recoveries += 1
            if self._bucket is None:        # blocking recompile that
                self._bucket = TokenBucket(  # bypassed the probe gate
                    self.cfg.ramp_rate, self.cfg.ramp_burst,
                    clock=self.cfg.clock)
            self._ramp_until = self.cfg.clock() + self.cfg.ramp_s
            self._to(HEALTHY)

    def quarantine(self, reason: str) -> None:
        """The scheduler gave up on this plane's cycle after bounded
        retries: its plan signature is poisoned (the controller also
        quarantines it in the ExecutableCache) — generic-only until a
        control update moves the specialization basis."""
        with self._lock:
            self.quarantines += 1
            self._last_fault = str(reason)
            self._bucket = None
            self._ramp_until = None
            self._to(QUARANTINED)

    def on_update(self) -> None:
        """A control-plane write landed: a QUARANTINED plane gets a new
        specialization basis (new tables => possibly a new, unpoisoned
        signature) and drops back to DEGRADED for a fresh probe."""
        with self._lock:
            if self._state == QUARANTINED:
                self._to(DEGRADED)

    # ---- admission --------------------------------------------------------
    def admit(self) -> bool:
        """May the frontend admit one NEW request on this plane?  False
        while degraded/quarantined (the frontend rejects with
        ``PLANE_DEGRADED``); token-bucket ramped while recovering and
        for ``ramp_s`` after; unconditionally True when healthy."""
        with self._lock:
            if self._state in (DEGRADED, QUARANTINED):
                return False
            if self._state == RECOVERING:
                return (self._bucket.try_take()
                        if self._bucket is not None else False)
            # HEALTHY — possibly still inside the post-recovery ramp
            if self._ramp_until is not None:
                if self.cfg.clock() >= self._ramp_until:
                    self._ramp_until = None
                    self._bucket = None
                    return True
                return (self._bucket.try_take()
                        if self._bucket is not None else True)
            return True

    # ---- introspection ----------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def last_fault(self) -> Optional[str]:
        with self._lock:
            return self._last_fault

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self._state,
                    "since": self._since,
                    "faults": self.faults,
                    "recoveries": self.recoveries,
                    "quarantines": self.quarantines,
                    "last_fault": self._last_fault,
                    "ramping": self._bucket is not None}
