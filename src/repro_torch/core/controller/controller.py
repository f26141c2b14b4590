"""MorpheusController — one adaptive control plane driving N data planes.

The paper frames Morpheus as "a system working alongside static
compilers": the update-frequency tracking, adaptive instrumentation and
recompilation scheduling form a *controller* observing many data planes.
This module is that controller as a standalone subsystem; a
:class:`~repro_torch.core.runtime.MorpheusRuntime` is now only the data-plane
half (dispatch, atomic executable tuple, control-update queue) and
registers itself here.  The controller owns, per fleet:

  * the **snapshot workers** (one
    :class:`~repro_torch.core.snapshot.TableSnapshotWorker` per registered
    plane, created lazily, torn down on unregister/close) — ``t1`` table
    copies never run on a control-plane or serving thread;
  * the shared **ExecutableCache** — every registered plane compiles
    into one LRU by default, bounding total compiled-code memory across
    the fleet (planes still namespace their keys unless
    ``EngineConfig.cache_ns`` opts into full sharing);
  * the **adaptive sampling scheduler**
    (:class:`~repro_torch.core.controller.sampling.PlaneSampling`, one per
    plane): instrumentation duty cycle driven by plan-churn rate, twins
    swapped out after ``disarm_after`` stable cycles, re-armed on any
    control update;
  * the **recompile scheduler**
    (:class:`~repro_torch.core.controller.scheduler.RecompileScheduler`): one
    bounded worker pool prioritizing planes by staleness x traffic,
    replacing the per-runtime ad-hoc compile threads.

Single-plane convenience: constructing a ``MorpheusRuntime`` without a
``controller=`` builds a private controller, so the classic one-runtime
API is unchanged — ``rt.close()`` closes the private controller with it.

The controller references planes **weakly**: dropping a runtime without
closing it lets a ``weakref.finalize`` hook tear its snapshot worker
down instead of leaking a parked thread.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..execcache import CacheStats, ExecutableCache
from ..snapshot import TableSnapshotWorker
from .health import HealthConfig, PlaneHealth
from .sampling import PlaneSampling, SamplingConfig
from .scheduler import RecompileScheduler

_PLANE_COUNTER = itertools.count()


@dataclass
class ControllerConfig:
    """Static configuration of one :class:`MorpheusController`."""
    workers: int = 2                   # recompile worker pool size
    exec_cache_capacity: int = 128     # shared LRU entries
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    health: HealthConfig = field(default_factory=HealthConfig)


@dataclass
class ControllerStats:
    """Aggregated fleet view returned by :meth:`MorpheusController.stats`.

    ``planes`` maps plane id -> that runtime's ``RuntimeStats.snapshot()``
    dict; ``totals`` sums every integer counter across planes;
    ``sampling`` maps plane id -> the sampling state machine's snapshot
    (armed / duty_cycle / ...); ``scheduler`` and ``cache`` are the
    worker pool's and the shared executable cache's counters (the
    scheduler dict carries per-plane ``last_errors`` — a plane whose
    recompile cycles are failing is visible here, not silently
    dropped); ``health`` maps plane id -> the health state machine's
    snapshot (state / faults / recoveries / last_fault)."""
    planes: Dict[str, Dict[str, Any]]
    totals: Dict[str, int]
    sampling: Dict[str, Dict[str, Any]]
    scheduler: Dict[str, Any]
    cache: CacheStats
    health: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    @property
    def cache_hit_rate(self) -> float:
        n = self.cache.hits + self.cache.misses
        return self.cache.hits / n if n else 0.0

    def last_error(self, plane_id: str) -> Optional[str]:
        """The plane's most recent recompile-cycle failure (None when
        its last cycle succeeded)."""
        return self.scheduler.get("last_errors", {}).get(plane_id)


class MorpheusController:
    """The optimization-control loop over a fleet of data planes.

    Usage (N planes, one controller)::

        ctl = MorpheusController(ControllerConfig(workers=2))
        rts = [MorpheusRuntime(step, tables_i, params, batch,
                               cfg=ecfg, controller=ctl)
               for tables_i in table_sets]
        ...serve...
        for rt in rts:
            ctl.schedule(rt)        # or rt.recompile(block=False)
        ctl.drain()
        print(ctl.stats().totals)
        ctl.close()
    """

    def __init__(self, cfg: Optional[ControllerConfig] = None,
                 exec_cache: Optional[ExecutableCache] = None):
        self.cfg = cfg or ControllerConfig()
        self.exec_cache = (exec_cache if exec_cache is not None
                           else ExecutableCache(
                               self.cfg.exec_cache_capacity))
        h = self.cfg.health
        self.scheduler = RecompileScheduler(
            self.cfg.workers,
            backoff_base_s=h.backoff_base_s,
            backoff_cap_s=h.backoff_cap_s,
            max_retries=h.max_retries,
            on_give_up=self._on_give_up,
            clock=h.clock)
        self._lock = threading.Lock()
        self._planes: Dict[str, "weakref.ref"] = {}
        self._samplers: Dict[str, PlaneSampling] = {}
        self._workers: Dict[str, TableSnapshotWorker] = {}
        self._health: Dict[str, PlaneHealth] = {}
        self._closed = False

    # ---- fleet membership -------------------------------------------------
    def register(self, runtime, plane_id: Optional[str] = None) -> str:
        """Attach a data plane; returns its plane id.  Called by
        ``MorpheusRuntime.__init__`` — the runtime hands its sketch
        config over so the plane's sampling state machine starts at the
        plane's configured cadence."""
        with self._lock:
            if self._closed:
                raise RuntimeError("controller closed")
            pid = (plane_id if plane_id is not None
                   else f"plane-{next(_PLANE_COUNTER)}")
            if pid in self._planes and self._planes[pid]() is not None:
                raise ValueError(f"plane id {pid!r} already registered")
            self._planes[pid] = weakref.ref(runtime)
            self._samplers[pid] = PlaneSampling(runtime.engine.cfg.sketch,
                                                self.cfg.sampling)
            self._health[pid] = PlaneHealth(self.cfg.health, plane_id=pid)
            return pid

    def unregister(self, plane_id: str) -> None:
        """Detach a plane and stop its snapshot worker.  Idempotent —
        also the ``weakref.finalize`` target for runtimes dropped
        without ``close()``."""
        with self._lock:
            self._planes.pop(plane_id, None)
            self._samplers.pop(plane_id, None)
            self._health.pop(plane_id, None)
            worker = self._workers.pop(plane_id, None)
        if worker is not None:
            worker.stop()

    def planes(self) -> Dict[str, Any]:
        """Live registered runtimes by plane id."""
        with self._lock:
            out = {pid: ref() for pid, ref in self._planes.items()}
        return {pid: rt for pid, rt in out.items() if rt is not None}

    # ---- per-plane services ----------------------------------------------
    def sampler_for(self, plane_id: str) -> PlaneSampling:
        """The plane's sampling state machine (stable object — runtimes
        cache it as ``rt.sampler``)."""
        with self._lock:
            return self._samplers[plane_id]

    def snapshot_worker_for(self, runtime) -> TableSnapshotWorker:
        """The plane's off-thread t1 snapshotter, created on first use.
        Raises once the controller is closed or the plane unregistered —
        a background recompile racing ``close()`` must not silently
        resurrect the thread."""
        pid = runtime.plane_id
        with self._lock:
            if self._closed or pid not in self._planes:
                raise RuntimeError(
                    f"controller closed or plane {pid!r} unregistered")
            worker = self._workers.get(pid)
            if worker is None:
                worker = TableSnapshotWorker(
                    runtime.tables, name=f"morpheus-snapshot-{pid}")
                self._workers[pid] = worker
            return worker

    def notify_update(self, runtime) -> None:
        """A control-plane write landed on ``runtime``'s tables: re-arm
        its sampling (the specialization basis moved), kick its snapshot
        worker so a fresh t1 snapshot is published off-thread, and give
        a QUARANTINED plane a fresh chance (new tables => possibly a
        new, unpoisoned plan signature).  Never raises — update paths
        must survive a closed controller."""
        with self._lock:
            sampler = self._samplers.get(runtime.plane_id)
            worker = self._workers.get(runtime.plane_id)
            health = self._health.get(runtime.plane_id)
        if sampler is not None:
            sampler.rearm()
        if worker is not None:
            worker.request()
        if health is not None:
            health.on_update()

    # ---- fleet health ------------------------------------------------------
    def health_for(self, plane_id: str) -> PlaneHealth:
        """The plane's health state machine (stable object)."""
        with self._lock:
            return self._health[plane_id]

    def on_plane_fault(self, runtime, reason: str) -> None:
        """The runtime's dispatch fault boundary degraded ``runtime`` to
        generic-only dispatch.  Records the fault (with the step counter
        as the recovery probe's baseline) so ``schedule`` starts gating
        on the probe.  Never raises — this runs on the serving thread's
        fault path."""
        with self._lock:
            health = self._health.get(runtime.plane_id)
        if health is not None:
            try:
                steps = runtime.stats.steps
            except Exception:
                steps = None
            health.on_fault(reason, steps=steps)

    def on_plane_recovered(self, runtime) -> None:
        """A re-specialization cycle swapped specialized code back into
        a degraded ``runtime``: flip it (back) to HEALTHY with the
        admission ramp armed.  Never raises."""
        with self._lock:
            health = self._health.get(runtime.plane_id)
        if health is not None:
            health.on_recovered()

    def _on_give_up(self, plane_id: str, exc: BaseException) -> None:
        """Scheduler give-up hook: ``plane_id``'s cycle kept failing
        through the bounded backoff retries.  Quarantine the plan
        signature in the shared cache (never re-attempted — every plane
        falls through to generic for it) and the plane's health."""
        with self._lock:
            ref = self._planes.get(plane_id)
            health = self._health.get(plane_id)
        runtime = ref() if ref is not None else None
        sig = getattr(runtime, "_last_plan_signature", None)
        if sig is not None:
            self.exec_cache.quarantine(sig)
        if health is not None:
            health.quarantine(repr(exc))

    # ---- recompilation ----------------------------------------------------
    def schedule(self, runtime) -> bool:
        """Queue one recompile cycle for ``runtime`` on the shared worker
        pool (coalesced if already pending).  Non-blocking.  Health-
        gated: a DEGRADED plane is queued only once its recovery probe
        passes (``min_downtime_s`` elapsed and ``probe_steps`` served
        since the fault — passing flips it to RECOVERING); a QUARANTINED
        plane is never queued (its signature is poisoned until a control
        update moves the basis).  Returns False when the gate held the
        plane back."""
        if self._closed:
            raise RuntimeError("controller closed")
        with self._lock:
            health = self._health.get(runtime.plane_id)
        if health is not None:
            try:
                steps = runtime.stats.steps
            except Exception:
                steps = None
            if not health.gate_schedule(steps):
                return False
        return self.scheduler.submit(runtime.plane_id, runtime)

    def schedule_all(self) -> int:
        """Queue a cycle for every registered plane; returns how many
        were newly queued."""
        return sum(bool(self.schedule(rt))
                   for rt in self.planes().values())

    def drain(self, timeout: float = 120.0) -> bool:
        """Wait until the recompile pool is idle."""
        return self.scheduler.drain(timeout)

    # ---- introspection / teardown -----------------------------------------
    def stats(self) -> ControllerStats:
        planes: Dict[str, Dict[str, Any]] = {}
        sampling: Dict[str, Dict[str, Any]] = {}
        health: Dict[str, Dict[str, Any]] = {}
        for pid, rt in self.planes().items():
            planes[pid] = rt.stats.snapshot()
            with self._lock:
                sampler = self._samplers.get(pid)
                hm = self._health.get(pid)
            if sampler is not None:
                sampling[pid] = sampler.state()
            if hm is not None:
                health[pid] = hm.snapshot()
        totals: Dict[str, int] = {}
        for snap in planes.values():
            for k, v in snap.items():
                if isinstance(v, bool) or not isinstance(v, int):
                    continue
                totals[k] = totals.get(k, 0) + v
        return ControllerStats(planes=planes, totals=totals,
                               sampling=sampling,
                               scheduler=self.scheduler.stats(),
                               # a point-in-time copy like every other
                               # field, not the live mutating object
                               cache=dataclasses.replace(
                                   self.exec_cache.stats),
                               health=health)

    def close(self) -> None:
        """Tear the fleet's control loop down: stop the recompile pool
        and every snapshot worker.  Registered runtimes keep *serving*
        (dispatch needs nothing from the controller) but further
        recompiles raise.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            workers = list(self._workers.values())
            self._workers.clear()
        self.scheduler.close()
        for w in workers:
            w.stop()

    @property
    def closed(self) -> bool:
        return self._closed
