"""Morpheus runtime: the data-plane half (dispatch + atomic update).

Ported from ``repro.core.runtime`` for one device.  The runtime owns the
executables and plays the role of the eBPF ``BPF_PROG_ARRAY`` swap:

  * **program-level guard**: one host-side version compare per step — if
    the control plane touched any table since the active plan was built,
    traffic routes to the *generic* executable until the next recompile
    lands (deoptimization without data-plane disruption);
  * **adaptive instrumentation**: sampled steps run the instrumented
    twin of the current executable, at the cadence of the plane's
    :class:`~repro_torch.core.controller.sampling.PlaneSampling`;
  * **atomic update**: a recompile cycle plans and builds off the
    serving path; control-plane updates arriving mid-cycle are queued and
    replayed after the swap; the swap itself is a reference assignment.

The control loop (snapshot workers, the shared
:class:`~repro_torch.core.execcache.ExecutableCache`, sampling, the
recompile worker pool) lives in
:class:`~repro_torch.core.controller.MorpheusController`; a runtime made
without ``controller=`` builds a private one.

Device state is one :class:`PlaneState` (``runtime.state``).
Executables never write their input state, so a step's state stays
valid after the next commit.  State transitions follow the reference's
seqlock protocol: dispatch claims the single in-flight step slot in a
brief critical section, runs the executable outside any lock, and
commits the fresh state in a second one; writers (the recompile's swap,
control-plane table refreshes) wait for the in-flight step, mutate under
the lock and bump the generation counter ``_gen``.

Not ported yet (see ROADMAP.md): fused K-step windows (``step_many``,
``warm_fused``), the dispatch fault boundary and degraded mode, mesh
placement, and the request frontend's profile hook.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import instrument
from .controller import ControllerConfig, MorpheusController
from .engine import EngineConfig, MorpheusEngine
from .execcache import ExecutableCache, batch_key
from .snapshot import TableSnapshotWorker, VersionedSnapshot
from .specialize import SpecializationPlan
from .state import PlaneState
from .tables import TableSet


@dataclass
class RuntimeStats:
    """Counters and timing histories of one runtime (all host-side).
    Every write goes through :meth:`bump` or :meth:`log` under one
    internal lock; :meth:`snapshot` returns a consistent plain-dict copy
    (what ``controller.stats()`` aggregates across planes)."""
    steps: int = 0
    deopt_steps: int = 0          # routed to generic by the program guard
    instr_steps: int = 0
    recompiles: int = 0
    swaps: int = 0
    revalidations: int = 0        # cycles that only restamped the version
    cache_hits: int = 0           # executables served from the exec cache
    cache_misses: int = 0         # executables that had to be built
    queued_updates: int = 0
    batch_transfers: int = 0      # batches the runtime moved to the device
    locked_calls: int = 0         # stats-lock acquisitions (one per step)
    t1_history: List[float] = field(default_factory=list)
    t2_history: List[float] = field(default_factory=list)
    swap_history: List[float] = field(default_factory=list)
    pass_stats: Dict[str, int] = field(default_factory=dict)
    snapshot_versions: List[int] = field(default_factory=list)

    def __post_init__(self):
        self._lock = threading.Lock()

    def bump(self, **deltas: int) -> None:
        """Atomically add ``deltas`` to the named scalar counters."""
        with self._lock:
            self.locked_calls += 1
            for name, d in deltas.items():
                setattr(self, name, getattr(self, name) + d)

    def log(self, name: str, value) -> None:
        """Atomically append ``value`` to the named history list."""
        with self._lock:
            self.locked_calls += 1
            getattr(self, name).append(value)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {}
            for f in dataclasses.fields(self):
                v = getattr(self, f.name)
                if isinstance(v, list):
                    v = list(v)
                elif isinstance(v, dict):
                    v = dict(v)
                out[f.name] = v
            return out


_NS_COUNTER = itertools.count()


def _instr_has_samples(instr: Dict[str, Dict[str, Any]]) -> bool:
    """Did this sketch window record anything?  A window with zero
    totals carries no information about traffic."""
    return any(int(np.asarray(st.get("total", 0)).sum()) > 0
               for st in instr.values())


class MorpheusRuntime:
    """Serve one data plane under dynamic recompilation.

    Call :meth:`step` with request batches (the data plane),
    :meth:`control_update` / :meth:`set_feature` from the control plane,
    and :meth:`recompile` to run one Morpheus cycle.

    Parameters: ``user_step(params, ctx, batch)`` written against
    :class:`~repro_torch.core.ctx.DataPlaneCtx`; the :class:`TableSet`;
    model params (on ``cfg.device``); one example batch; an
    :class:`EngineConfig`; ``enable=False`` to pin the generic
    executable (baselines); ``controller=`` to join an existing
    :class:`~repro_torch.core.controller.MorpheusController` fleet;
    ``exec_cache=`` to override the controller's executable cache;
    ``plane_id=`` to name the plane in controller stats.
    """

    def __init__(self, user_step: Callable, tables: TableSet, params,
                 example_batch, cfg: Optional[EngineConfig] = None,
                 enable: bool = True,
                 exec_cache: Optional[ExecutableCache] = None,
                 controller: Optional[MorpheusController] = None,
                 plane_id: Optional[str] = None):
        self.engine = MorpheusEngine(user_step, tables, cfg)
        self.device = self.engine.device
        self.tables = tables
        self.enable = enable
        self.stats = RuntimeStats()

        # ---- join (or build) the control plane ----
        self._private_controller = controller is None
        if controller is None:
            controller = MorpheusController(ControllerConfig(
                exec_cache_capacity=self.engine.cfg.exec_cache_capacity))
        self.controller = controller
        self.plane_id = controller.register(self, plane_id)
        self.sampler = controller.sampler_for(self.plane_id)
        # tear the control loop down when the owner drops the runtime
        # without close() (the controller's plane table is weak)
        if self._private_controller:
            self._finalizer = weakref.finalize(self, controller.close)
        else:
            self._finalizer = weakref.finalize(
                self, controller.unregister, self.plane_id)

        self.params = params
        example_batch = self._place_batch(example_batch)
        self.analysis = self.engine.analyze(params, example_batch)
        self.state: PlaneState = self.engine.init_state()

        self.exec_cache = (exec_cache if exec_cache is not None
                           else controller.exec_cache)
        self._cache_ns = (self.engine.cfg.cache_ns
                          if self.engine.cfg.cache_ns is not None
                          else f"rt-{next(_NS_COUNTER)}")
        # ---- seqlock'd dispatch state (see module docstring) ----
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._gen = 0
        self._stepping = False
        self._writers = 0
        self._step_seq = 0            # dispatch ordinal (sampling cadence)
        self._recompile_mutex = threading.Lock()
        self._compiling = False
        self._queued: List[tuple] = []
        self._closed = False
        self._last_plan_signature: Optional[Any] = None
        self.last_snapshot: Optional[VersionedSnapshot] = None
        self._steps_at_cycle = 0
        # the sketch snapshot retained from the last ARMED cycle: while
        # the sampler has the instrumented twin swapped out, plans keep
        # being built from it instead of an empty profile
        self._plan_instr: Dict[str, Dict[str, Any]] = {}

        # generic + generic-instrumented executables (always available:
        # the runtime holds direct references, so cache eviction can
        # never take the deopt target away)
        self.generic_plan = self.engine.generic_plan()
        self._active_isites = self._isites()
        gen_exec, gen_instr = self._get_many(
            [self.generic_plan,
             self._instr_twin(self.generic_plan, self._active_isites)],
            example_batch, self._active_isites)
        self.generic_instr_exec = gen_instr
        # the active (plan, exec, instr_exec, generic_exec) tuple: ONE
        # attribute, read by dispatch with a single reference load
        self._active: Tuple[SpecializationPlan, Callable, Callable,
                            Callable] = (
            self.generic_plan, gen_exec, gen_instr, gen_exec)
        self._example_batch = example_batch

        self._backbuf = instrument.SketchDoubleBuffer()
        self._backbuf.publish(self.state.instr)

    # ---- batch placement -----------------------------------------------
    def _place_batch(self, batch, count: Optional[dict] = None):
        """Move every leaf of a request batch to the runtime's device
        (numpy arrays are copied into tensors).  Leaves already there pass
        through; ``count`` receives a ``transfers`` delta."""
        out = {}
        moved = False
        for k, v in batch.items():
            t = (v if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.array(v)))
            if t.device != self.device:
                t = t.to(self.device, non_blocking=True)
                moved = True
            out[k] = t
        if moved and count is not None:
            count["transfers"] = count.get("transfers", 0) + 1
        return out

    # ---- executable cache --------------------------------------------
    @property
    def plan(self) -> SpecializationPlan:
        """The active plan (read from the atomic ``_active`` tuple)."""
        return self._active[0]

    @property
    def generic_exec(self) -> Callable:
        """The active generic (deopt target) executable."""
        return self._active[3]

    def _instr_twin(self, plan: SpecializationPlan,
                    isites: Tuple[str, ...]) -> SpecializationPlan:
        """The instrumented twin of ``plan`` — ``plan`` itself when no
        site is instrumented (a disarmed sampler passes ``isites=()``)."""
        if plan.instrumented or not isites:
            return plan
        return dataclasses.replace(plan, instrumented=True,
                                   label=plan.label + "+instr")

    def _isites(self) -> Tuple[str, ...]:
        """The sorted instrumented site ids: the structure of a fresh
        sketch window, part of every cache key and of the revalidation
        condition."""
        return tuple(sorted(self.engine.instrumented_sites()))

    def _exec_key(self, plan: SpecializationPlan, batch,
                  instr_struct: Tuple[str, ...]):
        """Cache key: the plan's *signature* (or its version-stamped
        ``key`` when ``EngineConfig.signature_cache`` is off) × batch
        structure × the instr structure."""
        pkey = (plan.signature if self.engine.cfg.signature_cache
                else plan.key)
        return ExecutableCache.make_key(self._cache_ns,
                                        (pkey, instr_struct),
                                        batch_key(batch))

    def _get_many(self, plans: List[SpecializationPlan], batch,
                  instr_struct: Tuple[str, ...]) -> List[Callable]:
        """Fetch one executable per plan, building the misses through the
        cache's in-flight dedup."""
        out = []
        for plan in plans:
            key = self._exec_key(plan, batch, instr_struct)
            exe = self.exec_cache.probe(key)
            if exe is not None:
                self.stats.bump(cache_hits=1)
            else:
                exe, t2 = self.exec_cache.get_or_compile(
                    key, lambda plan=plan: self.engine.compile(
                        plan, self.state))
                if t2 is not None:          # this plane paid the t2
                    self.stats.log("t2_history", t2)
                    self.stats.bump(cache_misses=1)
                else:
                    self.stats.bump(cache_hits=1)
            out.append(exe)
        return out

    # ---- the seqlock protocol ----------------------------------------
    @contextlib.contextmanager
    def _write(self):
        """Writer side of the dispatch seqlock: wait for the in-flight
        step, mutate ``_active``/``state`` under the lock, and bump the
        generation counter.  Writers take precedence over new steps."""
        with self._cond:
            self._writers += 1
            try:
                while self._stepping:
                    self._cond.wait()
                yield
                self._gen += 1
            finally:
                self._writers -= 1
                self._cond.notify_all()

    def _begin_step(self):
        """Claim the single in-flight step slot (brief critical section).
        Returns ``(gen, active_tuple, state)``."""
        with self._cond:
            while self._stepping or self._writers:
                self._cond.wait()
            self._stepping = True
            self._step_seq += 1
            return self._gen, self._active, self.state

    def _drain_queued_locked(self) -> bool:
        """Apply control updates queued while a step ran (FIFO), with the
        lock held and no step in flight.  True when any was applied."""
        if not self._queued or self._compiling:
            return False
        queued, self._queued = self._queued, []
        for (name, fields, n_valid) in queued:
            self._apply_update_locked(name, fields, n_valid)
        self._gen += 1
        return True

    def _abort_step(self) -> None:
        """Release the step slot without committing (the executable
        raised).  Queued control updates still drain, keeping FIFO."""
        with self._cond:
            notify = self._drain_queued_locked()
            self._stepping = False
            self._cond.notify_all()
        if notify:
            self.controller.notify_update(self)

    def _commit_step(self, gen: int, new_state: PlaneState,
                     publish: bool, deltas: Dict[str, int]):
        """Commit one step's fresh state (brief critical section), drain
        control updates queued meanwhile (the program guard deopts the
        next step), and record the step's stats in ONE locked bump."""
        with self._cond:
            assert self._gen == gen, "writer landed during in-flight step"
            self.state = new_state
            if publish and new_state.instr:
                self._backbuf.publish(new_state.instr)
            notify = self._drain_queued_locked()
            self._stepping = False
            self._cond.notify_all()
        self.stats.bump(**deltas)
        if notify:
            self.controller.notify_update(self)

    # ---- the data plane entry point ----------------------------------
    def step(self, batch):
        """Run one serving step; returns the user output.  Dispatch is
        the paper's three-way choice: deopt to generic when the program
        guard trips, the instrumented twin on sampled steps, else the
        specialized executable.  The executable runs with no lock held."""
        cnt: dict = {}
        batch = self._place_batch(batch, count=cnt)
        gen, active, state = self._begin_step()
        plan, spec_exec, instr_exec, generic_exec = active
        sampled = False
        deltas = {"steps": 1}
        if cnt:
            deltas["batch_transfers"] = cnt["transfers"]
        if self.tables.version != plan.version:
            exec_ = generic_exec
            deltas["deopt_steps"] = 1
        elif self.enable and self.sampler.should_sample(self._step_seq):
            exec_ = instr_exec
            sampled = True
            deltas["instr_steps"] = 1
        else:
            exec_ = spec_exec
        try:
            out, new_state = exec_(self.params, state, batch)
        except BaseException:
            self._abort_step()
            raise
        self._commit_step(gen, new_state, sampled, deltas)
        return out

    def run_generic(self, batch):
        """Replay ``batch`` through the generic plan WITHOUT committing
        state — the reference-semantics oracle.  Executables never write
        their input, so the live state is read as is and left intact."""
        batch = self._place_batch(batch)
        out, _ = self.generic_exec(self.params, self.state, batch)
        return out

    # ---- instrumentation readout -------------------------------------
    def _host_instr_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Host copy of the sketches, read from the double-buffered
        *back* buffer with no runtime lock held."""
        return {sid: {k: v.cpu().numpy() for k, v in st.items()}
                for sid, st in self._backbuf.read().items()}

    # ---- control plane -------------------------------------------------
    @property
    def snapshot_worker(self) -> TableSnapshotWorker:
        """This plane's off-thread t1 snapshotter (owned by the
        controller).  Raises after :meth:`close`."""
        if self._closed:
            raise RuntimeError("runtime closed")
        return self.controller.snapshot_worker_for(self)

    def control_update(self, name: str, fields, n_valid=None) -> None:
        """Control-plane table write.  Queued while a recompile cycle or
        a step is in flight (§4.4) and drained in FIFO order at the
        step's commit or after the cycle's swap; the device copy is
        refreshed before the next dispatch, the program guard deopts
        specialized executables until the next recompile, and the
        controller re-arms this plane's sampling."""
        with self._cond:
            if self._compiling or self._stepping:
                self._queued.append((name, fields, n_valid))
                self.stats.bump(queued_updates=1)
                return
        self._apply_update(name, fields, n_valid)

    def _apply_update_locked(self, name, fields, n_valid):
        """Host TableSet write + version bump, then refresh the device
        copy so the next dispatch serves the new contents."""
        self.tables.control_update(name, fields, n_valid)
        tables = dict(self.state.tables)
        tables[name] = self.tables[name].device_arrays(self.device)
        self.state = self.state.replace(tables=tables)

    def _apply_update(self, name, fields, n_valid):
        with self._write():
            self._apply_update_locked(name, fields, n_valid)
        self.controller.notify_update(self)

    def set_feature(self, name: str, value: bool) -> None:
        """Flip a control-plane feature flag.  Bumps the table version:
        flags are control-plane state, so the program guard deopts any
        executable built with the old pinning."""
        self.engine.cfg.features[name] = value
        self.tables.bump_version(f"flag:{name}")
        self.controller.notify_update(self)

    # ---- recompilation ---------------------------------------------------
    def recompile(self, block: bool = True) -> Optional[dict]:
        """Run one Morpheus compilation cycle (§4.4).  ``block=False``
        queues it on the controller's recompile worker pool — the data
        plane keeps running the old code meanwhile."""
        if not self.enable:
            return None
        if block:
            return self._recompile_now()
        self.controller.schedule(self)
        return None

    def recompile_priority(self) -> float:
        """Scheduler ordering: staleness × traffic since the last cycle,
        both floored at one."""
        staleness = max(self.tables.version - self.plan.version, 0) + 1
        traffic = max(self.stats.steps - self._steps_at_cycle, 1)
        return float(staleness * traffic)

    def _recompile_now(self) -> dict:
        # ONE cycle at a time: a blocking recompile can race a scheduled
        # one, and the pre-swap reads of _active below rely on that
        with self._recompile_mutex:
            return self._recompile_cycle()

    def _recompile_cycle(self) -> dict:
        with self._cond:
            self._compiling = True
        try:
            # t1: versioned snapshot handoff + back-buffer readout +
            # planning.  An empty sketch window (disarmed plane, or no
            # sampled step since the last cycle) plans from the profile
            # retained at the last armed cycle.
            snap = self.snapshot_worker.get(self.tables.version)
            self.last_snapshot = snap
            self.stats.log("snapshot_versions", snap.version)
            instr = self._host_instr_snapshot()
            if self.sampler.armed and _instr_has_samples(instr):
                self._plan_instr = instr
            else:
                instr = self._plan_instr or instr
            plan, t1, pass_stats = self.engine.build_plan(
                instr, snapshot=snap.tables, version=snap.version)
            self.stats.log("t1_history", t1)
            self.stats.pass_stats = pass_stats
            self._last_plan_signature = plan.signature
            if self.exec_cache.is_quarantined(plan.signature):
                # poisoned signature: never re-attempted, keep serving
                self._steps_at_cycle = self.stats.steps
                return {"t1": t1, "pass_stats": pass_stats,
                        "plan": plan.label, "n_sites": len(plan.sites),
                        "quarantined": True}

            # plan churn drives this plane's sampling duty cycle; a
            # disarmed sampler installs executables with no sketches
            self.sampler.observe_cycle(plan.signature)
            isites = self._isites() if self.sampler.armed else ()

            active_plan, active_exec, active_instr, active_generic = \
                self._active
            # a fresh sketch window + zeroed RW guards for the code about
            # to serve, built outside the runtime lock
            fresh_instr = self.engine.init_instr_state(isites)
            fresh_guards = self.engine.init_guards()
            if (self.engine.cfg.signature_cache
                    and plan.signature == active_plan.signature
                    and isites == self._active_isites):
                # REVALIDATION: the planned code is what already runs —
                # restamp the version, re-arm the sketch window and
                # guards, build nothing
                with self._write():
                    self._active = (
                        dataclasses.replace(active_plan,
                                            version=plan.version),
                        active_exec, active_instr, active_generic)
                    self.state = self.state.replace(
                        instr=fresh_instr, guards=fresh_guards)
                    self._backbuf.publish(fresh_instr)
                self.stats.bump(revalidations=1, recompiles=1)
                self._steps_at_cycle = self.stats.steps
                return {"t1": t1, "pass_stats": pass_stats,
                        "plan": self.plan.label,
                        "n_sites": len(plan.sites), "revalidated": True}

            wanted = [plan, self._instr_twin(plan, isites)]
            if isites != self._active_isites:
                # the instr topology changed: refresh the deopt targets
                wanted += [self.generic_plan,
                           self._instr_twin(self.generic_plan, isites)]
            execs = self._get_many(wanted, self._example_batch, isites)
            new_generic = execs[2] if len(execs) > 2 else active_generic
            new_generic_instr = (execs[3] if len(execs) > 3
                                 else self.generic_instr_exec)
            t0 = time.time()
            with self._write():
                # ATOMIC swap: one reference assignment replaces the tuple
                self._active = (plan, execs[0], execs[1], new_generic)
                self.generic_instr_exec = new_generic_instr
                self._active_isites = isites
                self.state = self.state.replace(
                    instr=fresh_instr, guards=fresh_guards)
                self._backbuf.publish(fresh_instr)
            self.stats.log("swap_history", time.time() - t0)
            self.stats.bump(recompiles=1, swaps=1)
            self._steps_at_cycle = self.stats.steps
            return {"t1": t1, "pass_stats": pass_stats,
                    "plan": plan.label, "n_sites": len(plan.sites),
                    "revalidated": False}
        finally:
            # replay queued control updates (§4.4) BEFORE clearing
            # _compiling, in FIFO order, also when the cycle failed
            while True:
                with self._cond:
                    queued, self._queued = self._queued, []
                    if not queued:
                        self._compiling = False
                        break
                for (name, fields, n_valid) in queued:
                    self._apply_update(name, fields, n_valid)

    # ---- introspection -----------------------------------------------------
    def hot_experts(self) -> Optional[Tuple[int, ...]]:
        """Hot set of the active plan's MoE fast path, or None."""
        return self.plan.hot_experts(self.engine.cfg.moe_router_table)

    def close(self) -> None:
        """Detach from the control plane.  Idempotent.  A private
        controller is closed with the runtime; a shared one only
        unregisters this plane.  The runtime can still step, but further
        recompiles raise."""
        self._closed = True
        self._finalizer.detach()
        if self._private_controller:
            self.controller.close()
        else:
            self.controller.unregister(self.plane_id)
