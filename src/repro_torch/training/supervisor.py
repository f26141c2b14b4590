"""TrainSupervisor — Morpheus' robustness contract for the train loop,
ported from ``repro.training.supervisor``.

* **Plan-keyed executables.**  An "executable" is the closure
  :func:`~repro_torch.launch.steps.make_train_step` builds for one
  :class:`~repro_torch.training.plan.TrainPlan`; building it loads every
  CUDA library its step launches (``kernels/build.py``: the first load
  compiles the source with ``nvcc``), which is this port's counterpart
  of the reference's AOT compile.  It is cached under
  ``(ns, (plan.signature, ()), batch_key)`` — the serving runtime's key
  anatomy (the reference's ``donate`` flag has no counterpart), so
  ``ExecutableCache.quarantine`` purges train executables by signature
  exactly as it purges serving ones.  An oscillating hot set re-uses its
  old executable (cache hit, no build).

* **Off-thread build, deterministic barrier swap.**  Respecialization
  decisions fire at fixed step boundaries (every ``respecialize_every``
  steps, a pure function of accumulated router counts); the chosen plan
  builds on the scheduler thread and **activates at a fixed later
  barrier** (``activation_lag`` steps).  If the build has not finished
  when the trainer reaches the barrier, the trainer *waits*: it never
  builds on the training thread, and wall-clock timing never decides
  which executable runs a given step.  The executable sequence π(step)
  is therefore a deterministic function of the trajectory, which is
  what makes crash/resume **bit-exact** (specialized and generic steps
  sum their expert GEMMs over other row groups, so they differ in
  low-order gradient bits; replaying the same π is the only way two
  runs agree).

* **Fault boundary: a specialization fault can never lose an optimizer
  step.**  Injected faults (:class:`~repro_torch.distributed.fault.\
SimulatedFailure`) fire *before* execution, so the supervisor deopts to
  the resident generic executable and runs the same batch.  A fault
  raised by the step itself deopts and retries the same batch on the
  generic step as long as it came before the optimizer's first in-place
  write (the forward and the backward leave the state as it was); one
  after it raises :class:`~repro_torch.distributed.fault.LostStepError`
  (the driver falls back to crash/resume) rather than continuing from a
  half-updated state.

* **Checkpoint coupling.**  :meth:`spec_meta` serializes the active
  plan, staged plans with their activation barriers, the traffic
  profile (router ``counts_acc``, mixture/loss EMAs) and coverage
  window; :meth:`restore_spec` revalidates on ``--resume``: the active
  plan is re-staged for activation at the resume step and built in the
  background — **zero training-thread builds at resume**, with the first
  step waiting at the barrier exactly like any other swap.  A
  quarantined signature deopts instead.

* **Elastic mesh.**  :class:`~repro_torch.distributed.fault.\
SimulatedDeviceLoss` triggers snapshot → device-set shrink →
  :func:`~repro_torch.distributed.fault.elastic_reshard` (verified bit
  for bit) → continue *degraded* on the generic step over the survivors
  while re-specialization proceeds in the background (health-gated);
  :meth:`recover_devices` grows back.  ``devices`` is the device set (a
  list that may repeat a device) and ``sharding_fn(devices)`` the train
  state's layout on a mesh over it
  (``distributed.sharding.train_state_shardings``): the state is placed
  by it (:meth:`place`) and every step's gradients and optimizer state
  are ZeRO-sliced by its ``master`` specs.  Every reshard rotates the
  cache namespace (``purge_namespace``): executables are topology-bound,
  their key holding the layout.

Determinism caveats: ``HealthConfig.min_downtime_s`` must be 0 (the
default) for the probe to be a pure function of step counts, and
``swap_timeout_s`` is a safety valve that sacrifices bit-exactness if it
ever fires (default 600 s — effectively never).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.controller.health import HealthConfig, PlaneHealth, QUARANTINED
from ..core.controller.scheduler import RecompileScheduler
from ..core.execcache import ExecutableCache, batch_key
from ..distributed.fault import (LostStepError, SimulatedCompileFailure,
                                 SimulatedDeviceLoss, SimulatedFailure,
                                 elastic_reshard)
from ..kernels import build as kernel_build
from ..launch.steps import make_train_step
from ..models.params import flat_tree
from .plan import TrainPlan, TrainProfile

# the CUDA libraries a train step launches: attention's forward and
# backward, a Mamba layer's ssd_scan and its backward
TRAIN_LIBRARIES = ("flash_attention", "flash_attention_bwd", "ssd_scan",
                   "ssd_scan_bwd")


@dataclass
class SupervisorConfig:
    """Knobs of one training plane's specialization machinery.

    ``respecialize_every`` is the decision cadence (0 disables
    specialization — the supervisor still provides the fault boundary
    and checkpoint coupling); ``activation_lag`` the decision→swap
    barrier distance (default ``respecialize_every // 2``, min 1).
    ``deopt_coverage`` is the mispredict floor: when the observed
    hot-set coverage over ``mispredict_window`` consecutive steps
    averages below it, the plane deopts to generic between steps
    (default ``hot_coverage - 0.25``)."""
    respecialize_every: int = 0
    activation_lag: Optional[int] = None
    hot_coverage: float = 0.95
    deopt_coverage: Optional[float] = None
    mispredict_window: int = 4
    swap_timeout_s: float = 600.0
    microbatches: int = 1
    cache_capacity: int = 8
    health: HealthConfig = field(default_factory=HealthConfig)

    @property
    def lag(self) -> int:
        if self.activation_lag is not None:
            return max(int(self.activation_lag), 1)
        return max(self.respecialize_every // 2, 1)

    @property
    def deopt_floor(self) -> float:
        if self.deopt_coverage is not None:
            return self.deopt_coverage
        return max(self.hot_coverage - 0.25, 0.0)


class _Staged:
    """One plan waiting for its activation barrier.  ``ready`` is set by
    the scheduler thread on build completion (or by give-up, with
    ``error`` holding the exception)."""

    def __init__(self, plan: TrainPlan, activate_at: int):
        self.plan = plan
        self.activate_at = activate_at
        self.ready = threading.Event()
        self.exe: Any = None
        self.error: Optional[BaseException] = None


class TrainSupervisor:
    """See module docstring.  Single training thread calls
    :meth:`step`; the scheduler's worker thread calls
    :meth:`_recompile_now`; both share the executable cache and the
    staged-plan list under ``_lock``."""

    def __init__(self, model, opt_cfg, state, example_batch, *,
                 cfg: Optional[SupervisorConfig] = None,
                 exec_cache: Optional[ExecutableCache] = None,
                 devices: Optional[List] = None,
                 sharding_fn: Optional[Callable[[List], Any]] = None,
                 plane_id: str = "train",
                 ckpt_dir: Optional[str] = None,
                 meta_fn: Optional[Callable[[], Dict]] = None,
                 injector=None,
                 log_fn: Callable[[str], None] = print):
        self.model = model
        self.opt_cfg = opt_cfg
        self.cfg = cfg or SupervisorConfig()
        moe = getattr(model.cfg, "moe", None)
        self.num_experts = moe.num_experts if moe is not None else 0
        self.cache = exec_cache or ExecutableCache(self.cfg.cache_capacity)
        self.plane_id = plane_id
        self.injector = injector
        self._meta_fn = meta_fn
        self._ckpt_dir = ckpt_dir
        self._log = log_fn
        h = self.cfg.health
        self.health = PlaneHealth(h, plane_id=plane_id)
        self.scheduler = RecompileScheduler(
            1, name=f"morpheus-train-{plane_id}",
            backoff_base_s=h.backoff_base_s, backoff_cap_s=h.backoff_cap_s,
            max_retries=h.max_retries, on_give_up=self._on_give_up,
            clock=h.clock)
        self._devices = (list(devices) if devices
                         else [example_batch["tokens"].device])
        self._all_devices = list(self._devices)
        self._sharding_fn = sharding_fn
        self._mesh_epoch = 0
        # shapes and dtypes only (no live tensors)
        self._state_key = batch_key(flat_tree(state))
        self._batch_key = batch_key(example_batch)
        self._refresh_layout()
        # seconds of each reshard's phases (snapshot, restore, verify,
        # rebuild), in order
        self.reshard_times: List[Dict[str, float]] = []
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats: Dict[str, Any] = {
            "steps": 0, "activations": 0, "staged": 0,
            "mispredict_deopts": 0, "step_faults": 0, "retried_steps": 0,
            "device_losses": 0, "grow_backs": 0, "reshard_verified": 0,
            "respecialize_recoveries": 0, "quarantines": 0,
            "quarantine_skips": 0, "gated_decisions": 0,
            "failed_activations": 0, "activation_timeouts": 0,
            "resumes": 0, "resume_deopts": 0,
            "sync_compiles": 0, "bg_compiles": 0, "cache_hits": 0,
            "compile_s": 0.0, "swap_waits": 0, "swap_wait_s": 0.0,
        }
        self._step = 0
        self._plan_version = 0
        self._compile_faults = 0
        self._degraded: Optional[str] = None
        self._fault_step: Optional[int] = None
        self.profile = TrainProfile(max(self.num_experts, 1))
        self._cov_window: deque = deque(maxlen=self.cfg.mispredict_window)
        # the resident generic step — the deopt target.  Built
        # synchronously ONCE; this is the only build the training
        # thread ever pays.
        self._generic_plan = TrainPlan(None)
        self._generic_exe = self._compile_plan(self._generic_plan,
                                               sync=True)
        self._active: Tuple[TrainPlan, Any] = (self._generic_plan,
                                               self._generic_exe)
        self._staged: List[_Staged] = []

    # ---- topology -----------------------------------------------------------
    @property
    def _ns(self) -> str:
        return f"train/{self.plane_id}@{self._mesh_epoch}"

    def _refresh_layout(self) -> None:
        """The current topology's state layout, gradient shardings and
        executable key (shapes, dtypes and where each leaf lies)."""
        self._shardings = (self._sharding_fn(self._devices)
                           if self._sharding_fn is not None else None)
        self._grad_sh = (self._shardings["opt"]["master"]
                         if self._shardings is not None else None)
        layout = (() if self._shardings is None else tuple(
            (k, sh.spec, tuple(str(d) for d in sh.devices))
            for k, sh in flat_tree(self._shardings).items()))
        self._bkey = (self._state_key, self._batch_key, layout)

    def place(self, tree):
        """Lay a live train state out by the current topology's sharding
        (``distributed.sharding.place_train_state``; a no-op without a
        ``sharding_fn``).  Call once on the initial state.  Batches need
        no placement: the model runs on the mesh's home device."""
        if self._shardings is None:
            return tree
        from ..distributed.sharding import place_train_state
        return place_train_state(tree, self._shardings)

    @property
    def devices(self) -> List:
        return list(self._devices)

    @property
    def mesh_epoch(self) -> int:
        return self._mesh_epoch

    # ---- building -----------------------------------------------------------
    def _compile_plan(self, plan: TrainPlan, sync: bool):
        key = ExecutableCache.make_key(self._ns, (plan.signature, ()),
                                       self._bkey)
        grad_sh = self._grad_sh          # this topology's, at build time
        devices = [torch.device(d) for d in self._devices]

        def build():
            t0 = time.perf_counter()
            fn = make_train_step(self.model, self.opt_cfg,
                                 microbatches=self.cfg.microbatches,
                                 hot_experts=plan.hot or (),
                                 grad_shardings=grad_sh)
            if any(d.type == "cuda" for d in devices):
                for name in TRAIN_LIBRARIES:
                    kernel_build.load(name)
            return fn, time.perf_counter() - t0

        exe, t2 = self.cache.get_or_compile(key, build)
        with self._stats_lock:
            if t2 is not None:
                self._stats["compile_s"] += t2
                self._stats["sync_compiles" if sync else "bg_compiles"] += 1
            else:
                self._stats["cache_hits"] += 1
        return exe

    # duck-typed plane interface for RecompileScheduler ---------------------
    def recompile_priority(self) -> float:
        with self._lock:
            return float(sum(1 for s in self._staged
                             if not s.ready.is_set()))

    def _recompile_now(self) -> None:
        while True:
            with self._lock:
                st = next((s for s in self._staged
                           if not s.ready.is_set()), None)
            if st is None:
                return
            if self._compile_faults > 0:
                self._compile_faults -= 1
                raise SimulatedCompileFailure(
                    f"injected compile failure for {st.plan.label}")
            st.exe = self._compile_plan(st.plan, sync=False)
            st.ready.set()

    def _on_give_up(self, plane_id: str, exc: BaseException) -> None:
        with self._lock:
            st = next((s for s in self._staged
                       if not s.ready.is_set()), None)
        if st is None:
            return
        self.cache.quarantine(st.plan.signature)
        self.health.quarantine(f"compile gave up: {exc}")
        with self._stats_lock:
            self._stats["quarantines"] += 1
        st.error = exc
        st.ready.set()
        self._log(f"morpheus: quarantined {st.plan.label} after bounded "
                  f"retries ({exc})")

    def arm_compile_faults(self, n: int) -> None:
        """The next ``n`` background build cycles raise
        :class:`SimulatedCompileFailure` — exercises the scheduler's
        backoff retry (n <= max_retries) or quarantine (n > max_retries)
        on the training plane."""
        self._compile_faults = int(n)

    # ---- the step ---------------------------------------------------------
    def step(self, state, batch):
        """Run one optimizer step under the robustness contract.  The
        returned ``(state, metrics)`` always reflects exactly one
        applied update of ``batch`` — faults deopt and retry, never
        skip.  The state is updated in place and returned."""
        self._maybe_activate()
        if self.injector is not None:
            try:
                self.injector.check(self._step)
            except SimulatedDeviceLoss as e:
                state = self._device_loss(state, e)
            except SimulatedFailure as e:
                # in-process fault boundary: fires BEFORE execution, so
                # the state is intact — deopt and run the same batch on
                # the resident generic step
                self._fault_deopt(f"injected fault: {e}")
        plan, exe = self._active
        try:
            new_state, metrics = exe(state, batch)
        except LostStepError:
            raise                        # past the optimizer's first write
        except Exception as e:          # noqa: BLE001 — before it: retry
            self._fault_deopt(f"executable fault: {e}")
            with self._stats_lock:
                self._stats["retried_steps"] += 1
            new_state, metrics = self._generic_exe(state, batch)
        self._step += 1
        with self._stats_lock:
            self._stats["steps"] += 1
        self._observe(plan, metrics)
        return new_state, metrics

    def _maybe_activate(self) -> None:
        while True:
            with self._lock:
                st = (self._staged[0] if self._staged
                      and self._step >= self._staged[0].activate_at
                      else None)
            if st is None:
                return
            if not st.ready.is_set():
                # the barrier: wait for the scheduler thread's build —
                # the trainer never builds specialized code itself, and
                # π(step) stays timing-independent
                t0 = time.perf_counter()
                ok = st.ready.wait(self.cfg.swap_timeout_s)
                with self._stats_lock:
                    self._stats["swap_waits"] += 1
                    self._stats["swap_wait_s"] += time.perf_counter() - t0
                if not ok:
                    with self._stats_lock:
                        self._stats["activation_timeouts"] += 1
                    with self._lock:
                        if self._staged and self._staged[0] is st:
                            self._staged.pop(0)
                    self._log("morpheus: staged build missed the swap "
                              "barrier; dropping plan (bit-exactness lost)")
                    continue
            with self._lock:
                if self._staged and self._staged[0] is st:
                    self._staged.pop(0)
            if st.error is not None or st.exe is None:
                with self._stats_lock:
                    self._stats["failed_activations"] += 1
                continue
            was_degraded = self._degraded is not None
            with self._lock:
                self._active = (st.plan, st.exe)
            if st.plan.specialized:
                self._cov_window.clear()
                with self._stats_lock:
                    self._stats["activations"] += 1
                if was_degraded:
                    self.health.on_recovered()
                    self._degraded = None
                    self._fault_step = None
                    with self._stats_lock:
                        self._stats["respecialize_recoveries"] += 1
                self._log(f"morpheus: swapped in hot-expert step "
                          f"hot={st.plan.hot} at step {self._step}")
            else:
                self._log(f"morpheus: deopt to generic train step at "
                          f"barrier (step {self._step})")

    def _fault_deopt(self, reason: str) -> None:
        with self._lock:
            self._active = (self._generic_plan, self._generic_exe)
            self._staged.clear()
        self._cov_window.clear()
        self._degraded = reason
        self._fault_step = self._step
        self.health.on_fault(reason, steps=self._step)
        with self._stats_lock:
            self._stats["step_faults"] += 1
        self._log(f"morpheus: fault ({reason}); deopt to generic "
                  f"train step")

    def _observe(self, plan: TrainPlan, metrics) -> None:
        every = self.cfg.respecialize_every
        if not (every and self.num_experts):
            return
        if "expert_counts" in metrics:
            counts = metrics["expert_counts"].cpu().numpy().reshape(
                -1, self.num_experts).sum(0).astype(np.int64)
            self.profile.observe(counts, float(metrics["loss"]))
            if plan.specialized:
                total = int(counts.sum())
                if total > 0:
                    cov = float(counts[list(plan.hot)].sum() / total)
                    self._cov_window.append(cov)
                    if (len(self._cov_window)
                            == self.cfg.mispredict_window
                            and (sum(self._cov_window)
                                 / len(self._cov_window))
                            < self.cfg.deopt_floor):
                        self._mispredict_deopt()
        if self._step % every == 0:
            self._decide(self.profile.decide(self.cfg.hot_coverage))

    def _mispredict_deopt(self) -> None:
        # a wrong hot set is a *misprediction*, not a fault: deopt
        # between steps without involving health (matches the serving
        # plane, where per-batch guard fallback is normal operation)
        cov = sum(self._cov_window) / len(self._cov_window)
        with self._lock:
            plan = self._active[0]
            self._active = (self._generic_plan, self._generic_exe)
        self._cov_window.clear()
        with self._stats_lock:
            self._stats["mispredict_deopts"] += 1
        self._log(f"morpheus: coverage {cov:.2f} < "
                  f"{self.cfg.deopt_floor:.2f} for {plan.label}; "
                  f"deopt to generic (mispredict)")

    def _decide(self, desired: Optional[Tuple[int, ...]]) -> None:
        with self._lock:
            active_hot = self._active[0].hot
            pending = self._staged[-1].plan.hot if self._staged else False
        if pending is not False and pending == desired:
            return                       # already staged
        if desired == active_hot:
            if pending is not False:     # decision reverted: drop staged
                with self._lock:
                    self._staged.clear()
            return
        activate_at = self._step + self.cfg.lag
        if desired is None:
            # deopt at a deterministic barrier (the generic executable
            # is resident — ready immediately)
            st = _Staged(self._generic_plan, activate_at)
            st.exe = self._generic_exe
            st.ready.set()
            with self._lock:
                self._staged = [st]
            return
        plan = TrainPlan(tuple(desired), version=self._plan_version)
        if self.cache.is_quarantined(plan.signature):
            with self._stats_lock:
                self._stats["quarantine_skips"] += 1
            return
        if self.health.state == QUARANTINED:
            self.health.on_update()      # new hot set = new basis
        if not self.health.gate_schedule(self._step):
            with self._stats_lock:
                self._stats["gated_decisions"] += 1
            return
        self._plan_version += 1
        st = _Staged(plan, activate_at)
        with self._lock:
            self._staged = [st]
        with self._stats_lock:
            self._stats["staged"] += 1
        self.scheduler.submit(self.plane_id, self)
        self._log(f"morpheus: staged {plan.label} "
                  f"(activate at step {activate_at})")

    # ---- checkpoint coupling ---------------------------------------------
    def spec_meta(self) -> Dict[str, Any]:
        """The specialization state a checkpoint must carry for
        ``--resume`` to reproduce π(step) exactly."""
        with self._lock:
            plan = self._active[0]
            staged = [{"hot": (list(s.plan.hot)
                               if s.plan.hot is not None else None),
                       "activate_at": s.activate_at}
                      for s in self._staged]
        return {"step": self._step,
                "active_hot": (list(plan.hot) if plan.specialized
                               else None),
                "staged": staged,
                "profile": self.profile.to_meta(),
                "coverage_window": list(self._cov_window),
                "degraded": self._degraded,
                "fault_step": self._fault_step,
                "mesh_epoch": self._mesh_epoch,
                "n_devices": len(self._devices)}

    def restore_spec(self, spec: Optional[Dict[str, Any]],
                     resume_step: Optional[int] = None) -> None:
        """Revalidate-or-deopt from a checkpoint's spec meta.  The
        active plan is re-staged for activation at the resume step (the
        first :meth:`step` call waits at the barrier for the background
        build — or hits the cache in-process); quarantined signatures
        deopt instead.  No training-thread builds either way."""
        spec = spec or {}
        self._step = int(resume_step if resume_step is not None
                         else spec.get("step", 0))
        self.profile.from_meta(spec.get("profile"))
        self._cov_window.clear()
        self._cov_window.extend(spec.get("coverage_window") or [])
        self._degraded = spec.get("degraded")
        self._fault_step = spec.get("fault_step")
        if self._degraded:
            self.health.on_fault(self._degraded,
                                 steps=self._fault_step or self._step)
        items: List[Dict[str, Any]] = []
        if spec.get("active_hot"):
            items.append({"hot": spec["active_hot"],
                          "activate_at": self._step})
        items.extend(spec.get("staged") or [])
        staged: List[_Staged] = []
        for it in items:
            hot = it.get("hot")
            if hot is None:
                st = _Staged(self._generic_plan, int(it["activate_at"]))
                st.exe = self._generic_exe
                st.ready.set()
            else:
                plan = TrainPlan(tuple(int(x) for x in hot),
                                 version=self._plan_version)
                self._plan_version += 1
                if self.cache.is_quarantined(plan.signature):
                    with self._stats_lock:
                        self._stats["resume_deopts"] += 1
                    self._log(f"morpheus: {plan.label} is quarantined; "
                              f"resuming on generic")
                    continue
                st = _Staged(plan, int(it["activate_at"]))
            staged.append(st)
        with self._lock:
            self._staged = staged
            need_compile = any(not s.ready.is_set() for s in staged)
        with self._stats_lock:
            self._stats["resumes"] += 1
        if need_compile:
            self.scheduler.submit(self.plane_id, self)
        if spec.get("active_hot"):
            self._log(f"morpheus: revalidating specialized train step "
                      f"hot={tuple(spec['active_hot'])} from checkpoint")

    # ---- elastic mesh -----------------------------------------------------
    def _elastic_dir(self) -> str:
        if self._ckpt_dir is None:
            import tempfile
            self._ckpt_dir = tempfile.mkdtemp(prefix="morpheus_elastic_")
        return str(self._ckpt_dir) + "/.elastic"

    def _device_loss(self, state, exc):
        """The device-loss arc: snapshot → shrink the device set →
        elastic reshard → continue degraded on generic over the
        survivors (re-specialization is health-gated background work)."""
        with self._stats_lock:
            self._stats["device_losses"] += 1
        survivors = self._devices[:-1] or self._devices
        self._log(f"morpheus: device loss at step {self._step} ({exc}); "
                  f"shrinking {len(self._devices)} -> {len(survivors)} "
                  f"device(s)")
        state = self._reshard(state, survivors)
        reason = f"device loss: {exc}"
        self._degraded = reason
        self._fault_step = self._step
        self.health.on_fault(reason, steps=self._step)
        self._log(f"morpheus: degraded on {len(self._devices)} device(s); "
                  f"re-specialization continues in background")
        return state

    def recover_devices(self, state):
        """Grow back to the full device set (the inverse arc: snapshot →
        reshard onto all devices → re-specialize at the next decision
        boundary)."""
        if len(self._devices) >= len(self._all_devices):
            return state
        with self._stats_lock:
            self._stats["grow_backs"] += 1
        self._log(f"morpheus: growing back "
                  f"{len(self._devices)} -> {len(self._all_devices)} "
                  f"device(s)")
        return self._reshard(state, list(self._all_devices))

    def _reshard(self, state, devices):
        """Snapshot ``state`` (kept on the host too), move to ``devices``
        under a new cache namespace, restore the snapshot onto their
        layout (into ``state``: in place where a leaf's layout holds,
        rebuilt leaf by leaf where it changes), verify it bit for bit
        against the host copy, and rebuild the resident generic step —
        the one extra training-thread build a topology change costs."""
        from ..checkpoint import save
        from ..distributed.sharding import gather_to_host
        t0 = time.perf_counter()
        snap_dir = self._elastic_dir()
        meta = dict(self._meta_fn() if self._meta_fn is not None else {})
        meta["morpheus"] = self.spec_meta()
        save(snap_dir, self._step, state, meta=meta, keep_last=2)
        host = gather_to_host(state)
        t1 = time.perf_counter()
        old_ns = self._ns
        self._devices = list(devices)
        self._mesh_epoch += 1
        self.cache.purge_namespace(old_ns)   # executables are
        self._refresh_layout()               # topology-bound
        restored, _ = elastic_reshard(snap_dir, state, self._shardings)
        t2 = time.perf_counter()
        got = gather_to_host(restored)
        ok = got.keys() == host.keys() and all(
            torch.equal(got[k], host[k]) for k in host)
        del got, host
        t3 = time.perf_counter()
        if not ok:                           # corrupt restore: stop, do
            raise LostStepError(             # not train on garbage
                f"elastic reshard verification failed at step "
                f"{self._step}")
        with self._stats_lock:
            self._stats["reshard_verified"] += 1
        self._generic_exe = self._compile_plan(self._generic_plan,
                                               sync=True)
        with self._lock:
            self._active = (self._generic_plan, self._generic_exe)
            self._staged.clear()
        self._cov_window.clear()
        self.reshard_times.append({
            "snapshot_s": t1 - t0, "restore_s": t2 - t1,
            "verify_s": t3 - t2, "rebuild_s": time.perf_counter() - t3})
        return restored

    # ---- introspection ----------------------------------------------------
    @property
    def active_plan(self) -> TrainPlan:
        with self._lock:
            return self._active[0]

    @property
    def step_count(self) -> int:
        return self._step

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            out = dict(self._stats)
        out["health"] = self.health.state
        out["active"] = self.active_plan.label
        out["mesh_epoch"] = self._mesh_epoch
        out["n_devices"] = len(self._devices)
        with self._lock:
            out["staged_pending"] = len(self._staged)
        return out

    def drain(self, timeout: float = 120.0) -> bool:
        """Wait for background builds to settle (tests/benches)."""
        return self.scheduler.drain(timeout=timeout)

    def close(self) -> None:
        self.scheduler.close()
