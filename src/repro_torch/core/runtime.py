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

:meth:`MorpheusRuntime.step_many` is the fused fast path: one K-step
executable (a loop over the plan's step closure, in place of the
reference's ``lax.scan``; cached in the
:class:`~repro_torch.core.execcache.ExecutableCache` with K in the key)
takes one claim/commit and one locked stats call per window.  The program
guard and the sampling decision are hoisted to the window: a control
update landing mid-window deopts the *next* window.
:meth:`MorpheusRuntime.place_batch` places a batch (or a stacked window)
on the device ahead of dispatch; a placed batch is never moved again.
:meth:`MorpheusRuntime.attach_profile` feeds the serving frontend's
arrival profile into every recompile cycle's plan inputs.

The dispatch fault boundary: a step or window that raises aborts its
claim (nothing is committed, and since executables never write their
input the state is as it was), degrades the plane to generic-only
dispatch and re-raises, so the caller can retry the same batch through
the generic executable.  The controller's health-gated recovery clears
the degrade at the next revalidation or swap.  A chaos hook
(:class:`~repro_torch.distributed.fault.FailureInjector`) fires inside
the step's try block before the executable, and armed compile faults
fail recompile cycles right after planning.

Sharded serving (``EngineConfig(mesh=)``): the same runtime spans a
:class:`~repro_torch.distributed.meshctx.Mesh` driven by this one
process, so its threads, seqlock and controller stay one object, as in
the reference.  Params, tables and guards are replicated (one copy per
distinct device), each data shard keeps its own sketch, and a placed
batch is split on its leading dim over the shards (a fused window on its
per-step dim), or kept whole on the home device when it does not divide.
The engine's executable runs the step per shard (``core/engine.py``).
At plan time the shards' sketches are merged on the device
(:func:`~repro_torch.core.instrument.merge_on_device`), so the pass
registry sees one global traffic snapshot, the plan one device would
build.  :meth:`MorpheusRuntime.simulate_device_loss` on a mesh hands the
live state over to one device byte for byte and drops the mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import instrument
from ..distributed import compat
from ..distributed.compat import Sharded
from ..distributed.sharding import plane_batch_shardings
from ..distributed.fault import SimulatedCompileFailure, SimulatedDeviceLoss
from .controller import ControllerConfig, MorpheusController
from .engine import EngineConfig, MorpheusEngine
from .execcache import ExecutableCache, batch_key
from .histogram import StreamingHistogram
from .passes.batch_shape import plan_batch_shape
from .snapshot import TableSnapshotWorker, VersionedSnapshot
from .specialize import SpecializationPlan
from .state import PlaneState
from .tables import TableSet


def _device_put(batch: Dict[str, Any], device: torch.device,
                split: Optional[Dict[str, Tuple[int, Sequence]]] = None
                ) -> Dict[str, torch.Tensor]:
    """Move every leaf of one batch to ``device`` (numpy leaves are
    copied into tensors); a leaf named in ``split`` (field -> (dim,
    devices)) is cut into blocks along ``dim`` instead, block i on the
    i-th device.  Every batch placement the runtime performs goes through
    this one function, so tests can count them.  A pageable host tensor
    is staged by the copy itself, so the caller may drop it as soon as
    this returns."""
    out = {}
    for k, v in batch.items():
        t = (compat.to_home(v, device) if isinstance(v, Sharded)
             else v if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.array(v)))
        if split and k in split:
            dim, devices = split[k]
            out[k] = compat.split(t, devices, dim)
        else:
            out[k] = t.to(device, non_blocking=True)
    return out


def stack_batches(batches: Sequence[Dict[str, Any]]
                  ) -> Dict[str, torch.Tensor]:
    """Stack K same-shaped batches into one batch with a leading window
    axis: the input of :meth:`MorpheusRuntime.step_many`'s fused
    executable.  Tensors stack on their own device; other leaves (numpy)
    stack on the host as numpy, to be placed in one transfer.
    :meth:`MorpheusRuntime.place_batch` with ``fused=True`` also places
    the stack ahead of dispatch."""
    out = {}
    for f in batches[0]:
        xs = [b[f] for b in batches]
        out[f] = (torch.stack(xs)
                  if all(isinstance(x, torch.Tensor) for x in xs)
                  else np.stack([np.asarray(x) for x in xs]))
    return out


def _template(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A shape/dtype template of a batch: ``device="meta"`` tensors,
    which hold no storage and key as the batch they stand for."""
    return {f: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for f, v in batch.items()}


def _induced_window_avals(plan, fused_shapes):
    """Window shapes a batch-shape-selecting plan will *induce*: when
    :class:`~repro_torch.core.passes.batch_shape.BatchShapePass` planned
    ``(buckets, K)``, the batcher forms ``(bucket, k=1)`` windows for
    every pad bucket plus ``(primary, 2..K)`` overflow chunks, shapes
    traffic may not have shown yet.  Their templates come from the most
    recently served window structure by resizing the two leading
    (window, batch) axes; returns ``[((bkey, k), template), ...]`` for
    the recompile cycle to precompile beside the shapes already served."""
    sel = plan_batch_shape(plan)
    if sel is None or not fused_shapes:
        return []
    buckets, kk = sel
    primary = buckets[-1]
    want = [(b, 1) for b in buckets]
    want += [(primary, j) for j in range(2, max(kk, 1) + 1)]
    _, template = fused_shapes[-1]          # MRU structure
    if any(v.dim() < 2 for v in template.values()):
        return []                           # not a stacked batch
    out = []
    for b, j in want:
        t = {f: torch.empty((j, b) + tuple(v.shape[2:]), dtype=v.dtype,
                            device="meta") for f, v in template.items()}
        out.append(((batch_key(t), j), t))
    return out


@dataclass
class RuntimeStats:
    """Counters, timing histories and latency histograms of one runtime
    (all host-side).  Every write goes through :meth:`bump`, :meth:`log`
    or :meth:`observe` / :meth:`observe_many` under one internal lock;
    :meth:`snapshot` returns a consistent plain-dict copy (what
    ``controller.stats()`` aggregates across planes).  Latency
    distributions (the serving frontend's per-request queue / batch /
    execute / total times) are named
    :class:`~repro_torch.core.histogram.StreamingHistogram` series in
    ``hists``."""
    steps: int = 0
    deopt_steps: int = 0          # routed to generic by the program guard
    instr_steps: int = 0
    recompiles: int = 0
    swaps: int = 0
    revalidations: int = 0        # cycles that only restamped the version
    cache_hits: int = 0           # executables served from the exec cache
    cache_misses: int = 0         # executables that had to be built
    queued_updates: int = 0
    batch_transfers: int = 0      # batch placements onto the device
    # ---- request-level accounting (repro_torch.serving.frontend) ----
    requests_submitted: int = 0
    requests_rejected: int = 0    # admission control: bounded queue full
    requests_shed: int = 0        # deadline expired before dispatch
    requests_completed: int = 0
    slo_met: int = 0              # completed with deadline, in time
    slo_missed: int = 0           # completed with deadline, late
    batches_formed: int = 0
    pad_rows: int = 0             # padding rows dispatched (occupancy)
    shape_mispredicts: int = 0    # batches whose ideal pad bucket was
                                  # not in the active plan's bucket set
    locked_calls: int = 0         # stats-lock acquisitions: at most one
                                  # per step or fused window
    # ---- fleet health (repro_torch.core.controller.health) ----
    faults: int = 0               # dispatch-layer faults survived
    degraded_steps: int = 0       # steps served generic-only (degraded)
    recoveries: int = 0           # degraded -> specialized swaps
    straggler_events: int = 0     # StragglerMonitor mitigations fired
    requests_rejected_degraded: int = 0   # admissions shed PLANE_DEGRADED
    requests_failed: int = 0      # in-flight requests lost to a fault
    t1_history: List[float] = field(default_factory=list)
    t2_history: List[float] = field(default_factory=list)
    swap_history: List[float] = field(default_factory=list)
    pass_stats: Dict[str, int] = field(default_factory=dict)
    snapshot_versions: List[int] = field(default_factory=list)
    hists: Dict[str, StreamingHistogram] = field(default_factory=dict)

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

    def observe(self, name: str, value: float, **counters: int) -> None:
        """Record one sample into the named histogram (created on first
        use), bumping ``counters`` in the same lock acquisition."""
        self.observe_many({name: (value,)}, **counters)

    def observe_many(self, series: Dict[str, Sequence[float]],
                     **counters: int) -> None:
        """Record many samples across several histograms plus scalar
        counter deltas in ONE lock acquisition: the serving frontend
        reports a whole fused window this way."""
        with self._lock:
            self.locked_calls += 1
            for name, values in series.items():
                h = self.hists.get(name)
                if h is None:
                    h = self.hists[name] = StreamingHistogram()
                h.observe_all(values)
            for cname, d in counters.items():
                setattr(self, cname, getattr(self, cname) + d)

    def quantile(self, name: str, q: float) -> float:
        """The q-quantile of the named histogram (NaN when absent)."""
        with self._lock:
            h = self.hists.get(name)
            return h.quantile(q) if h is not None else float("nan")

    def hist(self, name: str) -> Optional[StreamingHistogram]:
        """A consistent copy of the named histogram, or None."""
        with self._lock:
            h = self.hists.get(name)
            return h.copy() if h is not None else None

    def reset_hist(self, *names: str) -> None:
        """Drop the named histogram series (e.g. a warm-up's)."""
        with self._lock:
            for name in names:
                self.hists.pop(name, None)

    def snapshot(self) -> Dict[str, Any]:
        """A consistent plain-dict copy of every field (lists and dicts
        shallow-copied, histograms reduced to their ``summary()``)."""
        with self._lock:
            out: Dict[str, Any] = {}
            for f in dataclasses.fields(self):
                v = getattr(self, f.name)
                if f.name == "hists":
                    v = {k: h.summary() for k, h in v.items()}
                elif isinstance(v, list):
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
        self.mesh = self.engine.mesh
        self._batch_sh_cache: Dict[Any, Dict] = {}
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

        self.params = self.engine.place_params(params)
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
        self._window_seq = 0          # fused-window ordinal
        # fused executables of the current generation, cleared by every
        # committed writer (see _fused_exec)
        self._fused_memo: Dict[Any, Callable] = {}
        # the most recent (window structure, K) pairs step_many served,
        # as templates: recompile cycles build their fused executables
        # beside the single-step twins.  LRU-bounded, so a cycle's work
        # does not grow with every structure ever seen.
        self._fused_shapes: "OrderedDict[Any, Dict]" = OrderedDict()
        self._fused_shapes_cap = 8
        self._warm_threads: List[threading.Thread] = []
        self._recompile_mutex = threading.Lock()
        self._compiling = False
        self._queued: List[tuple] = []
        self._closed = False
        # ---- fleet health (dispatch fault boundary) ----
        # `_degraded` flips only under _write() (so every claim's
        # generation check observes it); while set, dispatch is
        # generic-only whatever the guard says.  `_fault_injector` is the
        # chaos hook: its check runs inside the step's try block BEFORE
        # the executable, so an injected fault aborts the claim with the
        # state untouched and the same batch can be retried.
        self._degraded = False
        self._degrade_reason: Optional[str] = None
        self._fault_injector: Optional[Any] = None
        self._compile_faults = 0      # armed recompile-cycle failures
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
        # a K=1 window of this structure may take the step() path; any
        # other structure (a frontend pad bucket) takes the fused one
        self._example_bkey = batch_key(example_batch)
        # optional traffic-profile source (the serving frontend's
        # ArrivalProfile), read at each recompile cycle: attach_profile
        self._traffic_profile: Optional[Any] = None

        self._backbuf = instrument.SketchDoubleBuffer()
        self._backbuf.publish(self.state.instr)

    # ---- batch placement -----------------------------------------------
    def _batch_split(self, batch, stacked: bool):
        """The (cached) split of a batch structure over the mesh: field
        -> (dim, shard devices) for the leaves whose batch dim divides
        (``distributed.sharding.plane_batch_shardings``)."""
        key = (batch_key(batch), stacked)
        sp = self._batch_sh_cache.get(key)
        if sp is None:
            specs = plane_batch_shardings(batch, self.mesh,
                                          self.engine.cfg.instr_axes,
                                          stacked=stacked)
            devs = self.engine.shard_devices
            sp = {k: (len(s) - 1, devs) for k, s in specs.items() if s}
            self._batch_sh_cache[key] = sp
        return sp

    def _resident(self, batch, split) -> bool:
        """True when every leaf already lies where this placement puts
        it: a split leaf as blocks on the shard devices, any other as a
        tensor on the (home) device."""
        for k, v in batch.items():
            if k in split:
                dim, devs = split[k]
                if not (isinstance(v, Sharded) and v.dim == dim
                        and v.devices == tuple(devs)):
                    return False
            elif not (isinstance(v, torch.Tensor)
                      and v.device == self.device):
                return False
        return True

    def _place_batch(self, batch, *, stacked: bool = False,
                     count: Optional[dict] = None):
        """Place a request batch (or, ``stacked``, a fused window) on the
        runtime's device, or split it over the mesh's data shards; numpy
        leaves are copied into tensors.  A batch already placed so is
        returned as is, so a placed batch is never placed again.
        ``count`` receives a ``transfers`` delta: one per batch placed,
        whatever its number of fields."""
        split = (self._batch_split(batch, stacked)
                 if self.mesh is not None else {})
        if self._resident(batch, split):
            return batch
        if count is not None:
            count["transfers"] = count.get("transfers", 0) + 1
        return _device_put(batch, self.device, split)

    def place_batch(self, batch, *, fused: bool = False):
        """Place ``batch`` on the device ahead of dispatch.  With
        ``fused=True``, ``batch`` may be a *sequence* of K per-step
        batches: they are stacked along a leading window axis, the input
        :meth:`step_many` takes.  A placed batch passes through
        untouched, so prefetching or re-stepping it moves nothing."""
        if fused and isinstance(batch, (list, tuple)):
            batch = stack_batches(batch)
        count: dict = {}
        placed = self._place_batch(batch, stacked=fused, count=count)
        if count:
            self.stats.bump(batch_transfers=count["transfers"])
        return placed

    # ---- executable cache --------------------------------------------
    @property
    def plan(self) -> SpecializationPlan:
        """The active plan (read from the atomic ``_active`` tuple)."""
        return self._active[0]

    @property
    def exec(self) -> Callable:
        """The active specialized executable."""
        return self._active[1]

    @property
    def instr_exec(self) -> Callable:
        """The active instrumented twin (the specialized executable
        itself while the sampler has instrumentation disarmed)."""
        return self._active[2]

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
                  instr_struct: Tuple[str, ...],
                  fuse: Optional[int] = None):
        """Cache key: the plan's *signature* (or its version-stamped
        ``key`` when ``EngineConfig.signature_cache`` is off) × batch
        structure × the instr structure, and ``fuse=K`` for the fused
        K-step window."""
        pkey = (plan.signature if self.engine.cfg.signature_cache
                else plan.key)
        return ExecutableCache.make_key(self._cache_ns,
                                        (pkey, instr_struct),
                                        batch_key(batch), fuse=fuse)

    def _get_many(self, plans: List[SpecializationPlan], batch,
                  instr_struct: Tuple[str, ...],
                  fuse: Optional[int] = None) -> List[Callable]:
        """Fetch one executable per plan (the fused K-step window with
        ``fuse=K``), building the misses through the cache's in-flight
        dedup."""
        out = []
        for plan in plans:
            key = self._exec_key(plan, batch, instr_struct, fuse=fuse)
            exe = self.exec_cache.probe(key)
            if exe is not None:
                self.stats.bump(cache_hits=1)
            else:
                exe, t2 = self.exec_cache.get_or_compile(
                    key, lambda plan=plan: self.engine.compile(
                        plan, self.state, fuse=fuse))
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
                # clear BEFORE bumping: a lock-free step_many reader that
                # sees the new generation must already see the memo empty
                self._fused_memo = {}
                self._gen += 1
            finally:
                self._writers -= 1
                self._cond.notify_all()

    def _begin_step(self, expect_gen: Optional[int] = None):
        """Claim the single in-flight step slot (brief critical section).
        Returns ``(gen, active_tuple, state)``, or None when
        ``expect_gen`` no longer matches: work prepared outside the lock
        (a fused executable fetched for the active plan) is committed to
        only if no writer landed in between, else the caller retries."""
        with self._cond:
            while self._stepping or self._writers:
                self._cond.wait()
            if expect_gen is not None and self._gen != expect_gen:
                return None
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
        self._fused_memo = {}        # cleared before the bump, as in _write
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
        # degraded mode first, then the program guard: a faulted plane
        # serves generic-only until a re-specialization clears the flag
        if self._degraded:
            exec_ = generic_exec
            deltas["degraded_steps"] = 1
        elif self.tables.version != plan.version:
            exec_ = generic_exec
            deltas["deopt_steps"] = 1
        elif self.enable and self.sampler.should_sample(self._step_seq):
            exec_ = instr_exec
            sampled = True
            deltas["instr_steps"] = 1
        else:
            exec_ = spec_exec
        try:
            # the chaos hook fires before the executable; either way the
            # abort below commits nothing, so the batch can be retried
            if self._fault_injector is not None:
                self._fault_injector.check(self._step_seq)
            out, new_state = exec_(self.params, state, batch)
        except BaseException as e:
            self._abort_step()
            if isinstance(e, Exception):
                self._on_step_fault(e)
            raise
        self._commit_step(gen, new_state, sampled, deltas)
        return out

    def step_many(self, batches, k: Optional[int] = None):
        """Run a fused window of K serving steps through ONE executable;
        returns the stacked outputs (leading axis K).  ``batches`` is a
        sequence of K same-shaped batches, or a pre-stacked (and maybe
        pre-placed) batch from :meth:`place_batch` with ``fused=True``,
        in which case ``k`` is REQUIRED and checked against every leaf's
        leading axis: a plain per-step batch cannot be told from a
        stacked window by its shape, and stepping over its batch
        dimension would serve wrong outputs without an error.

        One claim/commit pair and one locked stats call serve the whole
        window.  The program guard and the sampling decision are hoisted
        to the window: it runs specialized, instrumented or (guard
        tripped) generic as a whole, and a control update landing
        mid-window is queued and drained at the window's commit, so the
        *next* window deopts.  Outputs equal K single steps' bit for
        bit."""
        if isinstance(batches, (list, tuple)):
            if k is not None and k != len(batches):
                raise ValueError(
                    f"step_many: k={k} but {len(batches)} batches given")
            k = len(batches)
            stacked = stack_batches(batches)
        else:
            if k is None:
                raise TypeError(
                    "step_many(stacked_batch) needs an explicit k= "
                    "(window size): pass the sequence of per-step "
                    "batches instead, or the output of "
                    "place_batch(batches, fused=True) together with "
                    "k=len(batches)")
            stacked = batches
            lead = {int(v.shape[0]) for v in stacked.values()}
            if lead != {k}:
                raise ValueError(
                    f"step_many: leading axes {sorted(lead)} do not "
                    f"match the window size k={k}")
        if k == 1:
            # nothing to amortize: the single-step path, restacked so the
            # output keeps its (K, ...) shape.  Only for the example
            # batch's structure: a frontend pad bucket takes the fused
            # machinery, which builds and caches per structure.
            single = {f: (v.select(0) if isinstance(v, Sharded)
                          else torch.as_tensor(v)[0])
                      for f, v in stacked.items()}
            if batch_key(single) == self._example_bkey:
                return self.step(single)[None]
        cnt: dict = {}
        stacked = self._place_batch(stacked, stacked=True, count=cnt)
        with self._cond:
            # the window ordinal drives the sampling cadence: two
            # concurrent callers never share (and both sample) one
            self._window_seq += 1
            window = self._window_seq
        while True:
            # prepare OUTSIDE any lock: read the active world, pick the
            # window's role and fetch (maybe build) its executable, then
            # claim with generation validation; retry if a writer landed
            gen = self._gen
            plan = self._active[0]
            isites = self._active_isites
            deltas = {"steps": k}
            if cnt:
                deltas["batch_transfers"] = cnt["transfers"]
            sampled = False
            if self._degraded:
                # read lock-free: the flag flips only under _write(),
                # which bumps the generation, so a stale read fails the
                # claim below and retries
                role_plan = self.generic_plan
                deltas["degraded_steps"] = k
            elif self.tables.version != plan.version:
                role_plan = self.generic_plan
                deltas["deopt_steps"] = k
            elif (self.enable and self.sampler.should_sample_window(
                    window, k)):
                role_plan = self._instr_twin(plan, isites)
                sampled = True
                deltas["instr_steps"] = k
            else:
                role_plan = plan
            fexec, mkey = self._fused_exec(role_plan, stacked, isites, k)
            claim = self._begin_step(expect_gen=gen)
            if claim is not None:
                break
        gen, _, state = claim
        # memoize only now: the claim validated the generation and
        # writers wait while the slot is held, so the entry belongs to
        # the current world
        self._fused_memo[mkey] = fexec
        try:
            if self._fault_injector is not None:
                self._fault_injector.check(self._step_seq)
            out, new_state = fexec(self.params, state, stacked)
        except BaseException as e:
            self._abort_step()
            if isinstance(e, Exception):
                self._on_step_fault(e)
            raise
        self._commit_step(gen, new_state, sampled, deltas)
        return out

    def warm_fused(self, batches, k: Optional[int] = None) -> None:
        """Build the K-step fused executables of a window structure AHEAD
        of serving (the active plan, its instrumented twin and the
        generic deopt target) and register the structure, so recompile
        cycles keep its fused variants built.  A serving frontend calls
        this once per pad bucket: the first real window (sampled or not,
        deopted or not) then builds nothing inline."""
        if isinstance(batches, (list, tuple)):
            k = len(batches)
            stacked = stack_batches(batches)
        else:
            if k is None:
                raise TypeError("warm_fused(stacked_batch) needs k=")
            stacked = batches
        stacked = self._place_batch(stacked, stacked=True)
        self._register_fused_shape(batch_key(stacked), k, stacked)
        isites = self._active_isites
        plan = self._active[0]
        wanted = [plan, self._instr_twin(plan, isites),
                  self.generic_plan,
                  self._instr_twin(self.generic_plan, isites)]
        self._get_many(wanted, stacked, isites, fuse=k)

    def _register_fused_shape(self, bkey, k: int, stacked) -> None:
        """First sight of a (window structure, K): record its template
        (recompile cycles build fused executables for every registered
        structure) and build the fused generic deopt target in the
        background, so the first guard-tripped window after a control
        update builds nothing inline.  Called only on a memo miss."""
        warm = None
        with self._cond:         # the recompile cycle iterates this map
            if (bkey, k) in self._fused_shapes:
                self._fused_shapes.move_to_end((bkey, k))
            else:
                self._fused_shapes[(bkey, k)] = _template(stacked)
                while len(self._fused_shapes) > self._fused_shapes_cap:
                    self._fused_shapes.popitem(last=False)
                warm = threading.Thread(
                    target=self._warm_fused_generic,
                    args=(self._fused_shapes[(bkey, k)], k),
                    name="morpheus-warm-fused", daemon=True)
                # keep the list bounded; close() joins what still runs
                self._warm_threads = [t for t in self._warm_threads
                                      if t.is_alive()]
                self._warm_threads.append(warm)
        if warm is not None:
            warm.start()

    def _warm_fused_generic(self, template, k: int) -> None:
        """Background build of the fused generic executable for a newly
        seen (window structure, K), through the cache's in-flight dedup
        and outside the serving counters (it is insurance, not a Morpheus
        cycle)."""
        key = self._exec_key(self.generic_plan, template,
                             self._active_isites, fuse=k)
        if self.exec_cache.peek(key) is None:
            self.exec_cache.get_or_compile(
                key, lambda: self.engine.compile(self.generic_plan,
                                                 self.state, fuse=k))

    def _fused_exec(self, plan: SpecializationPlan, stacked,
                    instr_struct: Tuple[str, ...], k: int
                    ) -> Tuple[Callable, Any]:
        """Fetch (or build) the K-step fused executable for ``plan``;
        returns ``(exe, memo_key)``.  A steady window pays one dict probe
        (no cache lock, no stats lock); every committed writer clears the
        memo, so a swap or control update forces a probe of the shared
        cache.  The *caller* memoizes after a validated claim, never
        here, where a racing writer could let a stale executable outlive
        its generation."""
        bkey = batch_key(stacked)
        mkey = (plan.signature, bkey, k)
        exe = self._fused_memo.get(mkey)
        if exe is not None:
            return exe, mkey
        # memo miss (first window, or a writer just landed): the slow
        # lane, and the moment to register the structure
        self._register_fused_shape(bkey, k, stacked)
        exe = self._get_many([plan], stacked, instr_struct, fuse=k)[0]
        return exe, mkey

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
        *back* buffer with no runtime lock held.  On a mesh the shards'
        sketches are merged on the device first, so the pass registry
        sees one global traffic snapshot whatever the topology."""
        instr = self._backbuf.read()
        if self.mesh is not None:
            instr = {sid: (instrument.merge_on_device(st, self.mesh)
                           if instrument.n_shards(st) is not None else st)
                     for sid, st in instr.items()}
        return {sid: {k: v.cpu().numpy() for k, v in st.items()}
                for sid, st in instr.items()}

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
        tables.update(self.engine.place_tables(
            {name: self.tables[name].device_arrays(self.device)}))
        self.state = self.state.replace(tables=tables)

    def _apply_update(self, name, fields, n_valid):
        with self._write():
            self._apply_update_locked(name, fields, n_valid)
        self.controller.notify_update(self)

    def attach_profile(self, profile) -> None:
        """Attach a traffic-profile source: any object with a
        ``snapshot() -> dict`` method, canonically the serving frontend's
        :class:`~repro_torch.serving.frontend.ArrivalProfile`.  Every
        recompile cycle reads one snapshot into ``PlanInputs.profile``,
        so plan-level passes such as
        :class:`~repro_torch.core.passes.batch_shape.BatchShapePass`
        specialize against request-level dynamics.  ``None`` detaches."""
        self._traffic_profile = profile

    def set_feature(self, name: str, value: bool) -> None:
        """Flip a control-plane feature flag.  Bumps the table version:
        flags are control-plane state, so the program guard deopts any
        executable built with the old pinning."""
        self.engine.cfg.features[name] = value
        self.tables.bump_version(f"flag:{name}")
        self.controller.notify_update(self)

    # ---- fleet health: the dispatch fault boundary ---------------------
    @property
    def degraded(self) -> bool:
        """True while this plane serves generic-only after a fault."""
        return self._degraded

    @property
    def degrade_reason(self) -> Optional[str]:
        return self._degrade_reason

    def set_fault_injector(self, injector) -> None:
        """Attach a chaos hook (:class:`~repro_torch.distributed.fault.\
FailureInjector`): its ``check(step)`` runs inside every step's or
        window's try block before the executable, so an injected fault
        exercises the real abort/degrade/recover path.  ``None``
        detaches."""
        self._fault_injector = injector

    def arm_compile_faults(self, n: int = 1) -> None:
        """Make the next ``n`` recompile cycles raise a
        :class:`~repro_torch.distributed.fault.SimulatedCompileFailure`
        right after planning, exercising the scheduler's backoff retry
        and, past ``max_retries``, the signature quarantine."""
        self._compile_faults += n

    def degrade_to_generic(self, reason: str) -> None:
        """Swap this plane to generic-only dispatch (the deopt target
        doubles as the fault-survival mode) until a re-specialization
        cycle clears the flag.  The flip happens under the write side of
        the seqlock, so dispatch work prepared against the healthy world
        fails its claim check and retries into the degraded path."""
        with self._write():
            self._degraded = True
            self._degrade_reason = str(reason)
        self.stats.bump(faults=1)
        try:
            self.controller.on_plane_fault(self, reason)
        except Exception:
            pass        # the fault path must survive a closed controller

    def simulate_device_loss(self, reason: str = "device-loss") -> None:
        """Fault path for a lost device: shrink the plane to one device.
        Without a mesh there is nothing to shrink: the plain degrade.  On
        a mesh, under one write-side quiesce and serialized against
        recompile cycles (so no cycle swaps old-mesh code back in): the
        LIVE state — RW tables included, whose truth is on the device —
        is pulled to the host byte for byte and placed on the mesh's home
        device, the shards' sketches merged into one; the mesh is
        dropped, the executable-cache namespace rotated (cache keys do
        not carry the mesh, and old-placement executables must never
        serve the shrunk plane), a single-device generic pair is built
        and swapped in, and the plane degraded."""
        if self.mesh is None:
            self.degrade_to_generic(reason)
            return
        with self._recompile_mutex:
            with self._write():
                home = self.device

                def moved(v):       # host copy, byte for byte, then home
                    return torch.from_numpy(np.array(np.asarray(v))).to(
                        home)

                st = self.state
                self.state = PlaneState(
                    {n: {f: moved(v) for f, v in t.items()}
                     for n, t in st.tables.items()},
                    {s: {k: moved(v)
                         for k, v in instrument.merge_shards(x).items()}
                     for s, x in st.instr.items()},
                    {n: moved(g) for n, g in st.guards.items()})
                self.params = compat.local(self.params, 0, home)
                self._example_batch = {
                    k: compat.to_home(v, home)
                    for k, v in self._example_batch.items()}
                self.engine.set_mesh(None)
                self.mesh = None
                self._batch_sh_cache = {}
                self._cache_ns = f"{self._cache_ns}@shrunk"
                isites = tuple(sorted(self.state.instr.keys()))
                # build the new placement's generic pair inline: the
                # plane has nothing safe to serve until it lands
                gen_exec, gen_instr = self._get_many(
                    [self.generic_plan,
                     self._instr_twin(self.generic_plan, isites)],
                    self._example_batch, isites)
                self.generic_instr_exec = gen_instr
                self._active = (self.generic_plan, gen_exec, gen_instr,
                                gen_exec)
                self._active_isites = isites
                self._backbuf.publish(self.state.instr)
                self._degraded = True
                self._degrade_reason = str(reason)
        self.stats.bump(faults=1)
        try:
            self.controller.on_plane_fault(self, reason)
        except Exception:
            pass

    def _on_step_fault(self, exc: Exception) -> None:
        """A step or window raised: route the plane into degraded mode.
        Runs AFTER ``_abort_step`` released the slot (so the degrade's
        write-side wait cannot deadlock on our own claim) and never
        masks the original exception."""
        if self._closed:
            return
        try:
            if isinstance(exc, SimulatedDeviceLoss):
                self.simulate_device_loss(f"device-loss: {exc!r}")
            else:
                self.degrade_to_generic(f"step-fault: {exc!r}")
        except Exception:
            pass

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
            src = self._traffic_profile
            profile = src.snapshot() if src is not None else None
            if profile is not None:
                # the pass applies hysteresis against the shape actually
                # serving, so a selection hovering at a bucket edge does
                # not flip the plan signature every cycle
                profile["prev_shape"] = plan_batch_shape(self._active[0])
            plan, t1, pass_stats = self.engine.build_plan(
                instr, snapshot=snap.tables, version=snap.version,
                profile=profile)
            self.stats.log("t1_history", t1)
            self.stats.pass_stats = pass_stats
            # recorded BEFORE any failure below: the scheduler's give-up
            # hook quarantines exactly the signature whose cycle died
            self._last_plan_signature = plan.signature
            if self._compile_faults > 0:      # chaos: injected failure
                self._compile_faults -= 1
                raise SimulatedCompileFailure("injected recompile failure")
            if self.exec_cache.is_quarantined(plan.signature):
                # poisoned signature: never re-attempted, keep serving; a
                # degraded plane drops back to DEGRADED (the schedule
                # gate had flipped it RECOVERING)
                if self._degraded:
                    try:
                        self.controller.on_plane_fault(
                            self, "quarantined plan signature")
                    except Exception:
                        pass
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
                recovered = False
                with self._write():
                    self._active = (
                        dataclasses.replace(active_plan,
                                            version=plan.version),
                        active_exec, active_instr, active_generic)
                    self.state = self.state.replace(
                        instr=fresh_instr, guards=fresh_guards)
                    self._backbuf.publish(fresh_instr)
                    if self._degraded:      # the code is validated
                        self._degraded = False    # afresh: recovered
                        self._degrade_reason = None
                        recovered = True
                deltas = {"revalidations": 1, "recompiles": 1}
                if recovered:
                    deltas["recoveries"] = 1
                self.stats.bump(**deltas)
                if recovered:
                    self.controller.on_plane_recovered(self)
                self._steps_at_cycle = self.stats.steps
                return {"t1": t1, "pass_stats": pass_stats,
                        "plan": self.plan.label,
                        "n_sites": len(plan.sites), "revalidated": True,
                        "recovered": recovered}

            wanted = [plan, self._instr_twin(plan, isites)]
            if isites != self._active_isites:
                # the instr topology changed: refresh the deopt targets
                wanted += [self.generic_plan,
                           self._instr_twin(self.generic_plan, isites)]
            execs = self._get_many(wanted, self._example_batch, isites)
            # the fused variants of every window structure step_many has
            # served, and of those the NEW plan's batch shape induces,
            # built here so a post-swap window builds nothing inline
            with self._cond:     # step_many registers entries under it
                fused_shapes = list(self._fused_shapes.items())
            done = {sk for sk, _ in fused_shapes}
            for sk, tmpl in _induced_window_avals(plan, fused_shapes):
                if sk not in done:
                    done.add(sk)
                    fused_shapes.append((sk, tmpl))
            for (_, k), tmpl in fused_shapes:
                fused_wanted = [plan, self._instr_twin(plan, isites)]
                if isites != self._active_isites:
                    fused_wanted.append(self.generic_plan)
                self._get_many(fused_wanted, tmpl, isites, fuse=k)
            new_generic = execs[2] if len(execs) > 2 else active_generic
            new_generic_instr = (execs[3] if len(execs) > 3
                                 else self.generic_instr_exec)
            t0 = time.time()
            recovered = False
            with self._write():
                # ATOMIC swap: one reference assignment replaces the tuple
                self._active = (plan, execs[0], execs[1], new_generic)
                self.generic_instr_exec = new_generic_instr
                self._active_isites = isites
                self.state = self.state.replace(
                    instr=fresh_instr, guards=fresh_guards)
                self._backbuf.publish(fresh_instr)
                if self._degraded:      # specialized code is back
                    self._degraded = False
                    self._degrade_reason = None
                    recovered = True
            self.stats.log("swap_history", time.time() - t0)
            deltas = {"recompiles": 1, "swaps": 1}
            if recovered:
                deltas["recoveries"] = 1
            self.stats.bump(**deltas)
            if recovered:
                self.controller.on_plane_recovered(self)
            self._steps_at_cycle = self.stats.steps
            return {"t1": t1, "pass_stats": pass_stats,
                    "plan": plan.label, "n_sites": len(plan.sites),
                    "revalidated": False, "recovered": recovered}
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
        # fused-generic builds in flight must not outlive the teardown
        for t in self._warm_threads:
            t.join(timeout=60.0)
        if self._private_controller:
            self.controller.close()
        else:
            self.controller.unregister(self.plane_id)
