"""The Morpheus compilation pipeline (§4, Fig. 3).

    analyze (offline, once)  ->  read instrumentation  ->  run the pass
    registry  ->  build the specialized executable  ->  hand it to the
    runtime for the atomic swap.

Timing mirrors Table 3: ``t1`` = table/sketch read + pass planning;
``t2`` = building the executable.

PyTorch runs eagerly, so an "executable" is a closure over one plan: it
runs the user step with a :class:`DataPlaneCtx` carrying that plan and
the plan's device constants (hot ids, inlined tables, constant rows),
which are materialized on the device once, when the executable is built.
``lower_count`` / ``compile_count`` count those builds, so the
reference's zero-rebuild checks carry over.  The step's contract is the
reference's::

    step(params, state: PlaneState, batch) -> (out, PlaneState)

and it never writes its input state.

Static analysis (§4.1) runs the user step once, eagerly, on the example
batch, with the generic plan, against a scratch copy of the tables,
recording every call site (the reference traces abstractly instead; here
group sizes and ``bincount`` are data-dependent, so the step really runs).

Sharded serving (``EngineConfig(mesh=)``): the engine spans a
:class:`~repro_torch.distributed.meshctx.Mesh`, driven by this one
process.  Tables and guards are :class:`~repro_torch.distributed.compat.\
Replicated` (one copy per distinct device), every sketch keeps one
block per data shard along ``instr_axes``, and the runtime places a
batch split on its leading dim (``distributed.sharding.\
plane_batch_shardings``).  The executable then runs the user step once
per data shard, in shard order, each on its own device with its slice of
the batch, its own sketch and its device's tables and constants; the
shards' outputs are gathered on the mesh's home device, their table
writes are applied in shard order to every replica (so the tables end as
one step over the whole batch leaves them), and a guard trips if any
shard wrote.  A batch that does not split evenly runs once, whole, on
the home device, recording through ``instrument.record_sharded``.
``mesh=None`` is the single-device engine, unchanged.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import resolve_device
from ..distributed import compat
from ..distributed.compat import Replicated, Sharded
from . import instrument
from .ctx import DataPlaneCtx, last_write_values
from .instrument import SketchConfig
from .passes import PassRegistry, PlanInputs, default_registry
from .specialize import GENERIC_PLAN, SpecializationPlan, plan_constants
from .state import PlaneState
from .tables import TableSet, analysis_sites, analyzing, \
    reset_site_counters


@dataclass
class EngineConfig:
    """Static configuration of one :class:`MorpheusEngine`.

    ``mesh`` switches the engine into sharded serving (module
    docstring): the device is then the mesh's, and ``device`` is not
    read.  ``instr_axes`` names the mesh axes the sketches and batches
    are split over."""
    sketch: SketchConfig = field(default_factory=SketchConfig)
    features: Dict[str, bool] = field(default_factory=dict)
    moe_router_table: Optional[str] = None   # table backing MoE routing
    ssd_state_table: Optional[str] = None    # table backing SSM state
    passes: Optional[PassRegistry] = None    # None => default_registry
    # --- executable cache (repro_torch.core.execcache) ---
    signature_cache: bool = True   # key executables by plan.signature
                                   # (False: by plan.key — every plan
                                   # churn rebuilds; benchmarks only)
    exec_cache_capacity: int = 64  # LRU entries when the runtime builds
                                   # its own ExecutableCache
    cache_ns: Optional[str] = None  # namespace inside a *shared* cache
    xla_cache_dir: Optional[str] = None  # the reference's persistent XLA
                                         # cache: no meaning here, raises
    device: str = "cuda"
    mesh: Optional[Any] = None               # a Mesh => sharded serving
    instr_axes: Tuple[str, ...] = ("data",)  # sketch/batch mesh axes

    @property
    def n_instr_shards(self) -> Optional[int]:
        """Per-site sketch count in sharded mode (None when unsharded)."""
        if self.mesh is None:
            return None
        return self.mesh.axes_size(self.instr_axes)


class MorpheusEngine:
    """Plans and builds specialized executables for one data plane."""

    def __init__(self, user_step: Callable, tables: TableSet,
                 cfg: Optional[EngineConfig] = None):
        self.user_step = user_step
        self.tables = tables
        self.cfg = cfg or EngineConfig()
        if self.cfg.xla_cache_dir is not None:
            raise ValueError(
                "EngineConfig.xla_cache_dir is the reference's persistent "
                "XLA compile cache and has no PyTorch counterpart")
        self.set_mesh(self.cfg.mesh)
        self.registry = (self.cfg.passes if self.cfg.passes is not None
                         else default_registry(self.cfg.moe_router_table,
                                               self.cfg.ssd_state_table))
        self.sites = []
        self.mutability: Dict[str, str] = {}
        self._analyzed = False
        # t2 counters: every executable this engine builds.  Incremented
        # under a lock: recompile cycles may run on worker threads.
        self.lower_count = 0
        self.compile_count = 0
        self._count_lock = threading.Lock()

    def set_mesh(self, mesh) -> None:
        """(Re)place the engine: ``mesh=None`` is one device,
        ``cfg.device``, or the home device of the mesh being dropped
        (the device-loss path)."""
        if mesh is None:
            old = self.cfg.mesh
            self.device = (old.home if old is not None
                           else resolve_device(self.cfg.device))
            self.shard_devices: Tuple[torch.device, ...] = ()
        else:
            self.device = mesh.home
            self.shard_devices = tuple(
                mesh.device_at(c)
                for c in mesh.shard_coords(self.cfg.instr_axes))
        self.cfg.mesh = mesh

    @property
    def mesh(self):
        return self.cfg.mesh

    # ---- mesh placement ----------------------------------------------------
    def place_tables(self, tables: Dict[str, Dict[str, torch.Tensor]]):
        """Table state as the engine serves it: replicated over the
        mesh's distinct devices (as is without a mesh)."""
        if self.mesh is None:
            return tables
        return {n: {f: compat.replicate(compat.to_home(v, self.device),
                                        self.shard_devices)
                    for f, v in t.items()} for n, t in tables.items()}

    def place_params(self, params):
        """Params replicated over the mesh's distinct devices: the
        caller's tree on its own device, a deep copy on every other (a
        repeated-device mesh holds the one tree).  As is without a
        mesh."""
        if self.mesh is None:
            return params
        import copy
        copies = {}
        for d in dict.fromkeys(self.shard_devices):
            copies[d] = (params if d == self.device
                         else copy.deepcopy(params).to(d))
        return Replicated(copies)

    # ---- §4.1 static code analysis ---------------------------------------
    def analyze(self, params, example_batch) -> Dict[str, Any]:
        """Offline static analysis (run once before anything else): run
        ``user_step`` once on the example batch to register every table
        call site, then classify tables RO/RW (any in-plane
        ``ctx.update`` makes a table RW; an explicit ``Table.mutability``
        annotation wins).  Returns ``{"n_sites", "mutability",
        "analyze_s"}``."""
        t0 = time.time()
        scratch = PlaneState(self.tables.device_state(self.device), {}, {})
        if self.mesh is not None:
            params = compat.local(params, 0, self.device)
            example_batch = {k: compat.to_home(v, self.device)
                             for k, v in example_batch.items()}
        with analyzing(), torch.no_grad():
            reset_site_counters()
            ctx = DataPlaneCtx(GENERIC_PLAN, scratch, self.cfg.sketch)
            self.user_step(params, ctx, example_batch)
        self.sites = analysis_sites()

        written = {s.table for s in self.sites if s.kind == "update"}
        for name, t in self.tables.tables.items():
            if t.mutability != "auto":
                self.mutability[name] = t.mutability
            else:
                self.mutability[name] = "rw" if name in written else "ro"
        self._analyzed = True
        return {"n_sites": len(self.sites),
                "mutability": dict(self.mutability),
                "analyze_s": time.time() - t0}

    # ---- state plumbing ----------------------------------------------------
    def instrumented_sites(self):
        """Lookup sites that get a sketch: instrumentation is on for the
        table and the table is too big to inline (§4.2 dim 1)."""
        out = []
        for s in self.sites:
            if s.kind != "lookup":
                continue
            t = self.tables[s.table]
            if t.instrument and t.n_valid > t.max_inline:
                out.append(s.site_id)
        return out

    def init_instr_state(self, sites=None):
        """Fresh sketch state per instrumented site (``sites`` pins the
        site set explicitly, as in the reference)."""
        if sites is None:
            sites = self.instrumented_sites()
        if self.mesh is not None:
            return {sid: instrument.init_site_state(
                self.cfg.sketch, self.shard_devices,
                len(self.shard_devices)) for sid in sites}
        return {sid: instrument.init_site_state(self.cfg.sketch,
                                                self.device)
                for sid in sites}

    def init_guards(self):
        """Zeroed guards, one per RW table (§4.3.6): nonzero once the
        data plane writes the table (replicated on a mesh)."""
        guards = {name: torch.zeros((1,), dtype=torch.int32,
                                    device=self.device)
                  for name, mut in self.mutability.items() if mut == "rw"}
        if self.mesh is None:
            return guards
        return {n: compat.replicate(g, self.shard_devices)
                for n, g in guards.items()}

    def init_state(self) -> PlaneState:
        """Fresh device state for this data plane (run analyze first)."""
        assert self._analyzed
        return PlaneState(
            self.place_tables(self.tables.device_state(self.device)),
            self.init_instr_state(), self.init_guards())

    # ---- §4.2 + §4.3: read instrumentation, run the registry ---------------
    def build_plan(self, instr_state, instrumented: bool = False,
                   snapshot=None, version: Optional[int] = None,
                   profile: Optional[Dict[str, Any]] = None
                   ) -> Tuple[SpecializationPlan, float, Dict]:
        """Plan a specialized executable from host copies of the
        instrumentation sketches (site id -> numpy sketch state; the
        runtime merges a mesh's shards first, and a sharded host copy is
        merged here as a fallback) and a table snapshot.
        ``snapshot``/``version`` inject a pre-taken snapshot and must be
        passed together: the plan is stamped with the snapshot's version,
        so a control update racing past it deopts the plan through the
        program guard.  ``profile`` is an optional request-level traffic
        snapshot (the serving frontend's arrival profile), exposed to
        plan-level passes as ``PlanInputs.profile``.
        Returns ``(plan, t1_seconds, pass_stats)``."""
        assert self._analyzed
        t0 = time.time()
        if snapshot is None:
            # read the version BEFORE copying: a racing update then makes
            # the plan look stale (spurious deopt, safe) rather than
            # fresher than its contents (unsafe)
            if version is None:
                version = self.tables.version
            snapshot = self.tables.snapshot()
        elif version is None:
            raise ValueError(
                "build_plan(snapshot=...) needs the snapshot's version= "
                "— stamping an injected snapshot with the live TableSet "
                "version would disable the deopt guard")
        hot_stats = {}
        for sid, st in (instr_state or {}).items():
            if instrument.n_shards(st) is not None:
                st = instrument.merge_shards(st)
            hot, cov, total = instrument.hot_keys(st, self.cfg.sketch)
            hot_stats[sid] = (hot, cov)

        inputs = PlanInputs(mutability=dict(self.mutability),
                            hot_stats=hot_stats, sketch=self.cfg.sketch,
                            features=dict(self.cfg.features),
                            profile=profile)
        draft = self.registry.build(self.sites, snapshot, inputs)
        specs = {sid: spec for sid, spec in draft.specs.items()
                 if spec is not None}

        plan = SpecializationPlan(
            version=version,
            sites=tuple(sorted(specs.items())),
            flags=dict(draft.flags),
            instrumented=instrumented,
            label="specialized" + ("+instr" if instrumented else ""),
        )
        return plan, time.time() - t0, dict(draft.stats)

    def generic_plan(self, instrumented: bool = False) -> SpecializationPlan:
        """The unspecialized plan at the TableSet's current version — the
        deopt target and the reference-semantics oracle."""
        return SpecializationPlan(
            version=self.tables.version, sites=(),
            flags={}, instrumented=instrumented,
            label="generic" + ("+instr" if instrumented else ""))

    # ---- step-function construction + build --------------------------------
    def make_step_fn(self, plan: SpecializationPlan,
                     consts: Optional[Dict] = None) -> Callable:
        """Wrap ``user_step(params, ctx, batch)`` into the
        ``step(params, state, batch) -> (out, state)`` contract.
        ``consts`` are the plan's device constants
        (``specialize.plan_constants``), per device on a mesh."""
        if self.mesh is not None:
            return self._make_mesh_step_fn(plan, consts)

        def step(params, state: PlaneState, batch):
            reset_site_counters()
            ctx = DataPlaneCtx(plan, state, self.cfg.sketch, consts)
            with torch.no_grad():
                out = self.user_step(params, ctx, batch)
            return out, ctx.outputs()
        return step

    def make_fused_step_fn(self, plan: SpecializationPlan, k: int,
                           consts: Optional[Dict] = None) -> Callable:
        """The fused K-step variant of :meth:`make_step_fn`: one
        executable runs K consecutive serving steps, threading the
        :class:`PlaneState` from each into the next (table writes,
        sketches and guards accumulate exactly as over K single steps).
        Every batch field carries a leading window axis of size K, and
        the step's output (a tensor) comes back stacked the same way.  It is a loop over
        the plan's one step closure where the reference has a
        ``lax.scan``, so a window's steps are the single step's
        arithmetic, bit for bit."""
        step = self.make_step_fn(plan, consts)

        def fused(params, state: PlaneState, batches):
            outs = []
            for j in range(k):
                out, state = step(params, state,
                                  {f: window_step(v, j)
                                   for f, v in batches.items()})
                outs.append(out)
            return torch.stack(outs), state
        return fused

    def default_shardings(self, state: PlaneState, batch, *,
                          stacked: bool = False):
        """The sharded-serving placement of ``(params, state, batch)`` as
        spec trees (``distributed.sharding``): params replicated, tables
        and guards replicated, sketches split over ``instr_axes``, the
        batch split on its leading dim — on the per-step dim under the
        window axis with ``stacked=True``.  Returns ``(in_specs,
        out_specs)``, the output's state placed as its input's, or
        ``(None, None)`` without a mesh.  This is the placement that
        :meth:`init_state` and the runtime give (its ``place_batch``
        splits the leaves that ``plane_batch_shardings`` splits), and
        the one an executable from :meth:`compile` takes and returns."""
        if self.mesh is None:
            return None, None
        from ..distributed.sharding import plane_batch_shardings, \
            plane_state_shardings
        axes = self.cfg.instr_axes
        state_sh = plane_state_shardings(state, self.mesh, axes)
        batch_sh = plane_batch_shardings(batch, self.mesh, axes,
                                         stacked=stacked)
        return ((), state_sh, batch_sh), (None, state_sh)

    def compile(self, plan: SpecializationPlan, state: PlaneState,
                fuse: Optional[int] = None) -> Tuple[Callable, float]:
        """Build the executable for ``plan``: materialize its device
        constants once against ``state``'s tables and close over them.
        ``fuse=K`` builds the fused K-step window instead.  Returns
        ``(executable, t2_seconds)``; call the executable as
        ``out, new_state = executable(params, state, batch)``."""
        t0 = time.time()
        if self.mesh is None:
            consts = plan_constants(plan, state.tables, self.device)
        else:
            consts = {d: plan_constants(plan, tables_on(state.tables, d), d)
                      for d in dict.fromkeys(self.shard_devices)}
        exe = (self.make_step_fn(plan, consts) if fuse is None
               else self.make_fused_step_fn(plan, fuse, consts))
        with self._count_lock:
            self.lower_count += 1
            self.compile_count += 1
        return exe, time.time() - t0

    # ---- the mesh executable -------------------------------------------
    def _make_mesh_step_fn(self, plan: SpecializationPlan,
                           consts: Optional[Dict]) -> Callable:
        """The sharded step (module docstring): per data shard when the
        batch arrives split (:class:`Sharded` leaves), else once over
        the whole batch on the home device."""
        devs, home = self.shard_devices, self.device

        def run(params, state: PlaneState, batch, i, dev, whole):
            reset_site_counters()
            writes: list = []
            local = PlaneState(
                tables_on(state.tables, dev),
                state.instr if whole else {
                    s: instrument.shard_local(st, i)
                    for s, st in state.instr.items()},
                {n: compat.local(g, i, dev)
                 for n, g in state.guards.items()})
            ctx = DataPlaneCtx(plan, local, self.cfg.sketch,
                               consts[dev] if consts else None,
                               mesh=self.mesh if whole else None,
                               instr_axes=self.cfg.instr_axes,
                               writes=writes)
            with torch.no_grad():
                out = self.user_step(compat.local(params, i, dev), ctx,
                                     {k: compat.local(v, i, dev)
                                      for k, v in batch.items()})
            return out, ctx, writes, local

        def step(params, state: PlaneState, batch):
            whole = not any(isinstance(v, Sharded) for v in batch.values())
            if whole:
                batch = {k: compat.to_home(v, home)
                         for k, v in batch.items()}
                out, ctx, writes, loc = run(params, state, batch, 0, home,
                                            True)
                outs, ctxs, logs, locs = [out], [ctx], [writes], [loc]
                instr = ctx.instr
            else:
                outs, ctxs, logs, locs = [], [], [], []
                for i, dev in enumerate(devs):
                    out, ctx, writes, loc = run(params, state, batch, i,
                                                dev, False)
                    outs.append(out)
                    ctxs.append(ctx)
                    logs.append(writes)
                    locs.append(loc)
                instr = {s: {k: Sharded([c.instr[s][k][None]
                                         for c in ctxs])
                             for k in st}
                         for s, st in state.instr.items()}
            out = _gather_outputs(outs, home)
            tables = dict(state.tables)
            for name in dict.fromkeys(w[0] for log in logs for w in log):
                tables[name] = self._apply_writes(state.tables[name],
                                                  name, logs)
            guards = {}
            for n, g in state.guards.items():
                got = [c.guards[n] for c in ctxs]
                if all(t is loc.guards[n] for t, loc in zip(got, locs)):
                    guards[n] = g
                else:          # a shard wrote the table: trip every copy
                    guards[n] = compat.replicate(
                        compat.pmax(got, home), devs)
            return out, PlaneState(tables, instr, guards)
        return step

    def _apply_writes(self, table: Dict[str, Replicated], name: str,
                      logs) -> Dict[str, Replicated]:
        """Every shard's logged writes to table ``name``, applied to each
        replica: the j-th write of every shard together, their rows in
        shard order with the last write to a row winning, as one write
        over the whole batch would."""
        per_shard = [[w for w in log if w[0] == name] for log in logs]
        n_writes = {len(w) for w in per_shard}
        if len(n_writes) != 1:
            raise RuntimeError(f"shards wrote table {name!r} a different "
                               f"number of times: {sorted(n_writes)}")
        out = {}
        for d in dict.fromkeys(self.shard_devices):
            fields = {f: v.on(d) for f, v in table.items()}
            for j in range(len(per_shard[0])):
                idx = torch.cat([w[j][1].to(d) for w in per_shard])
                for f in per_shard[0][j][2]:
                    vals = torch.cat([w[j][2][f].to(d) for w in per_shard])
                    t = fields[f]
                    fields[f] = t.index_put(
                        (idx.long(),),
                        last_write_values(idx, vals, t.shape[0]))
            for f, t in fields.items():
                out.setdefault(f, {})[d] = t
        return {f: Replicated(c) for f, c in out.items()}


def tables_on(tables, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Table state as plain tensors on ``device``: a replicated table's
    copy there (tables already plain are moved, a no-op in place)."""
    return {n: {f: compat.local(v, 0, device) for f, v in t.items()}
            for n, t in tables.items()}


def window_step(v, j: int):
    """Step ``j`` of a fused window's stacked batch leaf."""
    if isinstance(v, Sharded):
        return v.select(j)
    return v[j]


def _gather_outputs(outs, device):
    """The shards' outputs as one output on ``device``: tensors
    concatenated along the batch dim in shard order, dicts and tuples
    leaf by leaf."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return compat.all_gather(outs, 0, device)
    if isinstance(first, dict):
        return {k: _gather_outputs([o[k] for o in outs], device)
                for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_gather_outputs([o[i] for o in outs], device)
                           for i in range(len(first)))
    return first
