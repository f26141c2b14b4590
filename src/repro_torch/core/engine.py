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
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import resolve_device
from . import instrument
from .ctx import DataPlaneCtx
from .instrument import SketchConfig
from .passes import PassRegistry, PlanInputs, default_registry
from .specialize import GENERIC_PLAN, SpecializationPlan, plan_constants
from .state import PlaneState
from .tables import TableSet, analysis_sites, analyzing, \
    reset_site_counters


@dataclass
class EngineConfig:
    """Static configuration of one :class:`MorpheusEngine` (single
    device; the reference's mesh options wait for the mesh slice)."""
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
        self.device = resolve_device(self.cfg.device)
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
        return {sid: instrument.init_site_state(self.cfg.sketch,
                                                self.device)
                for sid in sites}

    def init_guards(self):
        """Zeroed guards, one per RW table (§4.3.6): nonzero once the
        data plane writes the table."""
        return {name: torch.zeros((1,), dtype=torch.int32,
                                  device=self.device)
                for name, mut in self.mutability.items() if mut == "rw"}

    def init_state(self) -> PlaneState:
        """Fresh device state for this data plane (run analyze first)."""
        assert self._analyzed
        return PlaneState(self.tables.device_state(self.device),
                          self.init_instr_state(), self.init_guards())

    # ---- §4.2 + §4.3: read instrumentation, run the registry ---------------
    def build_plan(self, instr_state, instrumented: bool = False,
                   snapshot=None, version: Optional[int] = None
                   ) -> Tuple[SpecializationPlan, float, Dict]:
        """Plan a specialized executable from host copies of the
        instrumentation sketches (site id -> numpy sketch state) and a
        table snapshot.  ``snapshot``/``version`` inject a pre-taken
        snapshot and must be passed together: the plan is stamped with
        the snapshot's version, so a control update racing past it deopts
        the plan through the program guard.  Returns ``(plan,
        t1_seconds, pass_stats)``."""
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
            hot, cov, total = instrument.hot_keys(st, self.cfg.sketch)
            hot_stats[sid] = (hot, cov)

        inputs = PlanInputs(mutability=dict(self.mutability),
                            hot_stats=hot_stats, sketch=self.cfg.sketch,
                            features=dict(self.cfg.features))
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
        (``specialize.plan_constants``)."""
        def step(params, state: PlaneState, batch):
            reset_site_counters()
            ctx = DataPlaneCtx(plan, state, self.cfg.sketch, consts)
            with torch.no_grad():
                out = self.user_step(params, ctx, batch)
            return out, ctx.outputs()
        return step

    def compile(self, plan: SpecializationPlan,
                state: PlaneState) -> Tuple[Callable, float]:
        """Build the executable for ``plan``: materialize its device
        constants once against ``state``'s tables and close over them.
        Returns ``(executable, t2_seconds)``; call the executable as
        ``out, new_state = executable(params, state, batch)``."""
        t0 = time.time()
        consts = plan_constants(plan, state.tables, self.device)
        exe = self.make_step_fn(plan, consts)
        with self._count_lock:
            self.lower_count += 1
            self.compile_count += 1
        return exe, time.time() - t0
