"""The differential specialized-vs-generic conformance driver.

Ported from ``repro.testing.conformance``.  ``run_conformance(arch_id,
mode, seed)`` builds TWO runtimes over identical tables and params for
one arch plane:

  * the **specialized** side: the full pass pipeline (MoE/SSD branch
    injection, traffic fast paths, data-structure specialization,
    inline JIT, dead code, guard elision), real sampling, real
    recompilation;
  * the **oracle**: a runtime whose registry holds ONLY the dead-code
    pass — every lookup dispatches as a plain gather, feature flags pin
    identically, and recompiles/version bumps mirror the specialized
    side's, so the two sides deopt to generic on exactly the same steps.

Both replay the same seeded churn schedule in lockstep; after every
serving step (or fused window, or frontend pump) the driver asserts
``torch.equal`` — bitwise equality — on the outputs AND on every table's
device state.  This is Morpheus' §5
semantic-equivalence obligation made mechanical: specialization may
change *how* a result is computed, never *what* is computed.

On the card both sides run the same CUDA kernels (``ssd_scan``,
``hot_gather``), and those kernels sum in a fixed order, so the
obligation holds there too.

Serving modes:

  plain     every ``step`` event is one ``runtime.step`` call
  fused     consecutive ``step`` events coalesce into ``step_many``
            windows (flushed at every control event, matching the
            window-granular guard)
  frontend  ``step`` events submit request rows to a
            :class:`~repro_torch.serving.frontend.ServingFrontend` on the
            specialized side; the windows its batcher ACTUALLY
            dispatches are captured (by wrapping ``step_many``) and
            replayed verbatim on the oracle, with frontend-originated
            version bumps (bucket-mispredict deopts) mirrored so guard
            windows stay aligned.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core import EngineConfig, MorpheusRuntime, PassRegistry
from ..core.passes.dead_code import DeadCodePass
from .archzoo import (ArchPlane, build_plane, build_params, build_tables,
                      conformance_engine_config, make_batch, make_step)
from .churn import ChurnEvent, generate_schedule
from .fingerprint import plan_fingerprint

PIN_EVERY = 2          # pinned instrumentation cadence (determinism)
FUSE_K = 3             # max fused-window depth in "fused" mode


class ConformanceError(AssertionError):
    """A specialized runtime diverged from its generic oracle."""


@dataclass
class Report:
    """What one conformance run observed (returned as a dict)."""
    arch: str
    mode: str
    seed: int
    events: int = 0
    steps: int = 0
    compares: int = 0
    recompiles: int = 0
    mispredicts: int = 0
    deopt_steps: int = 0
    impls_seen: Set[Tuple[str, str]] = field(default_factory=set)
    signature: Optional[str] = None

    def as_dict(self) -> Dict[str, Any]:
        d = self.__dict__.copy()
        d["impls_seen"] = sorted(self.impls_seen)
        return d


def _leaves(tree) -> List[torch.Tensor]:
    """Tensor leaves in a fixed order (dict keys sorted, as
    ``jax.tree.leaves`` orders them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [torch.as_tensor(tree)]


def _assert_equal(a, b, where: str) -> None:
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        raise ConformanceError(f"{where}: structure mismatch "
                               f"({len(la)} vs {len(lb)} leaves)")
    for i, (x, y) in enumerate(zip(la, lb)):
        if not torch.equal(x, y):
            bad = ((x != y).sum().item()
                   if x.shape == y.shape and x.dtype == y.dtype else "all")
            raise ConformanceError(
                f"{where}: leaf {i} differs ({bad} elements; "
                f"shapes {tuple(x.shape)} vs {tuple(y.shape)})")


def _assert_tables_equal(spec_rt, oracle_rt, where: str) -> None:
    for name, fields in spec_rt.state.tables.items():
        _assert_equal(fields, oracle_rt.state.tables[name],
                      f"{where}: table {name!r}")


class _Pair:
    """The two lock-stepped runtimes + the mirroring discipline.  Both
    read one params tree (the executables never write it)."""

    def __init__(self, plane: ArchPlane, seed: int, device="cuda",
                 controller=None):
        self.plane = plane
        example = make_batch(plane, np.random.default_rng(seed + 999))
        step = make_step(plane)
        params = build_params(plane, seed, device)
        # chaos runs hand the SPEC side an explicit controller (health
        # state machine + retrying scheduler); the oracle stays on its
        # private one — faults are never injected on the oracle
        self.spec = MorpheusRuntime(
            step, build_tables(plane, seed), params, example,
            conformance_engine_config(plane, device=device),
            controller=controller)
        self.oracle = MorpheusRuntime(
            step, build_tables(plane, seed), params, example,
            EngineConfig(
                sketch=conformance_engine_config(plane).sketch,
                features=dict(plane.features),
                passes=PassRegistry((DeadCodePass(),)),
                device=device))
        self.spec.sampler.pin(PIN_EVERY)
        self.oracle.sampler.pin(PIN_EVERY)

    def mirror_version(self) -> None:
        """Bump the oracle's version counter up to the specialized
        side's, so guard windows stay aligned."""
        while self.oracle.tables.version < self.spec.tables.version:
            self.oracle.tables.bump_version("conformance-mirror")

    def control_update(self, table: str, fields) -> None:
        self.spec.control_update(table, fields)
        self.oracle.control_update(table, fields)
        self.mirror_version()

    def set_feature(self, flag: str, value: bool) -> None:
        self.spec.set_feature(flag, value)
        self.oracle.set_feature(flag, value)
        self.mirror_version()

    def bump_version(self, reason: str) -> None:
        self.spec.tables.bump_version(reason)
        self.oracle.tables.bump_version(reason)
        self.mirror_version()

    def recompile(self) -> dict:
        res = self.spec.recompile(block=True)
        self.oracle.recompile(block=True)
        self.mirror_version()
        return res

    def close(self) -> None:
        self.spec.close()
        self.oracle.close()


def _plan_impls(rt) -> Set[Tuple[str, str]]:
    return {(sid.split("#")[0], spec.impl)
            for sid, spec in rt.plan.sites}


def _check_deopt(pair: _Pair, before: int, report: Report) -> None:
    after = pair.spec.stats.deopt_steps
    if after <= before:
        raise ConformanceError(
            f"{report.arch}/{report.mode}: injected mispredict did not "
            f"deopt (deopt_steps {before} -> {after}; spec version="
            f"{pair.spec.tables.version} plan version="
            f"{pair.spec.plan.version})")
    report.deopt_steps = after


# ---- mode drivers -------------------------------------------------------

def _drive_plain(pair: _Pair, schedule: List[ChurnEvent],
                 report: Report) -> None:
    expect_deopt: Optional[int] = None
    for ev in schedule:
        report.events += 1
        if ev.kind == "step":
            out_s = pair.spec.step(ev.payload["batch"])
            out_o = pair.oracle.step(ev.payload["batch"])
            report.steps += 1
            report.compares += 1
            _assert_equal(out_s, out_o,
                          f"{report.arch}/plain step {report.steps}")
            _assert_tables_equal(pair.spec, pair.oracle,
                                 f"{report.arch}/plain step "
                                 f"{report.steps}")
            if expect_deopt is not None:
                _check_deopt(pair, expect_deopt, report)
                expect_deopt = None
        else:
            _apply_control(pair, ev, report)
            if ev.kind == "inject_mispredict":
                expect_deopt = pair.spec.stats.deopt_steps


def _drive_fused(pair: _Pair, schedule: List[ChurnEvent],
                 report: Report) -> None:
    buf: List[dict] = []
    expect_deopt: Optional[int] = None

    def flush():
        nonlocal expect_deopt
        if not buf:
            return
        k = len(buf)
        out_s = pair.spec.step_many(list(buf))
        out_o = pair.oracle.step_many(list(buf))
        report.steps += k
        report.compares += 1
        buf.clear()
        _assert_equal(out_s, out_o,
                      f"{report.arch}/fused window @{report.steps}")
        _assert_tables_equal(pair.spec, pair.oracle,
                             f"{report.arch}/fused window "
                             f"@{report.steps}")
        if expect_deopt is not None:
            _check_deopt(pair, expect_deopt, report)
            expect_deopt = None

    for ev in schedule:
        report.events += 1
        if ev.kind == "step":
            buf.append(ev.payload["batch"])
            if len(buf) >= FUSE_K:
                flush()
        else:
            flush()           # control events land at window boundaries
            _apply_control(pair, ev, report)
            if ev.kind == "inject_mispredict":
                expect_deopt = pair.spec.stats.deopt_steps
    flush()


def _drive_frontend(pair: _Pair, schedule: List[ChurnEvent],
                    report: Report) -> None:
    from ..serving.frontend import FrontendConfig, ServingFrontend

    t = [0.0]

    def clock() -> float:       # virtual time: deterministic waits
        t[0] += 1e-4
        return t[0]

    fe = ServingFrontend(pair.spec,
                         FrontendConfig(max_batch=8, max_wait_s=0.0),
                         clock=clock, keep_outputs=False)

    captured: List[Tuple[Any, int, Any, int]] = []
    real_step_many = pair.spec.step_many

    def tapped(batches, k=None):
        out = real_step_many(batches, k=k)
        captured.append((batches, k, out, pair.spec.tables.version))
        return out

    pair.spec.step_many = tapped     # instance attr shadows the method
    expect_deopt: Optional[int] = None
    try:
        for ev in schedule:
            report.events += 1
            if ev.kind == "step":
                for row in ev.payload["rows"]:
                    fe.submit(row)
                while fe.pump() > 0:
                    pass
                fe.batcher.retire_all()
                for stacked, k, out_s, v in captured:
                    while pair.oracle.tables.version < v:
                        pair.oracle.tables.bump_version("mirror")
                    out_o = pair.oracle.step_many(stacked, k=k)
                    report.steps += k
                    report.compares += 1
                    _assert_equal(
                        out_s, out_o,
                        f"{report.arch}/frontend window "
                        f"@{report.steps}")
                captured.clear()
                pair.mirror_version()
                _assert_tables_equal(pair.spec, pair.oracle,
                                     f"{report.arch}/frontend "
                                     f"@{report.steps}")
                if expect_deopt is not None:
                    _check_deopt(pair, expect_deopt, report)
                    expect_deopt = None
            else:
                _apply_control(pair, ev, report)
                if ev.kind == "inject_mispredict":
                    expect_deopt = pair.spec.stats.deopt_steps
    finally:
        del pair.spec.step_many          # un-shadow the bound method
        pair.spec.attach_profile(None)


def _apply_control(pair: _Pair, ev: ChurnEvent, report: Report) -> None:
    if ev.kind == "control_update":
        pair.control_update(ev.payload["table"], ev.payload["fields"])
    elif ev.kind == "flag_flip":
        pair.set_feature(ev.payload["flag"], ev.payload["value"])
    elif ev.kind == "hotset_rotate":
        pass                    # baked into later batches at generation
    elif ev.kind == "sampler_pin":
        pair.spec.sampler.pin(ev.payload["every"])
        pair.oracle.sampler.pin(ev.payload["every"])
    elif ev.kind == "sampler_rearm":
        pair.spec.sampler.rearm()
        pair.oracle.sampler.rearm()
    elif ev.kind == "recompile":
        pair.recompile()
        report.recompiles += 1
        report.impls_seen |= _plan_impls(pair.spec)
    elif ev.kind == "inject_mispredict":
        pair.bump_version("conformance:inject-mispredict")
        report.mispredicts += 1
    else:
        raise ValueError(f"unknown churn event kind {ev.kind!r}")


_DRIVERS = {"plain": _drive_plain, "fused": _drive_fused,
            "frontend": _drive_frontend}
MODES = tuple(_DRIVERS)


def _check_coverage(plane: ArchPlane, report: Report) -> None:
    """Per-arch specialization coverage: the run must have exercised
    the architecture's distinguishing fast paths, not just survived."""
    specialized = {(t, i) for t, i in report.impls_seen
                   if i not in ("gather",)}
    if not specialized:
        raise ConformanceError(
            f"{report.arch}/{report.mode}: plan never specialized any "
            f"site (impls seen: {sorted(report.impls_seen)})")
    impls_by_table: Dict[str, Set[str]] = {}
    for tab, impl in report.impls_seen:
        impls_by_table.setdefault(tab, set()).add(impl)
    if plane.has_ssm and "ssd_fastpath" not in impls_by_table.get(
            "ssm_state", set()):
        raise ConformanceError(
            f"{report.arch}: SSD fast path never claimed "
            f"(ssm_state impls: {impls_by_table.get('ssm_state')})")
    if plane.has_moe and "moe_fastpath" not in impls_by_table.get(
            "router", set()):
        raise ConformanceError(
            f"{report.arch}: MoE fast path never claimed "
            f"(router impls: {impls_by_table.get('router')})")
    if plane.has_cross and not (impls_by_table.get("cross_src", set())
                                - {"gather"}):
        raise ConformanceError(
            f"{report.arch}: cross-attention source table never "
            f"specialized")
    if plane.has_media and not (impls_by_table.get("media_patches",
                                                   set()) - {"gather"}):
        raise ConformanceError(
            f"{report.arch}: media patch table never specialized")


def run_conformance(arch_id: str, mode: str = "plain", seed: int = 0,
                    n_events: int = 60, check_coverage: bool = True,
                    device="cuda") -> Dict[str, Any]:
    """Drive one (arch, mode, seed) conformance cell on ``device``;
    raises :class:`ConformanceError` on any divergence, returns the
    report dict on success."""
    if mode not in _DRIVERS:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    plane = build_plane(arch_id)
    schedule = generate_schedule(plane, seed=seed, n_events=n_events)
    report = Report(arch=arch_id, mode=mode, seed=seed)
    pair = _Pair(plane, seed, device)
    try:
        _DRIVERS[mode](pair, schedule, report)
        if report.mispredicts < 2:
            raise ConformanceError(
                f"{arch_id}/{mode}: schedule injected only "
                f"{report.mispredicts} mispredicts")
        report.impls_seen |= _plan_impls(pair.spec)
        report.signature = plan_fingerprint(pair.spec.plan)
        if check_coverage:
            _check_coverage(plane, report)
    finally:
        pair.close()
    return report.as_dict()
