"""The chaos extension of the conformance harness: fault-injected
degraded-mode serving, differentially checked against the generic
oracle.

Ported from ``repro.testing.chaos`` (its serving half).
``run_chaos(arch_id, mode, seed)`` reuses the lock-stepped
:class:`~repro_torch.testing.conformance._Pair` but hands the
SPECIALIZED side an explicit
:class:`~repro_torch.core.controller.MorpheusController` (health state
machines + retrying recompile scheduler) and a
:class:`~repro_torch.distributed.fault.FailureInjector`, then replays a
seeded **chaos** churn schedule — the regular move pool plus four
fault-injection episodes (``chaos_fault`` / ``schedule_recovery``
events, see :mod:`repro_torch.testing.churn`):

  step         the executable raises mid-step.  The dispatch fault
               boundary aborts the step with nothing committed, degrades
               the plane to generic-only dispatch, and the driver
               retries the SAME batch, which must now serve bit for bit
               through the generic executable.
  device_loss  a device drops out: on the port's one-device planes the
               plain degrade, then generic serving.
  compile      a recompile cycle raises: the scheduler's exponential-
               backoff retry absorbs it off the serving path.
  straggler    synthetic slow-step observations trip the
               StragglerMonitor, whose mitigation degrades the plane.

Every fault arc ends in ``schedule_recovery``: the health-gated
``controller.schedule`` + ``drain`` loop that re-specializes the plane
(DEGRADED -> RECOVERING -> HEALTHY).  The oracle never faults.  The
final sweep asserts the terminal obligations: the plane is back
HEALTHY, not degraded, its plan version-aligned with specialized
(non-gather) impls active, and one more step is bit-identical.

Frontend mode serves the same schedule through a
:class:`~repro_torch.serving.frontend.ServingFrontend`: faulted windows
terminate their requests ``failed``/``PLANE_FAULT``, submissions to the
degraded plane are rejected ``PLANE_DEGRADED``, and the run ends with
the accounting invariant — every submitted request reached exactly one
terminal state.

Not ported yet: the TRAINING chaos cells (``run_train_chaos``), which
need the training supervisor (ROADMAP.md Queue 1 item 10).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from ..core.controller import (HEALTHY, ControllerConfig, HealthConfig,
                               MorpheusController)
from ..distributed.fault import (FailureInjector, SimulatedDeviceLoss,
                                 SimulatedFailure, StragglerMonitor)
from .archzoo import ArchPlane, build_plane, make_batch
from .churn import ChurnEvent, generate_schedule
from .conformance import (ConformanceError, _apply_control,
                          _assert_equal, _assert_tables_equal, _Pair,
                          _plan_impls)

FAULT_KINDS = ("step", "device_loss", "compile", "straggler")
CHAOS_MODES = ("plain", "frontend")


def chaos_health_config(mode: str) -> HealthConfig:
    """Fast-clock health knobs for chaos runs: no mandated downtime,
    millisecond backoff, and (frontend mode) a zero-step recovery probe
    — a degraded frontend rejects every new request, so its step
    counter cannot advance to satisfy a step-count probe."""
    return HealthConfig(probe_steps=2 if mode == "plain" else 0,
                        min_downtime_s=0.0,
                        backoff_base_s=0.005, backoff_cap_s=0.05,
                        max_retries=3)


@dataclass
class ChaosReport:
    """What one chaos run observed (returned as a dict)."""
    arch: str
    mode: str
    seed: int
    events: int = 0
    steps: int = 0
    compares: int = 0
    recompiles: int = 0
    mispredicts: int = 0
    faults: Dict[str, int] = field(default_factory=dict)
    retried_steps: int = 0
    recovery_arcs: int = 0
    rejected_degraded: int = 0
    requests_failed: int = 0
    impls_seen: Set[Tuple[str, str]] = field(default_factory=set)
    final_state: Optional[str] = None

    def as_dict(self) -> Dict[str, Any]:
        d = self.__dict__.copy()
        d["impls_seen"] = sorted(self.impls_seen)
        return d


# ---- fault arming -------------------------------------------------------

def _trip_straggler(pair: _Pair) -> None:
    """Synthetic slow-window observations trip the monitor; its
    mitigation callback degrades the plane — the same wiring
    ``launch/serve.py`` uses against real step latencies."""
    fired: List[int] = []
    mon = StragglerMonitor(threshold=2.0, patience=2, window=16,
                           on_straggler=lambda s, sec: fired.append(s))
    for i in range(8):                   # healthy baseline
        mon.observe(i, 0.010)
    for i in range(8, 16):               # 10x-median stall
        if mon.observe(i, 0.100):
            break
    if not fired:
        raise ConformanceError("straggler monitor never fired")
    pair.spec.degrade_to_generic(f"straggler stall @step {fired[0]}")


def _arm_fault(pair: _Pair, inj: FailureInjector, payload: Dict,
               report: ChaosReport) -> None:
    fault = payload["fault"]
    report.faults[fault] = report.faults.get(fault, 0) + 1
    if fault == "step":
        inj.arm_next(SimulatedFailure("chaos: injected step fault"))
    elif fault == "device_loss":
        inj.arm_next(SimulatedDeviceLoss("chaos: injected device loss"))
    elif fault == "compile":
        pair.spec.arm_compile_faults(int(payload.get("n", 1)))
    elif fault == "straggler":
        _trip_straggler(pair)
    else:
        raise ValueError(f"unknown chaos fault kind {fault!r}")


def _recover(pair: _Pair, ctl: MorpheusController,
             report: ChaosReport, rounds: int = 20) -> None:
    """The recovery arc: health-gated schedule + drain until the spec
    plane is HEALTHY with specialized dispatch re-armed, then mirror
    the oracle's recompile cadence."""
    spec = pair.spec
    health = ctl.health_for(spec.plane_id)
    for _ in range(rounds):
        ctl.schedule(spec)
        ctl.drain(timeout=120.0)
        if health.state == HEALTHY and not spec.degraded:
            break
    else:
        raise ConformanceError(
            f"{report.arch}/{report.mode}: plane never recovered "
            f"(state={health.state} degraded={spec.degraded} "
            f"last_error={ctl.stats().last_error(spec.plane_id)!r})")
    report.recovery_arcs += 1
    report.impls_seen |= _plan_impls(spec)
    pair.oracle.recompile(block=True)
    pair.mirror_version()


# ---- mode drivers -------------------------------------------------------

def _drive_chaos_plain(pair: _Pair, inj: FailureInjector,
                       ctl: MorpheusController,
                       schedule: List[ChurnEvent],
                       report: ChaosReport) -> None:
    for ev in schedule:
        report.events += 1
        if ev.kind == "step":
            batch = ev.payload["batch"]
            try:
                out_s = pair.spec.step(batch)
            except SimulatedFailure:
                # the fault boundary aborted the step with nothing
                # committed and degraded the plane; the SAME batch must
                # now serve through the generic executable
                if not pair.spec.degraded:
                    raise ConformanceError(
                        f"{report.arch}: step fault did not degrade "
                        f"the plane")
                out_s = pair.spec.step(batch)
                report.retried_steps += 1
            out_o = pair.oracle.step(batch)
            report.steps += 1
            report.compares += 1
            where = f"{report.arch}/chaos step {report.steps}"
            _assert_equal(out_s, out_o, where)
            _assert_tables_equal(pair.spec, pair.oracle, where)
        elif ev.kind == "chaos_fault":
            _arm_fault(pair, inj, ev.payload, report)
        elif ev.kind == "schedule_recovery":
            _recover(pair, ctl, report)
        else:
            _apply_control(pair, ev, report)


def _drive_chaos_frontend(pair: _Pair, inj: FailureInjector,
                          ctl: MorpheusController,
                          schedule: List[ChurnEvent],
                          report: ChaosReport) -> None:
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
        # only SUCCESSFUL windows are captured for oracle replay: a
        # faulted window raises through here, the batcher accounts its
        # requests as failed, and neither side committed any state
        out = real_step_many(batches, k=k)
        captured.append((batches, k, out, pair.spec.tables.version))
        return out

    pair.spec.step_many = tapped     # instance attr shadows the method
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
                    _assert_equal(out_s, out_o,
                                  f"{report.arch}/chaos frontend "
                                  f"window @{report.steps}")
                captured.clear()
                pair.mirror_version()
                _assert_tables_equal(pair.spec, pair.oracle,
                                     f"{report.arch}/chaos frontend "
                                     f"@{report.steps}")
            elif ev.kind == "chaos_fault":
                _arm_fault(pair, inj, ev.payload, report)
            elif ev.kind == "schedule_recovery":
                _recover(pair, ctl, report)
            else:
                _apply_control(pair, ev, report)
        while fe.pump() > 0:
            pass
        fe.batcher.retire_all()
        if len(fe.queue) or fe.batcher.inflight:
            raise ConformanceError(
                f"{report.arch}/frontend: undrained requests at end")
    finally:
        del pair.spec.step_many          # un-shadow the bound method
        pair.spec.attach_profile(None)

    # the no-silent-loss obligation: every submitted request reached
    # exactly one terminal state, faults and rejections included
    s = pair.spec.stats
    terminal = (s.requests_completed + s.requests_rejected
                + s.requests_shed + s.requests_failed)
    if s.requests_submitted != terminal:
        raise ConformanceError(
            f"{report.arch}/frontend: request accounting leak — "
            f"submitted {s.requests_submitted} != terminal {terminal} "
            f"(completed={s.requests_completed} "
            f"rejected={s.requests_rejected} shed={s.requests_shed} "
            f"failed={s.requests_failed})")
    report.rejected_degraded = s.requests_rejected_degraded
    report.requests_failed = s.requests_failed


_CHAOS_DRIVERS = {"plain": _drive_chaos_plain,
                  "frontend": _drive_chaos_frontend}


# ---- terminal obligations -----------------------------------------------

def _final_sweep(pair: _Pair, ctl: MorpheusController, plane: ArchPlane,
                 report: ChaosReport, seed: int) -> None:
    """After the full schedule: the plane must be HEALTHY with
    specialized code RE-ACTIVE (not merely surviving on generic), and
    one more step must still be bit-identical."""
    spec = pair.spec
    health = ctl.health_for(spec.plane_id)
    # settle any trailing control churn into one last aligned plan
    ctl.schedule(spec)
    ctl.drain(timeout=120.0)
    pair.oracle.recompile(block=True)
    pair.mirror_version()
    report.final_state = health.state
    if spec.degraded or health.state != HEALTHY:
        raise ConformanceError(
            f"{report.arch}/{report.mode}: terminal plane not healthy "
            f"(state={health.state} degraded={spec.degraded} "
            f"reason={spec.degrade_reason!r})")
    if spec.tables.version != spec.plan.version:
        raise ConformanceError(
            f"{report.arch}/{report.mode}: terminal plan stale "
            f"(tables v{spec.tables.version} vs plan "
            f"v{spec.plan.version})")
    final_impls = _plan_impls(spec)
    report.impls_seen |= final_impls
    if not {impl for _, impl in final_impls} - {"gather"}:
        raise ConformanceError(
            f"{report.arch}/{report.mode}: recovered plane never "
            f"re-specialized (terminal impls: {sorted(final_impls)})")
    batch = make_batch(plane, np.random.default_rng(seed + 777))
    out_s = spec.step(batch)
    out_o = pair.oracle.step(batch)
    report.steps += 1
    report.compares += 1
    _assert_equal(out_s, out_o, f"{report.arch}/{report.mode}: "
                  f"post-recovery step")
    _assert_tables_equal(spec, pair.oracle,
                         f"{report.arch}/{report.mode}: post-recovery")


def run_train_chaos(scenario: str, seed: int = 0) -> Dict[str, Any]:
    """The TRAINING chaos cells (crash/resume, step fault, device loss,
    compile fault on the training plane) need the training supervisor,
    which is not ported yet."""
    raise NotImplementedError(
        "training chaos waits for the training slice of the port "
        "(ROADMAP.md Queue 1 item 10)")


def run_chaos(arch_id: str, mode: str = "plain", seed: int = 0,
              n_events: int = 70, device="cuda") -> Dict[str, Any]:
    """Drive one (arch, mode, seed) chaos cell on ``device``; raises
    :class:`ConformanceError` on any divergence, unaccounted loss, or
    failed recovery; returns the report dict on success."""
    if mode not in _CHAOS_DRIVERS:
        raise ValueError(f"mode {mode!r} not in {CHAOS_MODES}")
    plane = build_plane(arch_id)
    schedule = generate_schedule(plane, seed=seed, n_events=n_events,
                                 chaos=True)
    ctl = MorpheusController(
        ControllerConfig(health=chaos_health_config(mode)))
    report = ChaosReport(arch=arch_id, mode=mode, seed=seed)
    pair = _Pair(plane, seed, device, controller=ctl)
    inj = FailureInjector()
    pair.spec.set_fault_injector(inj)
    try:
        _CHAOS_DRIVERS[mode](pair, inj, ctl, schedule, report)
        _final_sweep(pair, ctl, plane, report, seed)
        missing = set(FAULT_KINDS) - set(report.faults)
        if missing:
            raise ConformanceError(
                f"{arch_id}/{mode}: schedule never injected "
                f"{sorted(missing)} faults")
        if report.recovery_arcs < len(FAULT_KINDS):
            raise ConformanceError(
                f"{arch_id}/{mode}: only {report.recovery_arcs} "
                f"recovery arcs for {sum(report.faults.values())} "
                f"faults")
        if mode == "plain" and report.retried_steps == 0:
            raise ConformanceError(
                f"{arch_id}/plain: no faulted step was retried through "
                f"the degraded path")
        if mode == "frontend" and report.rejected_degraded == 0:
            raise ConformanceError(
                f"{arch_id}/frontend: degraded plane never rejected a "
                f"request with PLANE_DEGRADED")
    finally:
        pair.close()
        ctl.close()
    return report.as_dict()
