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

The TRAINING chaos cells (``run_train_chaos``, at the end of this file)
drive the training supervisor; their device-loss cell needs a mesh and
raises (ROADMAP.md Queue 1 item 12).
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


# ---------------------------------------------------------------------------
# Training-plane chaos (the TrainSupervisor), ported from the reference
# ---------------------------------------------------------------------------
#
# The training plane's obligations are trajectory-level:
#
#   crash_resume  a crash + resume replays the never-crashed run
#                 BIT-EXACTLY (losses and every state leaf), because the
#                 supervisor's executable sequence pi(step) is
#                 deterministic and checkpoint-coupled — and the resume
#                 itself performs ZERO training-thread builds (the plan
#                 revalidates in background).
#   step_fault    an in-process fault deopts to the resident generic and
#                 retries the same batch: the optimizer step counter
#                 advances exactly once per batch (no lost, no double
#                 step) and the run ends re-specialized + healthy.
#   device_loss   the elastic arc needs a mesh: raises
#                 NotImplementedError (ROADMAP Queue 1 item 12).
#   compile       injected build failures: bounded-backoff retries
#                 absorb a short burst off the training thread; a burst
#                 past max_retries quarantines the plan signature and
#                 the run survives on generic.

TRAIN_SCENARIOS = ("crash_resume", "step_fault", "device_loss", "compile")
TRAIN_CHAOS_ARCH = "phi3.5-moe-42b-a6.6b"


def _train_cell(seed: int, steps: int, device, *,
                respecialize_every: int = 8, hot_coverage: float = 0.7,
                seq: int = 32, batch: int = 4):
    """One training-plane cell: smoke MoE config, deterministic data
    stream, fast-clock health knobs (as the serving chaos cells)."""
    from ..configs import get_config
    from ..data import DataConfig
    from ..models.model import Model
    from ..optim import AdamWConfig
    from ..training import SupervisorConfig

    cfg = get_config(TRAIN_CHAOS_ARCH).smoke()
    model = Model(cfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq=seq, global_batch=batch,
                      seed=seed, media_tokens=cfg.num_media_tokens,
                      d_model=cfg.d_model, enc_seq=0)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    scfg = SupervisorConfig(respecialize_every=respecialize_every,
                            hot_coverage=hot_coverage,
                            health=chaos_health_config("plain"))

    def make_sup(injector=None, ckpt_dir=None, log=None):
        from ..data import TokenPipeline
        from ..launch.train import build_state
        from ..training import TrainSupervisor
        state = build_state(model, seed, device)
        example = TokenPipeline(dcfg, device).peek_batch()
        sup = TrainSupervisor(model, opt_cfg, state, example, cfg=scfg,
                              injector=injector, ckpt_dir=ckpt_dir,
                              log_fn=log or (lambda m: None))
        return sup, state

    return dcfg, make_sup


def _opt_step(state) -> int:
    return int(state["opt"]["step"])


def _leaves(state) -> list:
    from ..models.params import flat_tree
    return [t.detach().cpu().clone() for t in flat_tree(state).values()]


def _assert_train(cond: bool, msg: str) -> None:
    if not cond:
        raise ConformanceError(msg)


def _train_crash_resume(seed: int, device, report: Dict[str, Any]) -> None:
    import shutil
    import tempfile

    import torch

    from ..checkpoint import restore, save
    from ..data import TokenPipeline

    steps, crash_at, ckpt_every = 24, 14, 6
    dcfg, make_sup = _train_cell(seed, steps, device)

    # the never-crashed reference trajectory
    sup, state = make_sup()
    pipe = TokenPipeline(dcfg, device)
    ref_losses = []
    for _ in range(steps):
        state, m = sup.step(state, pipe.next_batch())
        ref_losses.append(float(m["loss"]))
    ref_leaves = _leaves(state)
    _assert_train(sup.stats()["activations"] >= 1,
                  "crash_resume: reference run never specialized")
    sup.close()
    del state

    # the crashed run: checkpoint cadence, then abandon mid-interval
    d = tempfile.mkdtemp(prefix="train_chaos_")
    try:
        sup, state = make_sup(ckpt_dir=d)
        pipe = TokenPipeline(dcfg, device)
        for i in range(crash_at):
            state, m = sup.step(state, pipe.next_batch())
            if (i + 1) % ckpt_every == 0:
                save(d, i + 1, state,
                     meta={"data": pipe.state_dict(),
                           "morpheus": sup.spec_meta()})
        sup.close()                      # crash: all live state is gone
        del state

        # resume as a fresh process would: new supervisor, cold cache
        sup, state = make_sup(ckpt_dir=d)
        state, meta = restore(d, None, state)
        pipe = TokenPipeline(dcfg, device)
        pipe.load_state_dict(meta["data"])
        start = meta["step"]
        sup.restore_spec(meta.get("morpheus"), resume_step=start)
        res_losses = []
        for _ in range(start, steps):
            state, m = sup.step(state, pipe.next_batch())
            res_losses.append(float(m["loss"]))
        s = sup.stats()
        # zero training-thread specialization builds at resume: the only
        # sync build is the resident generic of the constructor
        _assert_train(s["sync_compiles"] == 1,
                      f"crash_resume: resume built on the training "
                      f"thread (sync_compiles={s['sync_compiles']})")
        _assert_train(res_losses == ref_losses[start:],
                      f"crash_resume: loss trajectory diverged after "
                      f"resume at {start}")
        bad = [i for i, (a, b) in enumerate(zip(ref_leaves,
                                                _leaves(state)))
               if not torch.equal(a, b)]
        _assert_train(not bad,
                      f"crash_resume: {len(bad)} state leaves differ "
                      f"from the never-crashed run")
        sup.close()
        report.update(resume_step=start, bit_exact=True,
                      resume_stats=s)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _train_step_fault(seed: int, device, report: Dict[str, Any]) -> None:
    from ..data import TokenPipeline

    steps, fault_at = 32, 14
    dcfg, make_sup = _train_cell(seed, steps, device)
    inj = FailureInjector()
    sup, state = make_sup(injector=inj)
    pipe = TokenPipeline(dcfg, device)
    for i in range(steps):
        if i == fault_at:
            _assert_train(sup.active_plan.specialized,
                          "step_fault: plane not specialized at the "
                          "injection point")
            inj.arm_next(SimulatedFailure("chaos: train step fault"))
        state, m = sup.step(state, pipe.next_batch())
        if i == fault_at:
            _assert_train(not sup.active_plan.specialized,
                          "step_fault: fault did not deopt to generic")
    s = sup.stats()
    # the no-lost-step obligation: every batch applied exactly once
    _assert_train(_opt_step(state) == steps,
                  f"step_fault: optimizer applied {_opt_step(state)} "
                  f"updates for {steps} batches")
    _assert_train(s["step_faults"] == 1, "step_fault: fault not counted")
    _assert_train(s["respecialize_recoveries"] >= 1
                  and s["health"] == HEALTHY
                  and s["active"].startswith("specialized"),
                  f"step_fault: plane never recovered "
                  f"(health={s['health']} active={s['active']})")
    _assert_train(np.isfinite(float(m["loss"])),
                  "step_fault: non-finite loss after recovery")
    sup.close()
    report.update(fault_step=fault_at, stats=s)


def _train_device_loss(seed: int, device, report: Dict[str, Any]) -> None:
    raise NotImplementedError(
        "the training device-loss arc needs a mesh and elastic resharding: "
        "ROADMAP Queue 1 item 12")


def _train_compile_fault(seed: int, device, report: Dict[str, Any]) -> None:
    from ..data import TokenPipeline

    dcfg, make_sup = _train_cell(seed, 16, device)
    # episode A: a short burst (<= max_retries) is absorbed by the
    # scheduler's bounded backoff — the swap still happens, off-thread
    sup, state = make_sup()
    pipe = TokenPipeline(dcfg, device)
    sup.arm_compile_faults(2)
    for _ in range(16):
        state, m = sup.step(state, pipe.next_batch())
    s = sup.stats()
    sched = sup.scheduler.stats()
    _assert_train(s["activations"] >= 1 and s["quarantines"] == 0,
                  f"compile: retry burst not absorbed ({s})")
    _assert_train(sched["retries"] >= 1,
                  "compile: scheduler never retried")
    sup.close()
    report.update(absorbed_stats=s)

    # episode B: a burst past max_retries quarantines the signature;
    # the run survives on generic
    sup, state = make_sup()
    pipe = TokenPipeline(dcfg, device)
    sup.arm_compile_faults(10)
    for _ in range(16):
        state, m = sup.step(state, pipe.next_batch())
    s = sup.stats()
    _assert_train(s["quarantines"] == 1 and s["activations"] == 0,
                  f"compile: give-up did not quarantine ({s})")
    _assert_train(s["health"] == "quarantined"
                  and s["active"] == "generic",
                  f"compile: quarantined plane not on generic ({s})")
    _assert_train(_opt_step(state) == 16 and np.isfinite(float(m["loss"])),
                  "compile: training did not survive quarantine")
    sup.close()
    report.update(quarantine_stats=s)


_TRAIN_SCENARIOS = {"crash_resume": _train_crash_resume,
                    "step_fault": _train_step_fault,
                    "device_loss": _train_device_loss,
                    "compile": _train_compile_fault}


def run_train_chaos(scenario: str, seed: int = 0,
                    device="cuda") -> Dict[str, Any]:
    """Drive one training-plane chaos scenario on ``device`` (see the
    section comment above); raises :class:`ConformanceError` on any
    violated obligation; returns the report dict on success."""
    if scenario not in _TRAIN_SCENARIOS:
        raise ValueError(f"scenario {scenario!r} not in {TRAIN_SCENARIOS}")
    report: Dict[str, Any] = {"scenario": scenario, "seed": seed,
                              "arch": TRAIN_CHAOS_ARCH}
    _TRAIN_SCENARIOS[scenario](seed, device, report)
    return report


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
