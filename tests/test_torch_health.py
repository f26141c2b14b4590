"""Fleet health and recovery on the port: fault-injected degraded-mode
serving, twin by twin with the reference's ``tests/test_health.py``.

The per-plane health state machine and its token-bucket re-admission
ramp; the recompile scheduler's bounded backoff retry and give-up hook;
ExecutableCache signature quarantine; the runtime's dispatch fault
boundary (an injected fault aborts the step with nothing committed,
degrades the plane, and the same batch then serves bit for bit through
the generic executable); device loss on a one-device plane (the plain
degrade); health-gated re-specialization; the frontend's explicit
``PLANE_DEGRADED`` rejections and ``PLANE_FAULT`` window accounting; and
the open-loop driver's reroute around sick planes.  The reference's
mesh-shrink test has no twin: the port places a plane on one device.
Where a reference test compares a plane against its twin bit for bit,
so does its twin here, and the port's outputs also equal the
reference's on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JEngineConfig, \
    MorpheusRuntime as JRuntime, SketchConfig as JSketchConfig, \
    Table as JTable, TableSet as JTableSet
from repro_torch.core import EngineConfig, MorpheusRuntime, SketchConfig, \
    Table, TableSet
from repro_torch.core.controller import (DEGRADED, HEALTHY, QUARANTINED,
                                         RECOVERING, ControllerConfig,
                                         HealthConfig, MorpheusController,
                                         PlaneHealth, TokenBucket)
from repro_torch.core.controller.scheduler import RecompileScheduler
from repro_torch.core.execcache import ExecutableCache
from repro_torch.distributed.fault import (FailureInjector,
                                           SimulatedCompileFailure,
                                           SimulatedDeviceLoss,
                                           SimulatedFailure)

N_VALID = 48


class VClock:
    """Virtual monotonic clock — deterministic probe/backoff tests."""

    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


# ---------------------------------------------------------------------------
# a minimal real data plane (the reference test's)
# ---------------------------------------------------------------------------

def _user_step(params, ctx, batch):
    row = ctx.lookup("classes", batch["cls"], fields=("scale",))
    x = batch["x"] * row["scale"][:, None]
    old = ctx.lookup("sess", batch["slot"], fields=("count",))
    ctx.update("sess", batch["slot"], {"count": old["count"] + 1})
    return x


def _table_fields(seed=0):
    return [("classes",
             {"scale": np.linspace(1.0, 2.0, N_VALID).astype(np.float32)
              + seed},
             dict(n_valid=N_VALID, instrument=True)),
            ("sess", {"count": np.zeros(16, np.int32)},
             dict(n_valid=16, mutability="rw"))]


def _np_batch(i=0):
    rng = np.random.default_rng(i)
    cls = np.arange(16) % N_VALID
    cls[:12] = np.arange(12) % 3
    return {"cls": cls.astype(np.int32),
            "x": rng.standard_normal((16, 4)).astype(np.float32),
            "slot": rng.integers(0, 16, 16).astype(np.int32)}


def _batch(i=0):
    return {k: torch.from_numpy(v) for k, v in _np_batch(i).items()}


SKETCH = dict(sample_every=2, max_hot=4, hot_coverage=0.5)


def _mk(seed=0, controller=None, **kw):
    cfg = EngineConfig(sketch=SketchConfig(**SKETCH), device="cpu", **kw)
    tables = TableSet([Table(n, f, **k) for n, f, k in _table_fields(seed)])
    return MorpheusRuntime(_user_step, tables, None, _batch(), cfg=cfg,
                           controller=controller)


def _jmk():
    def step(params, ctx, batch):
        return _user_step(params, ctx, batch)
    tables = JTableSet([JTable(n, f, **k) for n, f, k in _table_fields()])
    jb = {k: jnp.asarray(v) for k, v in _np_batch().items()}
    return JRuntime(step, tables, None, jb,
                    cfg=JEngineConfig(sketch=JSketchConfig(**SKETCH)))


def _warm(rt, n=6, batch=_batch):
    for i in range(n):
        rt.step(batch(i))
    rt.recompile(block=True)


def _eq(a, b):
    assert torch.equal(torch.as_tensor(np.array(a)),
                       torch.as_tensor(np.array(b)))


# ---------------------------------------------------------------------------
# TokenBucket + PlaneHealth state machine (virtual time)
# ---------------------------------------------------------------------------

def test_token_bucket_refills_at_rate():
    clk = VClock()
    b = TokenBucket(rate=10.0, burst=2.0, clock=clk, initial=2.0)
    assert b.try_take() and b.try_take()
    assert not b.try_take()              # drained
    clk.advance(0.1)                     # +1 token
    assert b.try_take() and not b.try_take()
    clk.advance(100.0)                   # refill caps at burst
    assert b.try_take() and b.try_take() and not b.try_take()


def test_plane_health_fault_probe_recover_ramp():
    clk = VClock()
    cfg = HealthConfig(probe_steps=3, min_downtime_s=1.0,
                       ramp_rate=1.0, ramp_burst=1.0, ramp_s=5.0,
                       clock=clk)
    h = PlaneHealth(cfg, "p0")
    assert h.state == HEALTHY and h.admit() and h.gate_schedule()

    h.on_fault("boom", steps=100)
    assert h.state == DEGRADED and not h.admit()
    assert h.last_fault == "boom"
    assert not h.gate_schedule(steps_now=103)    # downtime not elapsed
    clk.advance(2.0)
    assert not h.gate_schedule(steps_now=102)    # probe steps short
    assert h.gate_schedule(steps_now=103)        # -> RECOVERING
    assert h.state == RECOVERING
    assert h.admit()                     # bucket's initial token
    assert not h.admit()                 # drained at rate=1/s

    h.on_recovered()
    assert h.state == HEALTHY
    assert not h.admit()                 # still ramping, bucket empty
    clk.advance(1.5)
    assert h.admit()                     # refilled
    clk.advance(10.0)                    # past ramp_s: unconditional
    assert h.admit() and h.admit() and h.admit()
    snap = h.snapshot()
    assert snap["faults"] == 1 and snap["recoveries"] == 1
    assert not snap["ramping"]


def test_plane_health_quarantine_until_control_update():
    h = PlaneHealth(HealthConfig(), "p0")
    h.on_fault("boom", steps=0)
    h.quarantine("gave up: SimulatedCompileFailure")
    assert h.state == QUARANTINED
    assert not h.admit() and not h.gate_schedule(steps_now=10 ** 6)
    h.on_fault("again", steps=5)         # faults never un-quarantine
    assert h.state == QUARANTINED
    h.on_recovered()                     # nor do stray recoveries
    assert h.state == QUARANTINED
    h.on_update()                        # new specialization basis
    assert h.state == DEGRADED
    assert h.snapshot()["quarantines"] == 1


# ---------------------------------------------------------------------------
# RecompileScheduler: bounded backoff retry, give-up hook
# ---------------------------------------------------------------------------

class _FlakyPlane:
    """Duck-typed plane whose first ``fail_n`` cycles raise."""

    def __init__(self, fail_n):
        self.fail_n = fail_n
        self.calls = 0

    def recompile_priority(self):
        return 1.0

    def _recompile_now(self):
        self.calls += 1
        if self.calls <= self.fail_n:
            raise SimulatedCompileFailure(f"boom #{self.calls}")


def test_scheduler_retries_with_backoff_then_succeeds():
    sch = RecompileScheduler(workers=1, backoff_base_s=0.002,
                             backoff_cap_s=0.01, max_retries=3)
    plane = _FlakyPlane(fail_n=2)
    try:
        sch.submit("p0", plane)
        assert sch.drain(timeout=30.0)
        s = sch.stats()
        assert plane.calls == 3
        assert s["completed"] == 1 and s["failed"] == 2
        assert s["retries"] == 2 and s["gave_up"] == 0
        assert "p0" not in s["last_errors"]
    finally:
        sch.close()


def test_scheduler_gives_up_fires_hook_keeps_last_error():
    gave = []
    sch = RecompileScheduler(
        workers=1, backoff_base_s=0.001, backoff_cap_s=0.002,
        max_retries=1, on_give_up=lambda pid, e: gave.append((pid, e)))
    plane = _FlakyPlane(fail_n=10 ** 9)
    try:
        sch.submit("p0", plane)
        assert sch.drain(timeout=30.0)
        s = sch.stats()
        assert plane.calls == 2              # initial + 1 retry
        assert s["failed"] == 2 and s["gave_up"] == 1
        assert gave and gave[0][0] == "p0"
        assert isinstance(gave[0][1], SimulatedCompileFailure)
        assert "SimulatedCompileFailure" in s["last_errors"]["p0"]
    finally:
        sch.close()


def test_scheduler_default_gives_up_immediately():
    sch = RecompileScheduler(workers=1)
    plane = _FlakyPlane(fail_n=10 ** 9)
    try:
        sch.submit("p0", plane)
        assert sch.drain(timeout=30.0)
        s = sch.stats()
        assert plane.calls == 1
        assert s["failed"] == 1 and s["retries"] == 0
        assert s["gave_up"] == 1
    finally:
        sch.close()


# ---------------------------------------------------------------------------
# ExecutableCache signature quarantine
# ---------------------------------------------------------------------------

def test_exec_cache_quarantine_purges_signature_entries():
    c = ExecutableCache(capacity=8)
    sig_a, sig_b = ("sigA", "flags"), ("sigB", "flags")
    k1 = ExecutableCache.make_key("ns", (sig_a, ()), "bk")
    k2 = ExecutableCache.make_key("ns", (sig_a, ("t",)), "bk", fuse=3)
    k3 = ExecutableCache.make_key("ns", (sig_b, ()), "bk")
    for k in (k1, k2, k3):
        c.put(k, object())
    assert len(c) == 3
    ev0 = c.stats.evictions
    c.quarantine(sig_a)
    assert c.is_quarantined(sig_a) and not c.is_quarantined(sig_b)
    assert len(c) == 1 and k3 in c       # both sigA entries purged
    assert c.stats.evictions == ev0 + 2
    assert c.stats.quarantined == 1
    c.quarantine(sig_a)                  # idempotent
    assert c.stats.quarantined == 1
    c.unquarantine(sig_a)
    assert not c.is_quarantined(sig_a)
    assert c.stats.quarantined == 0


# ---------------------------------------------------------------------------
# the runtime's dispatch-layer fault boundary
# ---------------------------------------------------------------------------

def test_step_fault_degrades_then_serves_generic_byte_identical():
    rt, twin, jrt = _mk(), _mk(), _jmk()
    try:
        _warm(rt)
        _warm(twin)
        _warm(jrt, batch=lambda i: {k: jnp.asarray(v)
                                    for k, v in _np_batch(i).items()})
        assert rt.plan.label.startswith("specialized")
        inj = FailureInjector()
        rt.set_fault_injector(inj)
        inj.arm_next(SimulatedFailure("injected step error"))
        b = _batch(50)
        with pytest.raises(SimulatedFailure):
            rt.step(b)
        # the fault fired BEFORE the executable: nothing committed, the
        # plane degraded, and the SAME batch serves through generic
        assert rt.degraded and "step-fault" in rt.degrade_reason
        assert rt.stats.faults == 1
        out = rt.step(b)
        ref = twin.step(b)
        _eq(out, ref)
        _eq(rt.state.tables["sess"]["count"],
            twin.state.tables["sess"]["count"])
        # and equal to the reference's serving the same batch
        _eq(out, jrt.step({k: jnp.asarray(v)
                           for k, v in _np_batch(50).items()}))
        _eq(rt.state.tables["sess"]["count"],
            jrt.state.tables["sess"]["count"])
        assert rt.stats.degraded_steps >= 1

        # re-specialization clears degraded mode and reports recovery
        res = rt.recompile(block=True)
        assert res.get("recovered") is True
        assert not rt.degraded
        assert rt.stats.recoveries == 1
        snap = rt.controller.stats().health[rt.plane_id]
        assert snap["state"] == HEALTHY
        assert snap["faults"] == 1 and snap["recoveries"] == 1
        b2 = _batch(51)
        _eq(rt.step(b2), twin.step(b2))
    finally:
        rt.close()
        twin.close()
        jrt.close()


def _raise_after(exe, ran):
    """``exe`` that runs (its work enqueued) and then raises."""
    def run_then_raise(params, state, batch):
        ran.append(exe(params, state, batch))
        raise RuntimeError("fault after the step's work was enqueued")
    return run_then_raise


def test_fault_after_the_executable_ran_commits_nothing():
    """An executable that raises after its work ran: the outputs are
    dropped, the state stays the pre-step one, and the retried batch on
    the degraded plane equals a fault-free twin's bit for bit."""
    rt, twin = _mk(), _mk()
    try:
        _warm(rt)
        _warm(twin)
        plan, spec, instr, gen = rt._active
        ran = []
        rt._active = (plan, _raise_after(spec, ran),
                      _raise_after(instr, ran), gen)
        pre, b = rt.state, _batch(52)
        with pytest.raises(RuntimeError, match="after the step's work"):
            rt.step(b)
        assert ran and rt.state is pre
        assert rt.degraded and "step-fault" in rt.degrade_reason
        _eq(rt.step(b), twin.step(b))
        _eq(rt.state.tables["sess"]["count"],
            twin.state.tables["sess"]["count"])
        rt._active = (plan, spec, instr, gen)
        assert rt.recompile(block=True)["recovered"] is True
    finally:
        rt.close()
        twin.close()


def test_window_fault_aborts_whole_window_then_resumes():
    rt, twin = _mk(), _mk()
    try:
        _warm(rt)
        _warm(twin)
        inj = FailureInjector()
        rt.set_fault_injector(inj)
        batches = [_batch(60 + i) for i in range(3)]
        inj.arm_next(SimulatedFailure("window fault"))
        with pytest.raises(SimulatedFailure):
            rt.step_many(batches)
        assert rt.degraded
        _eq(rt.step_many(batches), twin.step_many(batches))
        _eq(rt.state.tables["sess"]["count"],
            twin.state.tables["sess"]["count"])
        assert rt.stats.degraded_steps >= 3
    finally:
        rt.close()
        twin.close()


def test_device_loss_single_device_falls_back_to_degrade():
    rt, twin = _mk(), _mk()
    try:
        _warm(rt)
        _warm(twin)
        inj = FailureInjector()
        rt.set_fault_injector(inj)
        inj.arm_next(SimulatedDeviceLoss("lost device 3"))
        b = _batch(70)
        with pytest.raises(SimulatedDeviceLoss):
            rt.step(b)
        assert rt.degraded and "device-loss" in rt.degrade_reason
        _eq(rt.step(b), twin.step(b))
        res = rt.recompile(block=True)
        assert res.get("recovered") is True and not rt.degraded
    finally:
        rt.close()
        twin.close()


def test_degraded_plane_recovers_through_revalidation():
    """A degrade whose plan is unchanged recovers through the
    revalidation branch (nothing built): the cycle reports
    ``revalidated`` and ``recovered`` and specialized dispatch is back."""
    rt = _mk()
    try:
        _warm(rt)
        rt.recompile(block=True)             # signature now stable
        rt.degrade_to_generic("injected")
        d0 = rt.stats.degraded_steps
        rt.step(_batch(80))
        assert rt.stats.degraded_steps == d0 + 1
        res = rt.recompile(block=True)
        assert res.get("revalidated") is True
        assert res.get("recovered") is True and not rt.degraded
        assert rt.stats.recoveries == 1 and rt.degrade_reason is None
        d1 = rt.stats.degraded_steps
        rt.step(_batch(81))
        assert rt.stats.degraded_steps == d1
    finally:
        rt.close()


# ---------------------------------------------------------------------------
# controller: health-gated scheduling, give-up -> quarantine
# ---------------------------------------------------------------------------

def _chaos_controller(max_retries=1):
    return MorpheusController(ControllerConfig(health=HealthConfig(
        probe_steps=0, min_downtime_s=0.0,
        backoff_base_s=0.001, backoff_cap_s=0.002,
        max_retries=max_retries)))


def test_schedule_is_health_gated_by_recovery_probe():
    clk = VClock()
    ctl = MorpheusController(ControllerConfig(health=HealthConfig(
        probe_steps=2, min_downtime_s=5.0, clock=clk)))
    rt = _mk(controller=ctl)
    try:
        _warm(rt)
        rt.degrade_to_generic("injected")
        health = ctl.health_for(rt.plane_id)
        assert health.state == DEGRADED
        assert ctl.schedule(rt) is False     # downtime not elapsed
        clk.advance(10.0)
        assert ctl.schedule(rt) is False     # probe steps not served
        rt.step(_batch(90))
        rt.step(_batch(91))
        assert ctl.schedule(rt) is True      # probe passes: RECOVERING
        assert health.state == RECOVERING
        assert ctl.drain(timeout=60.0)
        assert health.state == HEALTHY and not rt.degraded
    finally:
        rt.close()
        ctl.close()


def test_compile_fault_retry_exhaustion_quarantines_signature():
    ctl = _chaos_controller(max_retries=1)
    rt = _mk(controller=ctl)
    try:
        _warm(rt)
        sig = rt._last_plan_signature
        assert sig is not None
        rt.arm_compile_faults(2)             # initial attempt + 1 retry
        ctl.schedule(rt)
        assert ctl.drain(timeout=60.0)
        health = ctl.health_for(rt.plane_id)
        assert health.state == QUARANTINED
        assert ctl.exec_cache.is_quarantined(sig)
        stats = ctl.stats()
        assert "SimulatedCompileFailure" in stats.last_error(rt.plane_id)
        assert stats.health[rt.plane_id]["state"] == QUARANTINED
        assert stats.scheduler["gave_up"] == 1
        assert ctl.schedule(rt) is False     # never re-scheduled...
        res = rt.recompile(block=True)       # ...cycles short-circuit...
        assert res.get("quarantined") is True
        rt.step(_batch(95))                  # ...and serving survives
        rt.control_update("classes",
                          {"scale": np.ones(N_VALID, np.float32)})
        assert health.state == DEGRADED
    finally:
        rt.close()
        ctl.close()


def test_quarantined_cycle_of_a_degraded_plane_reports_the_fault():
    """A degraded plane whose cycle plans a quarantined signature drops
    back to DEGRADED (the schedule gate had flipped it RECOVERING)."""
    ctl = _chaos_controller()
    rt = _mk(controller=ctl)
    try:
        _warm(rt)
        ctl.exec_cache.quarantine(rt._last_plan_signature)
        rt.degrade_to_generic("injected")
        health = ctl.health_for(rt.plane_id)
        assert ctl.schedule(rt) is True and health.state == RECOVERING
        assert ctl.drain(timeout=60.0)
        assert health.state == DEGRADED and rt.degraded
        assert health.last_fault == "quarantined plan signature"
    finally:
        rt.close()
        ctl.close()


# ---------------------------------------------------------------------------
# frontend: explicit rejection + window-fault accounting
# ---------------------------------------------------------------------------

def _row(i=1):
    return {"cls": np.int32(i), "x": np.ones(4, np.float32),
            "slot": np.int32(0)}


def test_frontend_rejects_degraded_plane_with_reason():
    from repro_torch.serving.frontend import FrontendConfig, \
        ServingFrontend
    ctl = _chaos_controller()
    rt = _mk(controller=ctl)
    fe = ServingFrontend(rt, FrontendConfig(max_batch=8, max_wait_s=0.0))
    try:
        _warm(rt)
        rt.degrade_to_generic("injected")
        r = fe.submit(_row())
        assert r.done and r.status == "rejected"
        assert r.reason == "PLANE_DEGRADED"
        assert not fe.plane_healthy
        assert rt.stats.requests_rejected_degraded == 1
        assert rt.stats.requests_submitted == 1
        ctl.schedule(rt)                     # recovery re-opens admission
        assert ctl.drain(timeout=60.0)
        assert not rt.degraded and fe.plane_healthy
        r2 = fe.submit(_row())
        assert r2.status == "pending"        # admitted
        while fe.pump() > 0:
            pass
        fe.batcher.retire_all()
        assert r2.status == "ok"
    finally:
        fe.stop(drain=False)
        rt.close()
        ctl.close()


def test_window_fault_fails_requests_with_reason_no_silent_loss():
    from repro_torch.serving.frontend import FrontendConfig, \
        ServingFrontend
    ctl = _chaos_controller()
    rt = _mk(controller=ctl)
    fe = ServingFrontend(rt, FrontendConfig(max_batch=8, max_wait_s=0.0))
    try:
        _warm(rt)
        inj = FailureInjector()
        rt.set_fault_injector(inj)
        inj.arm_next(SimulatedFailure("mid-window fault"))
        rows = [{"cls": np.int32(i % 3), "x": np.ones(4, np.float32),
                 "slot": np.int32(i)} for i in range(4)]
        reqs = [fe.submit(r) for r in rows]
        assert fe.pump() == 4                # batcher survives the fault
        assert all(r.done and r.status == "failed" for r in reqs)
        assert all(r.reason == "PLANE_FAULT" for r in reqs)
        assert rt.stats.requests_failed == 4
        assert rt.degraded
        assert fe.batcher.inflight == 0      # nothing left to retire
        s = rt.stats
        assert s.requests_submitted == (s.requests_completed
                                        + s.requests_rejected
                                        + s.requests_shed
                                        + s.requests_failed)
    finally:
        fe.stop(drain=False)
        rt.close()
        ctl.close()


# ---------------------------------------------------------------------------
# fleet driver: reroute around sick planes
# ---------------------------------------------------------------------------

class _StubFE:
    def __init__(self, healthy=True):
        self.plane_healthy = healthy
        self.taken = []

    def submit(self, payload, deadline_s=None):
        self.taken.append(payload)
        return ("req", payload)


def test_openloop_driver_reroutes_around_degraded_plane():
    from repro_torch.serving.frontend import OpenLoopDriver
    sick, ok = _StubFE(healthy=False), _StubFE(healthy=True)
    drv = OpenLoopDriver([sick, ok], list(range(10)), [0.0] * 10,
                         sleep=lambda s: None)
    drv.run()
    assert not sick.taken                    # every submission rerouted
    assert len(ok.taken) == 10
    assert drv.rerouted == 5
    assert len(drv.requests) == 10


def test_openloop_driver_all_sick_keeps_accounted_target():
    from repro_torch.serving.frontend import OpenLoopDriver
    a, b = _StubFE(healthy=False), _StubFE(healthy=False)
    drv = OpenLoopDriver([a, b], list(range(6)), [0.0] * 6,
                         sleep=lambda s: None)
    drv.run()
    assert len(a.taken) == 3 and len(b.taken) == 3
    assert drv.rerouted == 0


def test_openloop_driver_reroute_opt_out():
    from repro_torch.serving.frontend import OpenLoopDriver
    sick, ok = _StubFE(healthy=False), _StubFE(healthy=True)
    drv = OpenLoopDriver([sick, ok], list(range(4)), [0.0] * 4,
                         sleep=lambda s: None, reroute=False)
    drv.run()
    assert len(sick.taken) == 2 and len(ok.taken) == 2
