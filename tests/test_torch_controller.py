"""The twins of ``tests/test_controller.py`` on the port, on the CPU:
one adaptive controller driving N data planes.  A controller-shared
fleet plans what standalone runtimes plan for the same traffic; the
snapshot worker lives on the controller; sampling backs off, disarms
(the instrumented twin swapped out) and re-arms on a control update, and
a pinned sampler never disarms; the recompile scheduler orders planes by
staleness x traffic, coalesces, survives a failing plane and never
overlaps two cycles of one plane; ``close`` tears the workers down while
the data planes serve on, and a closed runtime's collection leaves a
replacement plane of the same id alone; each build counts one cache
miss; instrumentation snapshots are read without the runtime lock from
a back buffer that tracks the traffic; ``RuntimeStats`` counters are
atomic and ``controller.stats()`` aggregates them.

Already twinned elsewhere: the scheduler's retry / give-up rules
(``test_torch_health.py``)."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import ControllerConfig, EngineConfig, \
    MorpheusController, MorpheusRuntime, RuntimeStats, SketchConfig, \
    Table, TableSet
from repro_torch.core import instrument
from repro_torch.core.controller import RecompileScheduler


def _user_step(params, ctx, batch):
    row = ctx.lookup("classes", batch["cls"], fields=("scale",))
    x = batch["x"] * row["scale"][:, None]
    if ctx.flag("boost", default=False):
        x = x + 1.0
    return x


def _scales(n, seed=0):
    return np.linspace(1.0, 2.0, n).astype(np.float32) + seed


N_VALID = 48      # > max_inline => the lookup site is instrumented


def _tables(seed=0):
    return TableSet([Table("classes", {"scale": _scales(N_VALID, seed)},
                           n_valid=N_VALID, instrument=True)])


def _batch():
    """Skewed deterministic traffic: 75% of lookups hit classes {0,1,2},
    so the traffic fast-path pass has a hot set to find."""
    cls = np.arange(16) % N_VALID
    cls[:12] = np.arange(12) % 3
    return {"cls": torch.from_numpy(cls.astype(np.int32)),
            "x": torch.ones((16, 4), dtype=torch.float32)}


def _mk(controller=None, seed=0, plane_id=None, sample_every=2):
    cfg = EngineConfig(sketch=SketchConfig(sample_every=sample_every,
                                           max_hot=4, hot_coverage=0.5),
                       device="cpu")
    return MorpheusRuntime(_user_step, _tables(seed), None, _batch(),
                           cfg=cfg, controller=controller,
                           plane_id=plane_id)


# ---------------------------------------------------------------------------
# fleet plan parity (acceptance criterion)
# ---------------------------------------------------------------------------

def test_fleet_plans_match_standalone():
    """4 runtimes sharing one controller must plan byte-identically to 4
    standalone runtimes for the same traffic — the controller changes
    who schedules/owns the loop, never what gets planned."""
    ctl = MorpheusController(ControllerConfig(workers=2))
    shared = [_mk(ctl, seed=i) for i in range(4)]
    solo = [_mk(seed=i) for i in range(4)]
    try:
        assert all(rt.exec_cache is ctl.exec_cache for rt in shared)
        for rt in shared + solo:
            for _ in range(6):
                rt.step(_batch())
        # fleet: cycles through the controller's bounded worker pool;
        # standalone: classic blocking recompiles
        assert ctl.schedule_all() == 4
        assert ctl.drain(timeout=120)
        assert ctl.scheduler.stats()["completed"] == 4
        for rt in solo:
            rt.recompile(block=True)
        for a, b in zip(shared, solo):
            assert a.plan.label.startswith("specialized")
            assert a.plan.sites == b.plan.sites
            assert a.plan.flags == b.plan.flags
            assert a.plan.signature == b.plan.signature
            torch.testing.assert_close(a.step(_batch()), b.step(_batch()),
                                       rtol=1e-6, atol=0)
    finally:
        ctl.close()
        for rt in solo:
            rt.close()


def test_runtime_owns_no_snapshot_worker():
    """The refactor's structural criterion: the snapshot worker lives on
    the controller, not the runtime."""
    rt = _mk()
    try:
        assert not hasattr(rt, "_snapshot_worker")
        rt.step(_batch())
        rt.recompile(block=True)
        w = rt.snapshot_worker
        assert rt.controller._workers[rt.plane_id] is w
        assert rt.last_snapshot.thread_ident == w._thread.ident
    finally:
        rt.close()


# ---------------------------------------------------------------------------
# adaptive sampling: back-off, disarm, re-arm
# ---------------------------------------------------------------------------

def test_sampling_backs_off_then_disarms_and_rearms():
    rt = _mk()
    K = rt.sampler.disarm_after
    try:
        for _ in range(6):
            rt.step(_batch())
        rt.recompile(block=True)          # generic -> specialized: churn
        assert rt.sampler.armed
        e0 = rt.sampler.sample_every
        for _ in range(K):                # K consecutive stable cycles
            rt.step(_batch())
            rt.recompile(block=True)
        # cadence backed off while armed, then the twin was swapped out
        assert not rt.sampler.armed
        assert rt.sampler.duty_cycle() == 0.0
        assert rt.state.instr == {}           # no sketches in the state
        assert rt.instr_exec is rt.exec       # twin IS the specialized
        # ...but the specialization survives: disarmed cycles plan from
        # the profile retained at the last sampled window
        assert rt.plan.label.startswith("specialized")
        sig = rt.plan.signature
        assert any(s.impl == "hot_cache" for _, s in rt.plan.sites)
        i0 = rt.stats.instr_steps
        for _ in range(8):
            rt.step(_batch())
        assert rt.stats.instr_steps == i0     # zero instrumentation cost
        info = rt.recompile(block=True)       # disarmed cycles revalidate
        assert info["revalidated"] is True
        assert rt.plan.signature == sig
        # control update -> re-arm: cadence restored, twin reinstalled
        rt.control_update("classes", {"scale": _scales(N_VALID, 1)})
        assert rt.sampler.armed
        assert rt.sampler.sample_every <= e0
        rt.recompile(block=True)
        assert "classes#0" in rt.state.instr
        assert rt.instr_exec is not rt.exec
        assert rt.sampler.duty_cycle() > 0.0
        s0 = rt.stats.instr_steps
        for _ in range(4):
            rt.step(_batch())
        assert rt.stats.instr_steps > s0      # sampling again
    finally:
        rt.close()


def test_pinned_sampler_never_disarms():
    rt = _mk()
    try:
        rt.sampler.pin(2)
        for _ in range(4):
            rt.step(_batch())
        for _ in range(8):                    # way past disarm_after
            rt.recompile(block=True)
        assert rt.sampler.armed
        assert rt.sampler.sample_every == 2
    finally:
        rt.close()


# ---------------------------------------------------------------------------
# recompile scheduler
# ---------------------------------------------------------------------------

class _StubPlane:
    def __init__(self, name, prio, log, started=None, gate=None):
        self._name, self._prio, self._log = name, prio, log
        self._started, self._gate = started, gate

    def recompile_priority(self):
        return self._prio

    def _recompile_now(self):
        if self._started is not None:
            self._started.set()
        if self._gate is not None:
            assert self._gate.wait(timeout=10)
        self._log.append(self._name)


def test_scheduler_priority_and_coalescing():
    """With one worker busy, queued planes run in staleness x traffic
    priority order, and re-submitting a pending plane coalesces."""
    sched = RecompileScheduler(workers=1)
    log, started, gate = [], threading.Event(), threading.Event()
    blocker = _StubPlane("blocker", 1.0, log, started, gate)
    lo = _StubPlane("lo", 1.0, log)
    hi = _StubPlane("hi", 100.0, log)
    try:
        assert sched.submit("blocker", blocker) is True
        assert started.wait(timeout=10)       # worker busy on blocker
        assert sched.submit("lo", lo) is True
        assert sched.submit("hi", hi) is True
        assert sched.submit("lo", lo) is False          # coalesced
        gate.set()
        assert sched.drain(timeout=10)
        assert log == ["blocker", "hi", "lo"]
        st = sched.stats()
        assert st["scheduled"] == 3 and st["coalesced"] == 1
        assert st["completed"] == 3 and st["workers"] == 1
    finally:
        sched.close()


def test_scheduler_survives_a_failing_plane():
    sched = RecompileScheduler(workers=1)
    log = []

    class _Bad:
        def recompile_priority(self):
            return 1.0

        def _recompile_now(self):
            raise RuntimeError("boom")

    bad, ok = _Bad(), _StubPlane("ok", 1.0, log)   # the scheduler holds
    try:                                           # weakrefs: keep these
        sched.submit("bad", bad)                   # alive ourselves
        sched.submit("ok", ok)
        assert sched.drain(timeout=10)
        assert log == ["ok"]
        st = sched.stats()
        assert st["failed"] == 1 and st["completed"] == 1
        assert isinstance(sched.last_error, RuntimeError)
    finally:
        sched.close()


def test_scheduler_never_overlaps_cycles_for_one_plane():
    """Hammer one plane with scheduled cycles from a 4-worker pool while
    the control plane churns: the pool must never run two cycles for the
    same plane concurrently."""
    ctl = MorpheusController(ControllerConfig(workers=4))
    rt = _mk(ctl)
    lk = threading.Lock()
    active, max_active = [0], [0]
    orig = rt._recompile_now

    def wrapped():
        with lk:
            active[0] += 1
            max_active[0] = max(max_active[0], active[0])
        try:
            time.sleep(0.005)
            return orig()
        finally:
            with lk:
                active[0] -= 1

    rt._recompile_now = wrapped
    try:
        for i in range(10):
            rt.control_update("classes", {"scale": _scales(N_VALID, i)})
            ctl.schedule(rt)
            rt.step(_batch())
        assert ctl.drain(timeout=120)
        assert max_active[0] == 1
        assert ctl.scheduler.stats()["completed"] >= 1
        assert ctl.scheduler.stats()["running"] == 0
    finally:
        ctl.close()


def test_recompile_priority_orders_stale_hot_planes_first():
    ctl = MorpheusController()
    a, b = _mk(ctl), _mk(ctl)
    try:
        for _ in range(10):
            a.step(_batch())
        a.tables.bump_version("drift")
        a.tables.bump_version("drift")
        assert a.recompile_priority() > b.recompile_priority()
    finally:
        ctl.close()


# ---------------------------------------------------------------------------
# teardown
# ---------------------------------------------------------------------------

def test_controller_close_tears_down_workers_cleanly():
    ctl = MorpheusController(ControllerConfig(workers=2))
    rt = _mk(ctl)
    rt.step(_batch())
    rt.recompile(block=True)                # creates the snapshot worker
    worker_thread = rt.snapshot_worker._thread
    ctl.schedule(rt)
    assert ctl.drain(timeout=120)
    pool_threads = list(ctl.scheduler._threads)
    assert pool_threads
    ctl.close()
    assert not worker_thread.is_alive()
    assert all(not t.is_alive() for t in pool_threads)
    with pytest.raises(RuntimeError):
        rt.recompile(block=True)            # no silent resurrection
    with pytest.raises(RuntimeError):
        ctl.schedule(rt)
    out = rt.step(_batch())                 # the data plane keeps serving
    assert torch.isfinite(out).all()
    ctl.close()                             # idempotent


def test_closed_runtime_gc_does_not_unregister_replacement_plane():
    """close() must detach the GC finalizer: a dead runtime's later GC
    must not tear down a NEW plane registered under the same plane_id."""
    import gc
    ctl = MorpheusController()
    rt1 = _mk(ctl, plane_id="p")
    rt1.close()
    rt2 = _mk(ctl, plane_id="p")        # the id is free again
    del rt1
    gc.collect()
    try:
        assert "p" in ctl.planes()
        rt2.step(_batch())
        assert rt2.recompile(block=True) is not None
    finally:
        ctl.close()


def test_cache_miss_accounting_counts_each_compile_once():
    """The runtime probes before routing misses through get_or_compile —
    each compiled executable must register exactly one cache miss."""
    rt = _mk()
    try:
        rt.step(_batch())
        rt.recompile(block=True)
        s = rt.exec_cache.stats
        assert s.misses == s.inserts
    finally:
        rt.close()


def test_runtime_close_detaches_only_its_plane():
    ctl = MorpheusController()
    a, b = _mk(ctl, seed=0), _mk(ctl, seed=1)
    try:
        for rt in (a, b):
            rt.step(_batch())
        a.recompile(block=True)
        a.close()                           # shared controller survives
        with pytest.raises(RuntimeError):
            a.recompile(block=True)
        assert b.recompile(block=True) is not None
        assert a.plane_id not in ctl.planes()
        assert b.plane_id in ctl.planes()
    finally:
        ctl.close()


# ---------------------------------------------------------------------------
# lock-free instrumentation snapshots (double buffer)
# ---------------------------------------------------------------------------

def test_instr_snapshot_taken_without_runtime_lock():
    """The acceptance criterion for the double-buffered sketches: the
    host readout completes while another thread holds the runtime lock
    (i.e. mid-step), because it reads the published back buffer."""
    rt = _mk()
    try:
        seq0 = rt._backbuf.seq
        for _ in range(4):
            rt.step(_batch())
        assert rt._backbuf.seq > seq0       # sampled steps published
        got = {}

        def reader():
            got["snap"] = rt._host_instr_snapshot()

        with rt._lock:                      # the serving critical section
            th = threading.Thread(target=reader)
            th.start()
            th.join(timeout=10)
            assert not th.is_alive(), \
                "_host_instr_snapshot blocked on the runtime lock"
        snap = got["snap"]
        assert "classes#0" in snap
        assert int(snap["classes#0"]["total"]) > 0
    finally:
        rt.close()


def test_back_buffer_tracks_recorded_traffic():
    """The back buffer is not an approximation: sketches only advance on
    sampled steps, each of which republishes — so the snapshot's hot
    keys match the traffic."""
    rt = _mk()
    try:
        for _ in range(8):
            rt.step(_batch())
        snap = rt._host_instr_snapshot()
        hot, cov, total = instrument.hot_keys(
            snap["classes#0"], rt.engine.cfg.sketch)
        assert set(hot[:3].tolist()) == {0, 1, 2}
        assert total > 0
    finally:
        rt.close()


# ---------------------------------------------------------------------------
# atomic stats + fleet aggregation
# ---------------------------------------------------------------------------

def test_runtime_stats_counters_are_atomic():
    st = RuntimeStats()

    def w():
        for _ in range(2000):
            st.bump(steps=1, cache_hits=2)
            st.log("t1_history", 0.0)

    ths = [threading.Thread(target=w) for _ in range(8)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    assert st.steps == 16000
    assert st.cache_hits == 32000
    assert len(st.t1_history) == 16000
    snap = st.snapshot()
    assert snap["steps"] == 16000
    assert snap["t1_history"] is not st.t1_history   # a copy


def test_controller_stats_aggregates_across_planes():
    ctl = MorpheusController()
    a, b = _mk(ctl, plane_id="a"), _mk(ctl, plane_id="b")
    try:
        for _ in range(3):
            a.step(_batch())
            b.step(_batch())
        a.recompile(block=True)
        s = ctl.stats()
        assert set(s.planes) == {"a", "b"}
        assert s.totals["steps"] == a.stats.steps + b.stats.steps == 6
        assert s.totals["recompiles"] == 1
        assert s.sampling["a"]["armed"] is True
        assert 0.0 <= s.sampling["a"]["duty_cycle"] <= 1.0
        assert 0.0 <= s.cache_hit_rate <= 1.0
        assert s.scheduler["workers"] == 0    # pool spawns lazily
    finally:
        ctl.close()
