"""The port's request-level serving frontend on the CPU.

The twins of all 18 tests of ``tests/test_frontend.py`` (every clock
virtual, no wall-clock assertion): the histogram and the ``RuntimeStats``
series; the ragged->bucket packer and its mask; admission control and
deadline shedding; a mid-serve control update that deopts without
dropping or reordering requests; open-loop arrivals byte-identical to
one-per-batch execution; BatchShapePass selecting buckets and K from the
profile, its hysteresis, and the mispredict deopt; ``step_many`` on pad
bucket structures at any K (the reference fails this one: its
``lax.scan`` window differs from its unfused oracle in the last bits;
the port's window is the single step's closure, so it passes bit for
bit); ``warm_fused`` building every role.

Then the port against the reference under one virtual clock, the same
rows and the same weights: equal request statuses and timings, the same
(bucket, K) window sequence, equal counters and histograms, an equal
``ArrivalProfile.snapshot()``, an equal plan fingerprint after a
recompile from that profile, and outputs within ``TOL``.
"""
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JEngineConfig, \
    MorpheusRuntime as JRuntime, SketchConfig as JSketchConfig
from repro.serving import ServeConfig as JServeConfig, \
    build_params as j_build_params, build_tables as j_build_tables, \
    make_request_rows as j_make_request_rows, \
    make_serve_step as j_make_serve_step, \
    make_synthetic_batch as j_make_synthetic_batch
from repro.serving.frontend import FrontendConfig as JFrontendConfig, \
    ServingFrontend as JServingFrontend
from repro.testing.fingerprint import plan_fingerprint as j_fingerprint
from repro_torch.core import BATCH_SHAPE_SITE, EngineConfig, \
    MorpheusRuntime, RuntimeStats, SketchConfig, StreamingHistogram, \
    plan_batch_shape
from repro_torch.serving import ServeConfig, build_params, build_tables, \
    make_request_batch, make_request_rows, make_serve_step, \
    make_synthetic_batch, params_from_numpy
from repro_torch.serving.frontend import FrontendConfig, OpenLoopDriver, \
    Request, RequestQueue, ServingFrontend, bursty_onoff_gaps, \
    poisson_gaps
from repro_torch.testing.fingerprint import plan_fingerprint

TINY = dict(d_model=32, n_layers=1, n_heads=4, vocab=128, n_experts=4,
            d_ff=32, n_classes=8, n_slots=32, seq=4)
CFG = ServeConfig(**TINY)
TOL = dict(rtol=1e-4, atol=1e-4)      # test_torch_serving.py's
FEATURES = {"vision_enabled": False, "track_sessions": True}
SKETCH = dict(sample_every=2, max_hot=4, hot_coverage=0.6)


def _engine_cfg():
    return EngineConfig(sketch=SketchConfig(**SKETCH),
                        features=dict(FEATURES),
                        moe_router_table="router", device="cpu")


def _mk_rt(cfg=CFG, seed=0, batch_size=8, params=None, example=None):
    return MorpheusRuntime(
        make_serve_step(cfg), build_tables(cfg),
        params if params is not None else build_params(cfg, seed, "cpu"),
        example if example is not None else make_synthetic_batch(
            cfg, seed, batch_size, device="cpu"),
        cfg=_engine_cfg())


def _rows(seed, n):
    return make_request_rows(CFG, seed, n)


class FakeClock:
    """Virtual monotonic clock for deterministic queue/deadline tests."""

    def __init__(self, t=100.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


class StubProfile:
    """A fixed profile snapshot — drives BatchShapePass deterministically."""

    def __init__(self, d):
        self.d = dict(d)

    def snapshot(self):
        return dict(self.d)


def _profile_dict(size_hist, rate, ladder=(1, 2, 4, 8), max_wait=2e-3,
                  k_max=4):
    return {"ladder": ladder, "max_wait_s": max_wait,
            "window_k_max": k_max, "arrival_rate_hz": rate,
            "size_hist": tuple(size_hist)}


# ---------------------------------------------------------------------------
# StreamingHistogram + RuntimeStats (one quantile implementation for
# step AND request latency)
# ---------------------------------------------------------------------------

def test_histogram_quantiles_match_numpy():
    rng = np.random.default_rng(0)
    xs = rng.lognormal(mean=-6.0, sigma=1.5, size=20_000)
    h = StreamingHistogram()
    h.observe_all(xs)
    for q in (0.1, 0.5, 0.9, 0.99):
        exact = float(np.quantile(xs, q))
        # geometric buckets: ~5.1% relative bucket width
        assert h.quantile(q) == pytest.approx(exact, rel=0.06)
    assert h.quantile(0.0) == pytest.approx(xs.min(), rel=0.06)
    assert h.quantile(1.0) == pytest.approx(xs.max(), rel=0.06)
    assert h.mean == pytest.approx(xs.mean(), rel=1e-6)


def test_histogram_merge_equals_union():
    rng = np.random.default_rng(1)
    a, b = rng.exponential(0.01, 5000), rng.exponential(0.1, 5000)
    ha, hb, hu = (StreamingHistogram() for _ in range(3))
    ha.observe_all(a)
    hb.observe_all(b)
    hu.observe_all(np.concatenate([a, b]))
    ha.merge(hb)
    for q in (0.25, 0.5, 0.99):
        assert ha.quantile(q) == pytest.approx(hu.quantile(q), rel=1e-9)
    assert ha.summary()["count"] == 10_000


def test_histogram_empty():
    h = StreamingHistogram()
    assert math.isnan(h.quantile(0.5))
    assert h.summary() == {"count": 0}


def test_stats_observe_many_and_quantiles():
    s = RuntimeStats()
    s.observe_many({"request_total_s": [0.01, 0.02, 0.03],
                    "request_queue_wait_s": [0.001]},
                   requests_completed=3, slo_met=2, slo_missed=1)
    assert s.requests_completed == 3 and s.slo_met == 2
    assert s.locked_calls == 1                # one lock for all of it
    assert s.quantile("request_total_s", 0.5) == pytest.approx(
        0.02, rel=0.06)
    assert math.isnan(s.quantile("no_such_series", 0.5))
    snap = s.snapshot()
    assert snap["hists"]["request_total_s"]["count"] == 3
    s.reset_hist("request_total_s")
    assert math.isnan(s.quantile("request_total_s", 0.5))
    # the untouched series survives a selective reset
    assert s.quantile("request_queue_wait_s", 0.5) > 0


# ---------------------------------------------------------------------------
# ragged -> bucket packer
# ---------------------------------------------------------------------------

def test_request_batch_shapes_and_mask():
    rows = _rows(0, 3)
    b = make_request_batch(rows, 8)
    assert b["tokens"].shape == (8, CFG.seq)
    assert b["valid"].shape == (8,) and b["valid"].dtype == torch.bool
    assert b["valid"].tolist() == [True] * 3 + [False] * 5
    # pad rows replicate row 0 (identical values on duplicated slots)
    assert torch.equal(b["tokens"][3:], b["tokens"][:1].expand(5, -1))
    assert torch.equal(b["slot"][3:], b["slot"][:1].expand(5))
    with pytest.raises(ValueError):
        make_request_batch([], 4)
    with pytest.raises(ValueError):
        make_request_batch(rows, 2)


def test_request_windows_and_fleet_helpers():
    """``make_request_windows`` draws K distinct batches of the asked size,
    the same for the same seed; ``build_fleet`` gives N planes one step
    function and N distinct TableSets with the reference's contents."""
    from repro_torch.serving import build_fleet, make_request_windows
    w = make_request_windows(CFG, 4, 3, batch_size=5, device="cpu")
    assert len(w) == 3 and w[0]["tokens"].shape == (5, CFG.seq)
    assert not torch.equal(w[0]["tokens"], w[1]["tokens"])
    again = make_request_windows(CFG, 4, 3, batch_size=5, device="cpu")
    assert all(torch.equal(a[f], b[f]) for a, b in zip(w, again)
               for f in a)
    fleet = build_fleet(CFG, 3)
    assert len({id(step) for step, _ in fleet}) == 1
    assert len({id(tables) for _, tables in fleet}) == 3
    ref = j_build_tables(JServeConfig(**TINY), None)
    for _, tables in fleet:
        np.testing.assert_array_equal(
            np.asarray(tables["vocab_embed"].fields["vec"]),
            np.asarray(ref["vocab_embed"].fields["vec"]))


def test_masked_rows_never_perturb_real_rows():
    """Same real rows, different pad-row contents, same bucket: the real
    rows' outputs are byte-identical.  And the pad rows, copies of row
    0, compute row 0's output bit for bit, so the sessions table's
    last-write-wins scatter writes identical values on the duplicated
    slot whichever copy it keeps."""
    rt = _mk_rt()
    try:
        rows = _rows(3, 8)
        real, junk = rows[:3], rows[3:]
        b_pad = make_request_batch(real, 8)          # pads = row-0 copies
        b_junk = make_request_batch(real + junk, 8)  # "pads" = junk rows
        out_pad = rt.run_generic(b_pad)
        out_junk = rt.run_generic(b_junk)
        assert torch.equal(out_pad[:3], out_junk[:3])
        for i in range(3, 8):
            assert torch.equal(out_pad[i], out_pad[0])
        rt.step(b_pad)
        slot = int(b_pad["slot"][0])
        last = rt.state.tables["sessions"]["last_token"][slot]
        assert int(last) == int(out_pad[0, -1].argmax())
    finally:
        rt.close()


# ---------------------------------------------------------------------------
# queue: admission control + deadline shedding
# ---------------------------------------------------------------------------

def test_queue_full_rejects_at_submit():
    rt = _mk_rt()
    try:
        clock = FakeClock()
        fe = ServingFrontend(rt, FrontendConfig(capacity=4, max_batch=4),
                             clock=clock)
        reqs = [fe.submit(r) for r in _rows(0, 6)]
        assert [r.status for r in reqs] == ["pending"] * 4 + \
            ["rejected"] * 2
        assert reqs[4].done and reqs[4].output is None
        assert reqs[4].reason == "QUEUE_FULL"
        assert rt.stats.requests_submitted == 6
        assert rt.stats.requests_rejected == 2
    finally:
        rt.close()


def test_admission_reads_the_planes_health():
    """The admission gate reads the plane's real ``PlaneHealth`` from the
    controller: healthy, it admits; degraded, it rejects at the door with
    ``PLANE_DEGRADED``, accounted apart."""
    rt = _mk_rt()
    try:
        fe = ServingFrontend(rt, FrontendConfig(capacity=8, max_batch=4),
                             clock=FakeClock())
        health = rt.controller.health_for(rt.plane_id)
        assert fe._health() is health and fe.plane_healthy
        rows = _rows(1, 2)
        assert fe.submit(rows[0]).status == "pending"
        health.on_fault("test fault", steps=rt.stats.steps)
        assert not fe.plane_healthy
        r = fe.submit(rows[1])
        assert (r.status, r.reason) == ("rejected", "PLANE_DEGRADED")
        assert rt.stats.requests_rejected_degraded == 1
        assert rt.stats.requests_rejected == 1
        assert rt.stats.requests_submitted == 2
    finally:
        rt.close()


def test_queue_sheds_deadline_expiring_between_admission_and_take():
    """A request admitted with its deadline ahead but past it by the
    time the batcher takes comes back *shed*, without consuming a
    ``max_n`` slot; ``now == deadline`` exactly is already late."""
    clock = FakeClock()
    q = RequestQueue(capacity=8)
    expiring = Request(id=0, payload="a", arrival_ts=clock(),
                       deadline=clock() + 0.05)
    exact = Request(id=1, payload="b", arrival_ts=clock(),
                    deadline=clock() + 0.10)
    live = Request(id=2, payload="c", arrival_ts=clock(),
                   deadline=clock() + 99.0)
    assert q.submit(expiring) and q.submit(exact) and q.submit(live)
    assert len(q) == 3
    clock.advance(0.10)            # expiring now past, exact == now
    ready, shed = q.take(1, clock())
    assert [r.id for r in shed] == [0, 1]
    assert [r.id for r in ready] == [2]    # shed never ate the slot
    assert len(q) == 0
    # shed_expired=False: the policy knob hands even late requests out
    q2 = RequestQueue(capacity=8, shed_expired=False)
    late = Request(id=3, payload="d", arrival_ts=clock(),
                   deadline=clock() - 1.0)
    assert q2.submit(late)
    ready, shed = q2.take(4, clock())
    assert [r.id for r in ready] == [3] and shed == []


def test_deadline_expired_requests_are_shed():
    rt = _mk_rt()
    try:
        clock = FakeClock()
        fe = ServingFrontend(rt, FrontendConfig(capacity=16, max_batch=4,
                                                max_wait_s=0.0),
                             clock=clock)
        rows = _rows(0, 3)
        late = [fe.submit(r, deadline_s=0.01) for r in rows[:2]]
        live = fe.submit(rows[2], deadline_s=10.0)
        clock.advance(0.02)            # both deadlines now in the past
        assert fe.pump() == 1          # only the live request dispatched
        assert fe.drain()
        assert [r.status for r in late] == ["shed", "shed"]
        assert late[0].reason == "DEADLINE_EXPIRED"
        assert late[0].timing["total_s"] == pytest.approx(0.02)
        assert live.status == "ok" and live.slo_met is True
        assert rt.stats.requests_shed == 2
        assert rt.stats.requests_completed == 1
    finally:
        rt.close()


# ---------------------------------------------------------------------------
# mid-serve control update: deopt, no drops, no reorder
# ---------------------------------------------------------------------------

def test_midserve_control_update_keeps_fifo_and_completes_all():
    rt = _mk_rt()
    try:
        fe = ServingFrontend(rt, FrontendConfig(
            capacity=64, max_batch=4, ladder=(4,), window_k_max=1,
            max_wait_s=0.0), clock=FakeClock())
        reqs = [fe.submit(r) for r in _rows(0, 12)]
        assert fe.pump() == 4          # first window out the door
        d0 = rt.stats.deopt_steps
        rt.control_update("req_class", {"temperature": np.full(
            CFG.n_classes, 1.3, np.float32)})
        assert fe.drain(timeout=120.0)
        assert [r.status for r in reqs] == ["ok"] * 12
        assert rt.stats.requests_completed == 12
        # the post-update windows ran the generic deopt target
        assert rt.stats.deopt_steps > d0
        # strict FIFO: requests were taken in submission order
        order = [r.id for r in reqs]
        taken = [r._taken_ts for r in reqs]
        assert order == sorted(order)
        assert all(a <= b for a, b in zip(taken, taken[1:]))
    finally:
        rt.close()


def _held(fn, entered, release, when=lambda *a, **kw: True):
    """``fn`` that, on a call ``when`` picks, sets ``entered`` and waits
    for ``release`` before it runs."""
    def held(*a, **kw):
        if when(*a, **kw):
            entered.set()
            assert release.wait(60)
        return fn(*a, **kw)
    return held


@pytest.mark.parametrize("hold", ["dispatch", "retire"])
def test_drain_waits_until_every_taken_request_is_finished(hold):
    """The port's ``drain`` returns only once every taken request is
    finished and counted: not while the batcher thread holds rows taken
    from the queue before they are in flight (``place_batch`` held), nor
    while it retires a window whose counters are not yet written (the
    window's stats call held).  The reference's ``drain`` reads only the
    queue and ``inflight``, which are both empty at either point
    (ROADMAP Queue 3)."""
    rt = _mk_rt()
    fe = ServingFrontend(rt, FrontendConfig(
        capacity=64, max_batch=4, ladder=(4,), window_k_max=1,
        max_wait_s=0.0))
    entered, release = threading.Event(), threading.Event()
    if hold == "dispatch":
        rt.place_batch = _held(rt.place_batch, entered, release)
    else:
        rt.stats.observe_many = _held(
            rt.stats.observe_many, entered, release,
            lambda *a, **kw: "requests_completed" in kw)
    try:
        reqs = [fe.submit(r) for r in _rows(0, 4)]   # one whole window
        fe.start()
        assert entered.wait(60)
        if hold == "dispatch":
            assert len(fe.queue) == 0 and fe.batcher.inflight == 0
        assert fe.batcher.busy
        assert not fe.drain(timeout=0.2)
        release.set()
        assert fe.drain(timeout=120.0)
        assert [r.status for r in reqs] == ["ok"] * 4
        assert rt.stats.requests_completed == 4
    finally:
        release.set()
        fe.stop()
        rt.close()


# ---------------------------------------------------------------------------
# E2E: open-loop arrivals, byte-identical outputs
# ---------------------------------------------------------------------------

def test_e2e_poisson_outputs_byte_identical_to_one_per_batch():
    """Poisson arrivals (on a virtual clock) through the full
    queue->batcher->step_many path, with a single-slot bucket ladder so
    every request runs as a one-per-batch execution: outputs equal the
    generic oracle on the same single-request batch, bit for bit."""
    rt = _mk_rt()
    try:
        clock = FakeClock()
        fe = ServingFrontend(rt, FrontendConfig(
            capacity=64, max_batch=1, ladder=(1,), window_k_max=4,
            max_wait_s=1e-4), clock=clock)
        rows = _rows(7, 24)
        driver = OpenLoopDriver([fe], rows, poisson_gaps(2000.0, 24,
                                                         seed=1),
                                sleep=clock.advance)
        driver.run()                   # inline: deterministic arrivals
        assert fe.drain(timeout=120.0)
        assert rt.stats.requests_completed == 24
        for r in driver.requests:
            assert r.status == "ok"
            ref = rt.run_generic(make_request_batch([r.payload], 1))
            assert torch.equal(r.output, ref[0])
            assert set(r.timing) == {"queue_wait_s", "batch_wait_s",
                                     "execute_s", "total_s"}
        # arrivals were spread on the virtual clock
        assert driver.requests[-1].arrival_ts > driver.requests[0].\
            arrival_ts
        assert rt.stats.quantile("request_total_s", 0.5) >= 0
        assert rt.stats.hist("request_total_s").count == 24
    finally:
        rt.close()


def test_arrival_generators_hit_target_rate():
    for fn in (poisson_gaps, bursty_onoff_gaps):
        gaps = fn(500.0, 4000, seed=0)
        assert float(np.mean(gaps)) == pytest.approx(1 / 500.0, rel=0.1)


# ---------------------------------------------------------------------------
# BatchShapePass: profile -> (buckets, K) in plan.sites
# ---------------------------------------------------------------------------

def test_batch_shape_pass_selects_from_profile():
    rt = _mk_rt()
    try:
        hist = [0] * 8
        hist[0], hist[3] = 10, 10      # half size-1, half size-4 groups
        rt.attach_profile(StubProfile(_profile_dict(hist, rate=8000.0)))
        rt.recompile(block=True)
        sig_a = rt.plan.signature
        assert plan_batch_shape(rt.plan) == ((1, 4), 4)
        assert BATCH_SHAPE_SITE in dict(rt.plan.sites)
        # the pseudo-site never reaches lookup dispatch: serving works
        out = rt.step(make_synthetic_batch(CFG, 1, 8, device="cpu"))
        assert bool(torch.isfinite(out).all())

        # a drifted profile is a genuinely different plan (new signature
        # => new executables => atomic swap), not a mutation in place
        hist2 = [0] * 8
        hist2[7] = 20                  # all groups size 8 now, light rate
        rt.attach_profile(StubProfile(_profile_dict(hist2, rate=100.0)))
        rt.recompile(block=True)
        assert plan_batch_shape(rt.plan) == ((8,), 1)
        assert rt.plan.signature != sig_a
    finally:
        rt.close()


def test_batch_shape_hysteresis_stabilizes_edge_hovering():
    """Traffic hovering at a bucket edge converges to a stable bucket
    superset instead of flipping the plan signature every cycle; a
    regime change still takes the fresh selection outright."""
    rt = _mk_rt()
    try:
        edge = [0] * 8
        edge[2], edge[3], edge[4] = 7, 7, 6
        rt.attach_profile(StubProfile(_profile_dict(edge,
                                                    rate=16000.0)))
        rt.recompile(block=True)
        assert plan_batch_shape(rt.plan) == ((4, 8), 4)
        sig = rt.plan.signature

        edge_up = [0] * 8
        edge_up[3], edge_up[4] = 6, 14
        rt.attach_profile(StubProfile(_profile_dict(edge_up,
                                                    rate=12000.0)))
        reval = rt.stats.revalidations
        rt.recompile(block=True)
        assert plan_batch_shape(rt.plan) == ((4, 8), 4)
        assert rt.plan.signature == sig
        assert rt.stats.revalidations == reval + 1   # no swap

        hist1 = [0] * 8
        hist1[0] = 20
        rt.attach_profile(StubProfile(_profile_dict(hist1, rate=100.0)))
        rt.recompile(block=True)
        assert plan_batch_shape(rt.plan) == ((1,), 1)
        assert rt.plan.signature != sig
    finally:
        rt.close()


def test_e2e_batch_shape_selected_from_observed_traffic():
    """Inject a size-4-group arrival pattern; after warmup the recompiled
    plan's bucket set matches the injected distribution."""
    rt = _mk_rt()
    try:
        clock = FakeClock()
        fe = ServingFrontend(rt, FrontendConfig(
            capacity=64, max_batch=8, ladder=(1, 2, 4, 8),
            window_k_max=1, max_wait_s=1e-4), clock=clock)
        for i in range(20):            # 20 groups of exactly 4
            for r in _rows(i, 4):
                fe.submit(r)
                clock.advance(1e-3)    # 1000 req/s on the virtual clock
            fe.pump()
        assert fe.drain(timeout=120.0)
        assert rt.stats.requests_completed == 80
        rt.recompile(block=True)
        shape = plan_batch_shape(rt.plan)
        assert shape is not None, "BatchShapePass did not fire"
        buckets, k = shape
        assert buckets == (4,)         # the injected group size's bucket
        assert k == 1                  # 1000 req/s can't fill K>1 windows
        assert fe.batcher.current_shape() == ((4,), 1)
    finally:
        rt.close()


def test_bucket_mispredict_deopts_through_program_guard():
    rt = _mk_rt()
    try:
        clock = FakeClock()
        fe = ServingFrontend(rt, FrontendConfig(
            capacity=64, max_batch=8, ladder=(1, 8), window_k_max=1,
            max_wait_s=0.0, mispredict_window=8, mispredict_deopt=0.4),
            clock=clock)
        # plan buckets = (8,) only — then serve size-1 groups, whose
        # ideal ladder bucket (1) the plan does not offer
        hist = [0] * 8
        hist[7] = 20
        rt.attach_profile(StubProfile(_profile_dict(
            hist, rate=100.0, ladder=(1, 8))))
        rt.recompile(block=True)
        assert plan_batch_shape(rt.plan) == ((8,), 1)
        rt.attach_profile(fe.profile)  # back to the live profile
        v0 = rt.tables.version
        for r in _rows(2, 20):         # one-at-a-time => size-1 groups
            fe.submit(r)
            clock.advance(1e-3)
            fe.pump()
        assert fe.drain(timeout=120.0)
        assert rt.stats.shape_mispredicts >= 8
        assert rt.tables.version > v0, "mispredict did not bump version"
        rt.recompile(block=True)
        buckets, _ = plan_batch_shape(rt.plan)
        assert buckets == (1,)
    finally:
        rt.close()


# ---------------------------------------------------------------------------
# step_many on non-example structures + warm_fused
# ---------------------------------------------------------------------------

def test_step_many_serves_bucket_shapes_at_any_k():
    rt = _mk_rt()
    try:
        b = make_request_batch(_rows(5, 3), 4)   # not the example shape
        ref = rt.run_generic(b)
        out1 = rt.step_many([b])                 # K=1, bucket structure
        assert out1.shape[0] == 1
        assert torch.equal(out1[0], ref)
        out2 = rt.step_many([b, b])              # K=2 fused window
        assert torch.equal(out2[0], ref)
        assert torch.equal(out2[1], ref)
    finally:
        rt.close()


def test_warm_fused_precompiles_every_role():
    """After warm_fused, serving that shape never builds inline —
    sampled windows (instrumented twin) and deopt windows (generic)
    included."""
    rt = _mk_rt()
    try:
        b = make_request_batch(_rows(6, 4), 4)
        rt.warm_fused([b])
        rt.warm_fused([b, b])
        misses0 = rt.exec_cache.stats.misses
        i0 = rt.stats.instr_steps
        for _ in range(4):             # crosses the sampling cadence
            rt.step_many([b])
        rt.step_many([b, b])
        assert rt.stats.instr_steps > i0
        rt.control_update("req_class", {"temperature": np.full(
            CFG.n_classes, 1.1, np.float32)})
        d0 = rt.stats.deopt_steps
        rt.step_many([b])              # guard-tripped => generic, warm
        assert rt.stats.deopt_steps == d0 + 1
        assert rt.exec_cache.stats.misses == misses0
    finally:
        rt.close()


# ---------------------------------------------------------------------------
# the port's frontend against the reference's
# ---------------------------------------------------------------------------

COUNTERS = ("requests_submitted", "requests_rejected", "requests_shed",
            "requests_completed", "slo_met", "slo_missed", "batches_formed",
            "pad_rows", "shape_mispredicts", "requests_failed",
            "requests_rejected_degraded", "steps", "deopt_steps",
            "instr_steps", "batch_transfers")


def _drive(fe, rt, clock, rows):
    """One scripted workload, identical for both packages: ragged groups
    at 8000 req/s, a burst past the queue's capacity, expiring deadlines,
    then a recompile from the live profile and a fast stream that fills
    fused windows.  Returns the requests, the (bucket, K) of every
    dispatched window and the plans' shapes."""
    windows = []
    real = rt.step_many

    def tapped(batches, k=None):
        windows.append((int(batches["tokens"].shape[1]), k))
        return real(batches, k=k)

    rt.step_many = tapped
    reqs, it = [], iter(rows)
    try:
        for g in [1, 3, 4, 2, 4, 4, 1, 4, 3, 4, 2, 4, 4, 1, 4, 4, 3, 4]:
            for _ in range(g):
                reqs.append(fe.submit(next(it)))
                clock.advance(1.0 / 8000)
            fe.pump()
        for _ in range(30):                   # past the capacity of 24
            reqs.append(fe.submit(next(it)))
        while fe.pump() > 0:
            pass
        for _ in range(3):                    # late by the time of take
            reqs.append(fe.submit(next(it), deadline_s=1e-3))
        reqs.append(fe.submit(next(it), deadline_s=1.0))
        clock.advance(5e-3)
        while fe.pump() > 0:
            pass
        fe.batcher.retire_all()
        rt.recompile(block=True)
        shape = plan_batch_shape(rt.plan)
        for _ in range(40):                   # 16000 req/s
            reqs.append(fe.submit(next(it)))
            clock.advance(1.0 / 16000)
        while fe.pump() > 0:
            pass
        fe.batcher.retire_all()
    finally:
        del rt.step_many
    return reqs, windows, shape


@pytest.fixture(scope="module")
def frontend_pair():
    """The reference's runtime and the port's over the same weights,
    tables and example batch, each behind a frontend on its own virtual
    clock, after the same scripted workload (``_drive``)."""
    jcfg = JServeConfig(**TINY)
    key = jax.random.PRNGKey(0)
    jparams = j_build_params(jcfg, key)
    bias = np.zeros(jcfg.n_experts, np.float32)
    bias[:2] = 4.0                           # a skewed router
    for lp in jparams["layers"]:
        lp["moe"]["b_router"] = jnp.asarray(bias)
    example = {k: np.asarray(v) for k, v in
               j_make_synthetic_batch(jcfg, key, 8).items()}
    jrt = JRuntime(j_make_serve_step(jcfg), j_build_tables(jcfg, key),
                   jparams, example,
                   cfg=JEngineConfig(sketch=JSketchConfig(**SKETCH),
                                     features=dict(FEATURES),
                                     moe_router_table="router"))
    rt = _mk_rt(params=params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu"), example=example)
    rows = j_make_request_rows(jcfg, jax.random.PRNGKey(11), 140)
    fcfg = dict(capacity=24, max_batch=8, ladder=(1, 2, 4, 8),
                max_wait_s=2e-3, window_k_max=4)
    jclock, clock = FakeClock(), FakeClock()
    jfe = JServingFrontend(jrt, JFrontendConfig(**fcfg), clock=jclock)
    fe = ServingFrontend(rt, FrontendConfig(**fcfg), clock=clock)
    try:
        yield (_drive(jfe, jrt, jclock, rows), jfe, jrt,
               _drive(fe, rt, clock, rows), fe, rt)
    finally:
        jrt.close()
        rt.close()


def test_frontend_statuses_windows_and_counters_equal_the_reference(
        frontend_pair):
    (jreqs, jwin, jshape), jfe, jrt, (reqs, win, shape), fe, rt = \
        frontend_pair
    assert [r.status for r in reqs] == [r.status for r in jreqs]
    assert [r.reason for r in reqs] == [r.reason for r in jreqs]
    assert [r.slo_met for r in reqs] == [r.slo_met for r in jreqs]
    assert [r.timing for r in reqs] == [r.timing for r in jreqs]
    statuses = {r.status for r in reqs}
    assert statuses == {"ok", "rejected", "shed"}
    assert win == jwin
    assert any(k > 1 for _, k in win), "no fused window formed"
    assert shape == jshape and shape is not None
    a, b = rt.stats.snapshot(), jrt.stats.snapshot()
    assert {c: a[c] for c in COUNTERS} == {c: b[c] for c in COUNTERS}
    assert a["hists"] == b["hists"]
    assert fe.profile.snapshot() == jfe.profile.snapshot()


def test_frontend_plan_fingerprint_equals_the_reference(frontend_pair):
    _, _, jrt, _, _, rt = frontend_pair
    assert BATCH_SHAPE_SITE in dict(rt.plan.sites)
    assert plan_fingerprint(rt.plan) == j_fingerprint(jrt.plan)


def test_frontend_outputs_match_the_reference(frontend_pair):
    (jreqs, _, _), _, _, (reqs, _, _), _, _ = frontend_pair
    n = 0
    for r, j in zip(reqs, jreqs):
        if r.status == "ok":
            np.testing.assert_allclose(r.output.numpy(),
                                       np.asarray(j.output), **TOL)
            n += 1
    assert n >= 80
