"""The port's fused K-step windows and batch placement on the CPU: the
twins of ``tests/test_dispatch_fastpath.py``'s fused and placement cases
(a window equals K single steps bit for bit, RW table writes included;
K in the cache key; an ambiguous pre-stacked input rejected; K=1
degrading to ``step``; a mid-window update queued and the next window
deopting in FIFO order; the fused generic deopt target built ahead;
the seqlock: an update queued behind a single step drains at its
commit, the executable runs outside the runtime lock, and every writer
(a control update, a recompile's swap) bumps the generation;
zero transfers for a placed batch; one locked stats call per window;
window-granular sampling; one publish per instrumented window), a
stress run of windows against control churn, and parity with the
reference on the same numpy inputs for ``stack_batches``,
``_induced_window_avals`` and the ``RuntimeStats`` histograms.

The three seqlock twins also run on the card (their ``[cuda]`` case,
marked ``cuda``), where the executable's launches are still in flight
while the runtime lock is free.  ``test_writer_quiesces_and_bumps_generation``
is twinned by ``test_writer_clears_the_fused_memo_and_refuses_a_stale_claim``.
The reference is imported inside the parity tests alone, so the card's
run of this file needs no JAX."""
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import BATCH_SHAPE_SITE, EngineConfig, \
    MorpheusRuntime, PlaneSampling, RuntimeStats, SketchConfig, SiteSpec, \
    SpecializationPlan, Table, TableSet, stack_batches
from repro_torch.core import runtime as runtime_mod
from repro_torch.core.execcache import batch_key

N_VALID = 48
DEVICES = ["cpu", pytest.param("cuda", marks=[
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA card")])]


def _user_step(params, ctx, batch):
    row = ctx.lookup("classes", batch["cls"], fields=("scale",))
    x = batch["x"] * row["scale"][:, None]
    old = ctx.lookup("sess", batch["slot"], fields=("count",))
    ctx.update("sess", batch["slot"], {"count": old["count"] + 1})
    return x


def _tables(seed=0):
    return TableSet([
        Table("classes",
              {"scale": np.linspace(1.0, 2.0, N_VALID).astype(np.float32)
               + seed},
              n_valid=N_VALID, instrument=True),
        Table("sess", {"count": np.zeros(16, np.int32)}, n_valid=16,
              mutability="rw"),
    ])


def _batch(i=0):
    rng = np.random.default_rng(i)
    cls = np.arange(16) % N_VALID
    cls[:12] = np.arange(12) % 3          # skewed hot classes {0,1,2}
    return {"cls": cls.astype(np.int32),
            "x": rng.standard_normal((16, 4)).astype(np.float32),
            "slot": rng.integers(0, 16, 16).astype(np.int32)}


def _mk(seed=0, sample_every=2, device="cpu", **kw):
    cfg = EngineConfig(sketch=SketchConfig(sample_every=sample_every,
                                           max_hot=4, hot_coverage=0.5),
                       device=device, **kw)
    return MorpheusRuntime(_user_step, _tables(seed), None, _batch(),
                           cfg=cfg)


def _join_warms(rt):
    # the first window of each (structure, K) builds the fused generic
    # deopt target in the background: join it so counts are exact
    for t in rt._warm_threads:
        t.join(timeout=60)
        assert not t.is_alive()


# ---------------------------------------------------------------------------
# fused multi-step execution
# ---------------------------------------------------------------------------

def test_step_many_byte_identical_to_single_steps():
    """One fused K-step window == K single steps, bit for bit: outputs
    AND the threaded state (the RW table's writes), for the generic and
    the specialized plan."""
    rt1, rt2 = _mk(), _mk()
    try:
        batches = [_batch(i) for i in range(8)]
        singles = [rt1.step(b) for b in batches]
        fused = rt2.step_many(batches)
        assert fused.shape[0] == 8
        for i in range(8):
            assert torch.equal(singles[i], fused[i])
        assert torch.equal(rt1.state.tables["sess"]["count"],
                           rt2.state.tables["sess"]["count"])
        rt1.recompile(block=True)
        rt2.recompile(block=True)
        assert rt2.plan.sites, "the recompile specialized nothing"
        batches = [_batch(100 + i) for i in range(4)]
        singles = [rt1.step(b) for b in batches]
        d0 = rt2.stats.deopt_steps
        fused = rt2.step_many(batches)
        assert rt2.stats.deopt_steps == d0          # ran specialized
        for i in range(4):
            assert torch.equal(singles[i], fused[i])
        assert torch.equal(rt1.state.tables["sess"]["count"],
                           rt2.state.tables["sess"]["count"])
    finally:
        rt1.close()
        rt2.close()


def test_step_many_cached_with_k_in_the_key():
    """Fused executables live in the ExecutableCache with K in the key:
    the second window of the same K builds nothing, a different K builds
    its own executable, and K never aliases the single-step entry."""
    rt = _mk()
    try:
        rt.sampler.pin(1)                 # every window instruments
        batches = [_batch(i) for i in range(4)]
        rt.step_many(batches)
        _join_warms(rt)
        c0 = rt.engine.compile_count
        rt.step_many([_batch(10 + i) for i in range(4)])
        assert rt.engine.compile_count == c0          # K=4 cached
        rt.step_many([_batch(20 + i) for i in range(2)])
        _join_warms(rt)
        # K=2 is a new executable (+ its background generic build)
        assert rt.engine.compile_count == c0 + 2
        twin = rt._instr_twin(rt.plan, rt._active_isites)
        k4 = rt._exec_key(twin, rt.place_batch(batches, fused=True),
                          rt._active_isites, fuse=4)
        k1 = rt._exec_key(twin, rt.place_batch(batches[0]),
                          rt._active_isites)
        assert k4 != k1 and k4[-1] == ("fuse", 4)
        assert rt.exec_cache.peek(k4) is not None
    finally:
        rt.close()


def test_step_many_rejects_ambiguous_prestacked_input():
    """A plain per-step batch is shape-indistinguishable from a stacked
    window: without an explicit k the call fails loudly instead of
    stepping over the batch dimension."""
    rt = _mk()
    try:
        with pytest.raises(TypeError):
            rt.step_many(_batch())                   # no k: ambiguous
        with pytest.raises(ValueError):
            rt.step_many([_batch(0), _batch(1)], k=3)   # k mismatch
        with pytest.raises(ValueError):
            rt.step_many(stack_batches([_batch(i) for i in range(4)]),
                         k=8)                        # wrong leading axis
        assert rt.stats.steps == 0
    finally:
        rt.close()


def test_step_many_k1_degrades_to_single_step():
    rt, ref = _mk(), _mk()
    try:
        out = rt.step_many([_batch(3)])
        assert out.shape[0] == 1
        assert torch.equal(out[0], ref.step(_batch(3)))
        # the example structure at K=1 took step(): nothing fused
        assert not rt._fused_shapes and rt.stats.steps == 1
    finally:
        rt.close()
        ref.close()


# ---------------------------------------------------------------------------
# §4.4 semantics at window granularity
# ---------------------------------------------------------------------------

def test_midwindow_update_queues_then_next_window_deopts_in_order():
    """A control_update landing mid-window does NOT block: it queues,
    drains (FIFO) at the window's commit, and the *next* window runs
    generic through the program guard, equal to the same schedule under
    K=1 stepping."""
    rt, ref = _mk(), _mk()
    try:
        w0 = [_batch(i) for i in range(4)]
        w1 = [_batch(10 + i) for i in range(4)]
        rt.step_many(w0)
        rt.recompile(block=True)
        for b in w0:
            ref.step(b)
        ref.recompile(block=True)

        started, release = threading.Event(), threading.Event()
        real = rt._fused_exec

        def gated(*a, **kw):
            exe, mkey = real(*a, **kw)

            def wrapper(params, state, batch):
                started.set()
                assert release.wait(timeout=30)
                return exe(params, state, batch)
            return wrapper, mkey

        rt._fused_exec = gated
        out = {}
        th = threading.Thread(
            target=lambda: out.update(w=rt.step_many(w1)))
        th.start()
        assert started.wait(timeout=30)
        sA = np.full(N_VALID, 5.0, np.float32)
        sB = np.full(N_VALID, 7.0, np.float32)
        rt.control_update("classes", {"scale": sA})   # queued: in flight
        rt.control_update("classes", {"scale": sB})   # queued behind A
        assert len(rt._queued) == 2                   # did not block
        v_before = rt.tables.version
        release.set()
        th.join(timeout=60)
        assert not th.is_alive()
        rt._fused_exec = real

        # the drain applied both updates, in order: B is live
        assert rt.tables.version > v_before
        assert torch.equal(rt.state.tables["classes"]["scale"],
                           torch.from_numpy(sB))
        # the window itself ran pre-update code
        for b, o in zip(w1, out["w"]):
            assert torch.equal(ref.step(b), o)
        # the NEXT window deopts (program guard) and serves B's contents
        ref.control_update("classes", {"scale": sA})
        ref.control_update("classes", {"scale": sB})
        w2 = [_batch(20 + i) for i in range(4)]
        d0 = rt.stats.deopt_steps
        fused = rt.step_many(w2)
        assert rt.stats.deopt_steps == d0 + 4
        for b, o in zip(w2, fused):
            assert torch.equal(ref.step(b), o)
    finally:
        rt.close()
        ref.close()


def test_fused_generic_deopt_target_is_precompiled():
    """The fused generic deopt target is built in the background when a
    window structure is first seen, so a guard-tripped window builds
    nothing inline."""
    rt = _mk()
    try:
        w = [_batch(i) for i in range(4)]
        rt.step_many(w)
        _join_warms(rt)
        c0 = rt.engine.compile_count
        rt.control_update("classes",
                          {"scale": np.full(N_VALID, 2.5, np.float32)})
        d0 = rt.stats.deopt_steps
        rt.step_many(w)                          # guard trips
        assert rt.stats.deopt_steps == d0 + 4
        assert rt.engine.compile_count == c0     # no inline build
    finally:
        rt.close()


@pytest.mark.parametrize("device", DEVICES)
def test_update_queued_during_single_step_drains_at_commit(device):
    """The same queue/drain protocol covers plain step(): the control
    plane never blocks behind an in-flight executable."""
    rt = _mk(device=device)
    try:
        rt.step(_batch())
        started, release = threading.Event(), threading.Event()
        spec = rt._active

        def gated(params, state, batch):
            started.set()
            assert release.wait(timeout=30)
            return spec[1](params, state, batch)

        with rt._cond:
            rt._active = (spec[0], gated, gated, gated)
        th = threading.Thread(target=lambda: rt.step(_batch(1)))
        th.start()
        assert started.wait(timeout=30)
        rt.control_update("classes",
                          {"scale": np.full(N_VALID, 9.0, np.float32)})
        assert rt._queued                               # non-blocking
        release.set()
        th.join(timeout=60)
        assert not th.is_alive()
        assert not rt._queued                           # drained
        assert float(rt.state.tables["classes"]["scale"][0]) == 9.0
        with rt._cond:
            rt._active = spec
    finally:
        rt.close()


# ---------------------------------------------------------------------------
# the seqlock protocol
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", DEVICES)
def test_executable_runs_outside_the_runtime_lock(device):
    """During execution the runtime lock is FREE, and the step slot is
    claimed.  On the card this holds while the step's launches are
    still in flight (a spin kernel is queued ahead of them)."""
    rt = _mk(device=device)
    try:
        rt.step(_batch())
        seen = {}
        spec = rt._active

        def probe(params, state, batch):
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda._sleep(200_000_000)     # ~0.1 s of device time
            out = spec[1](params, state, batch)
            if device == "cuda":
                seen["in_flight"] = not torch.cuda.current_stream().query()
            seen["locked"] = rt._lock.locked()
            seen["stepping"] = rt._stepping
            return out

        with rt._cond:
            rt._active = (spec[0], probe, probe, probe)
        rt.step(_batch(1))
        with rt._cond:
            rt._active = spec
        assert seen.pop("in_flight", True) is True
        assert seen == {"locked": False, "stepping": True}
    finally:
        rt.close()


@pytest.mark.parametrize("device", DEVICES)
def test_writer_clears_the_fused_memo_and_refuses_a_stale_claim(device):
    """Every committed writer (a control update, a recompile's swap)
    empties the fused memo before it bumps the generation, and a claim
    prepared against an older generation is refused (the caller
    re-prepares)."""
    rt = _mk(device=device)
    try:
        rt.step_many([_batch(i) for i in range(2)])
        assert rt._fused_memo
        g0 = rt._gen
        rt.control_update("classes",
                          {"scale": np.full(N_VALID, 3.0, np.float32)})
        assert rt._gen > g0 and not rt._fused_memo
        g1 = rt._gen
        rt.step_many([_batch(i) for i in range(2)])
        assert rt._fused_memo
        rt.recompile(block=True)                 # the swap is a writer too
        assert rt._gen > g1 and not rt._fused_memo
        assert rt._begin_step(expect_gen=g0) is None
        claim = rt._begin_step(expect_gen=rt._gen)
        assert claim is not None
        rt._abort_step()
        out = rt.step(_batch(2))
        assert out.device.type == device
        assert float(rt.state.tables["classes"]["scale"][0]) == 3.0
    finally:
        rt.close()


def test_concurrent_windows_and_control_churn_stay_consistent():
    """Windows on two threads race control updates and blocking
    recompiles: every window commits, nothing deadlocks, no queued
    update is stranded, and the last update is live."""
    rt = _mk()
    errors = []
    n = 12
    old = sys.getswitchinterval()

    def stepper(seed):
        try:
            for i in range(n):
                rt.step_many([_batch(seed + i), _batch(seed + i + 1)])
        except Exception as e:                      # pragma: no cover
            errors.append(e)

    def churner():
        try:
            for i in range(6):
                rt.control_update(
                    "classes",
                    {"scale": np.full(N_VALID, float(i), np.float32)})
                rt.recompile(block=True)
        except Exception as e:                      # pragma: no cover
            errors.append(e)

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=stepper, args=(s,))
                   for s in (0, 100)]
        threads.append(threading.Thread(target=churner))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "deadlocked"
        assert not errors, errors
        assert rt.stats.steps == 2 * n * 2
        assert not rt._queued
        assert float(rt.state.tables["classes"]["scale"][0]) == 5.0
    finally:
        sys.setswitchinterval(old)
        rt.close()


# ---------------------------------------------------------------------------
# batch placement
# ---------------------------------------------------------------------------

def test_second_step_on_placed_batch_performs_zero_transfers():
    """A placed batch passes through: stepping the same batch object
    twice places it once, and a placed window is placed once too (one
    placement per batch, not per field)."""
    rt = _mk()
    calls = []
    real = runtime_mod._device_put
    try:
        runtime_mod._device_put = \
            lambda *a, **kw: (calls.append(1), real(*a, **kw))[1]
        placed = rt.place_batch(_batch())            # numpy: placed
        assert len(calls) == 1
        rt.step(placed)
        rt.step(placed)
        assert len(calls) == 1                       # zero transfers
        assert rt.place_batch(placed) is placed      # prefetch no-op
        assert rt.stats.batch_transfers == 1
        w = rt.place_batch([_batch(i) for i in range(4)], fused=True)
        assert len(calls) == 2 and rt.stats.batch_transfers == 2
        assert w["x"].shape == (4, 16, 4)
        rt.step_many(w, k=4)
        rt.step_many(w, k=4)
        assert len(calls) == 2
        # a window of host batches is placed once, not once per field
        rt.step_many([_batch(9), _batch(10)])
        assert len(calls) == 3 and rt.stats.batch_transfers == 3
    finally:
        runtime_mod._device_put = real
        rt.close()


# ---------------------------------------------------------------------------
# coalesced stats + window-granular sampling cadence
# ---------------------------------------------------------------------------

def test_steady_step_makes_one_locked_stats_call():
    rt = _mk()
    try:
        b = rt.place_batch(_batch())
        rt.step(b)
        lc0, s0 = rt.stats.locked_calls, rt.stats.steps
        for _ in range(6):
            rt.step(b)
        assert rt.stats.locked_calls - lc0 <= rt.stats.steps - s0
        rt.sampler.pin(1)                            # every window samples
        w = rt.place_batch([_batch(i) for i in range(4)], fused=True)
        rt.step_many(w, k=4)                         # build path (twin)
        lc0 = rt.stats.locked_calls
        for _ in range(3):
            rt.step_many(w, k=4)
        assert rt.stats.locked_calls - lc0 == 3      # one per WINDOW
    finally:
        rt.close()


def test_sampling_learns_window_granular_cadence():
    sampler = PlaneSampling(SketchConfig(sample_every=8))
    sampler.pin(4)
    # one sampled window per sample_every WINDOWS, for any K: a sampled
    # window instruments all K steps, which keeps the per-step duty
    # cycle (K / (4*K) = 1/4)
    for k in (2, 4, 32):
        assert sampler.window_every(k) == 4
    hits = [sampler.should_sample_window(w, 8) for w in range(1, 9)]
    assert hits == [False, False, False, True] * 2
    duty = sum(8 for w in range(1, 33)
               if sampler.should_sample_window(w, 8)) / (32 * 8)
    assert duty == 1.0 / 4
    sampler.disarm_after = 1
    sampler.armed = False
    assert not sampler.should_sample_window(4, 4)


def test_fused_window_instruments_and_publishes_once():
    """A sampled fused window records all K steps' traffic into the
    sketches and publishes the back buffer once per window."""
    rt = _mk(sample_every=2)
    try:
        rt.sampler.pin(1)                            # sample every window
        seq0 = rt._backbuf.seq
        i0 = rt.stats.instr_steps
        rt.step_many([_batch(i) for i in range(4)])  # window 1: sampled
        assert rt.stats.instr_steps == i0 + 4
        assert rt._backbuf.seq == seq0 + 1           # ONE publish
        snap = rt._host_instr_snapshot()
        # the sketch saw all four steps' 16 keys
        assert int(snap["classes#0"]["total"]) == 4 * 16
    finally:
        rt.close()


# ---------------------------------------------------------------------------
# parity with the reference on the same numpy inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
def test_stack_batches_matches_reference(k):
    from repro.core import stack_batches as j_stack_batches
    batches = [_batch(i) for i in range(k)]
    ours = stack_batches(batches)
    theirs = j_stack_batches(batches)
    assert sorted(ours) == sorted(theirs)
    for f, v in ours.items():
        ref = np.asarray(theirs[f])
        assert v.shape == ref.shape and v.dtype == ref.dtype
        np.testing.assert_array_equal(v, ref)
    # device tensors stack on their device
    placed = stack_batches([{f: torch.from_numpy(v) for f, v in b.items()}
                            for b in batches])
    for f, v in placed.items():
        assert isinstance(v, torch.Tensor)
        np.testing.assert_array_equal(v.numpy(), ours[f])


@pytest.mark.parametrize("buckets,k", [((2, 8), 3), ((4,), 1),
                                       ((1, 16), 4)])
def test_induced_window_shapes_match_reference(buckets, k):
    import jax
    from repro.core import stack_batches as j_stack_batches
    from repro.core.passes.batch_shape import BATCH_SHAPE_SITE as J_SITE
    from repro.core.runtime import _induced_window_avals as j_induced
    from repro.core.specialize import SiteSpec as JSiteSpec, \
        SpecializationPlan as JPlan
    spec = dict(impl="batch_shape", hot_keys=buckets,
                const_fields=(("window_k", k),))
    plan = SpecializationPlan(sites=((BATCH_SHAPE_SITE, SiteSpec(**spec)),))
    jplan = JPlan(sites=((J_SITE, JSiteSpec(**spec)),))
    window = {f: torch.from_numpy(v) for f, v in
              stack_batches([_batch(i) for i in range(2)]).items()}
    tmpl = runtime_mod._template(window)
    jwindow = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
        j_stack_batches([_batch(i) for i in range(2)]))
    ours = runtime_mod._induced_window_avals(plan, [((None, 2), tmpl)])
    theirs = j_induced(jplan, [((None, 2), jwindow)])
    assert [kk for (_, kk), _ in ours] == [kk for (_, kk), _ in theirs]
    for ((bkey, _), t), (_, ja) in zip(ours, theirs):
        assert {f: tuple(v.shape) for f, v in t.items()} == \
            {f: tuple(v.shape) for f, v in ja.items()}
        assert all(v.device.type == "meta" for v in t.values())
        assert bkey == batch_key(t)
    # a plan without a batch shape induces nothing
    assert runtime_mod._induced_window_avals(SpecializationPlan(),
                                             [((None, 2), tmpl)]) == []


def test_runtime_stats_histograms_match_reference():
    from repro.core import RuntimeStats as JRuntimeStats
    rng = np.random.default_rng(4)
    series = [{"request_total_s": rng.lognormal(-5, 1, 50).tolist(),
               "request_queue_wait_s": rng.exponential(1e-3, 30).tolist()}
              for _ in range(3)]
    ours, theirs = RuntimeStats(), JRuntimeStats()
    for s in series:
        ours.observe_many(s, requests_completed=50, slo_met=40)
        theirs.observe_many(s, requests_completed=50, slo_met=40)
    ours.observe("step_s", 0.02, steps=1)
    theirs.observe("step_s", 0.02, steps=1)
    for name in ("request_total_s", "request_queue_wait_s", "step_s"):
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert ours.quantile(name, q) == theirs.quantile(name, q)
    a, b = ours.snapshot(), theirs.snapshot()
    assert a["hists"] == b["hists"]
    for key in ("requests_completed", "slo_met", "steps", "locked_calls"):
        assert a[key] == b[key]
    assert ours.hist("step_s").summary() == theirs.hist("step_s").summary()
    ours.reset_hist("step_s")
    assert np.isnan(ours.quantile("step_s", 0.5))
    assert ours.hist("step_s") is None
