"""The twins of ``tests/test_exec_cache.py`` on the port, on the CPU: the
LRU cache and its in-flight build de-duplication (owner failure,
eviction racing a waiter), plan identity (signature vs key, the dict
behind ``site``), and the runtime's churn path: a recompile whose
signature is unchanged rebuilds nothing (revalidation), A -> B -> A
builds each signature once, an evicted signature is rebuilt, a cached
swap still deopts on a racing update, instrumented twins are distinct
entries, dispatch reads one tuple, several runtimes share one cache, the
version-keyed baseline rebuilds every cycle, and a change of the
instrumented structure swaps instead of revalidating.

"Compile" here is the engine's build of a closure (``compile_count``);
the port has no trace, so ``lower_count`` counts the same builds.  The
port's generic oracle (``run_generic``) runs the runtime's own generic
executable: it adds no cache entry and moves no serving counter, where
the reference builds a non-donating twin of it."""
import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.core import EngineConfig, ExecutableCache, \
    MorpheusRuntime, SiteSpec, SketchConfig, SpecializationPlan, Table, \
    TableSet
from repro_torch.core.execcache import batch_key


# ---------------------------------------------------------------------------
# ExecutableCache unit
# ---------------------------------------------------------------------------

def test_cache_lru_eviction_and_stats():
    c = ExecutableCache(capacity=2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1          # a is now most recent
    c.put("c", 3)                   # evicts b (LRU)
    assert c.peek("b") is None
    assert c.get("a") == 1 and c.get("c") == 3
    assert c.get("b") is None
    assert c.stats.evictions == 1
    assert c.stats.hits == 3 and c.stats.misses == 1
    assert len(c) == 2


def test_get_or_compile_deduplicates_inflight_compiles():
    """The multi-plane stampede guard: concurrent get_or_compile calls
    for one key run compile_fn exactly once — the second caller waits
    for the owner's insert instead of compiling again."""
    c = ExecutableCache(capacity=8)
    started, gate = threading.Event(), threading.Event()
    compiles = []

    def slow():
        started.set()
        assert gate.wait(timeout=10)
        compiles.append(1)
        return "exe", 1.23

    out = []
    t1 = threading.Thread(
        target=lambda: out.append(c.get_or_compile("k", slow)))
    t1.start()
    assert started.wait(timeout=10)          # owner is inside compile_fn
    t2 = threading.Thread(
        target=lambda: out.append(c.get_or_compile("k", slow)))
    t2.start()
    time.sleep(0.05)                         # t2 parks as a waiter
    gate.set()
    t1.join(10)
    t2.join(10)
    assert len(compiles) == 1
    by_aux = sorted(out, key=lambda p: p[1] is None)
    assert by_aux[0] == ("exe", 1.23)        # the owner paid (got aux)
    assert by_aux[1] == ("exe", None)        # the waiter shared it
    assert c.stats.inflight_waits == 1
    assert c.stats.inserts == 1


def test_get_or_compile_owner_failure_unwedges_waiters():
    c = ExecutableCache(capacity=8)
    started = threading.Event()

    def bad():
        started.set()
        time.sleep(0.05)
        raise RuntimeError("t2 died")

    res = {}

    def owner():
        try:
            c.get_or_compile("k", bad)
        except RuntimeError as e:
            res["owner"] = e

    t = threading.Thread(target=owner)
    t.start()
    assert started.wait(timeout=10)
    # the waiter must claim ownership after the failure and compile
    res["waiter"] = c.get_or_compile("k", lambda: ("exe", 0.5))
    t.join(10)
    assert isinstance(res["owner"], RuntimeError)
    assert res["waiter"] == ("exe", 0.5)
    assert c.get("k") == "exe"


def test_eviction_racing_inflight_waiter_recompiles():
    """Eviction racing an in-flight waiter: the owner's insert is evicted
    before the parked waiter re-checks the map; the waiter re-loops,
    claims ownership and builds again (a capacity-1 cache whose ``put``
    inserts a filler right after the owner's key)."""
    class EvictingCache(ExecutableCache):
        filler_puts = 0

        def put(self, key, exe):
            super().put(key, exe)
            if key == "k" and not self.filler_puts:
                self.filler_puts += 1
                super().put("filler", "other")   # capacity 1: evicts "k"

    c = EvictingCache(capacity=1)
    started, gate = threading.Event(), threading.Event()
    compiles = []

    def compile_fn():
        compiles.append(1)
        started.set()
        assert gate.wait(timeout=10)
        return f"exe{len(compiles)}", 0.1

    out = []
    t1 = threading.Thread(
        target=lambda: out.append(c.get_or_compile("k", compile_fn)))
    t1.start()
    assert started.wait(timeout=10)          # owner inside compile_fn
    t2 = threading.Thread(
        target=lambda: out.append(c.get_or_compile("k", compile_fn)))
    t2.start()
    deadline = time.time() + 10
    while c.stats.inflight_waits < 1 and time.time() < deadline:
        time.sleep(0.005)
    assert c.stats.inflight_waits == 1       # t2 is parked as a waiter
    gate.set()          # owner inserts; filler evicts it; waiter wakes
    t1.join(10)
    t2.join(10)
    assert len(compiles) == 2                # waiter re-owned the key
    assert sorted(p[0] for p in out) == ["exe1", "exe2"]
    assert all(p[1] == 0.1 for p in out)     # both were owners (got aux)
    assert c.peek("k") == "exe2"             # final entry is valid
    assert c.stats.evictions >= 2
    assert not c._inflight                   # no wedged ownership


# ---------------------------------------------------------------------------
# plan identity: signature vs key
# ---------------------------------------------------------------------------

def test_signature_excludes_version_key_includes_it():
    p = SpecializationPlan(version=3, sites=(), flags={"f": True})
    q = SpecializationPlan(version=9, sites=(), flags={"f": True})
    assert p.signature == q.signature
    assert p.key != q.key
    assert p.key == (3,) + p.signature


def test_site_lookup_is_dict_backed():
    sites = tuple((f"t#{i}", SiteSpec(impl="onehot")) for i in range(50))
    p = SpecializationPlan(sites=sites)
    assert p.site("t#17") is sites[17][1]
    assert p.site("missing") is None
    # survives dataclasses.replace (post_init rebuilds the map)
    r = dataclasses.replace(p, version=5)
    assert r.site("t#3") is sites[3][1]


# ---------------------------------------------------------------------------
# runtime churn path
# ---------------------------------------------------------------------------

def _user_step(params, ctx, batch):
    row = ctx.lookup("classes", batch["cls"], fields=("scale",))
    x = batch["x"] * row["scale"][:, None]
    if ctx.flag("boost", default=False):
        x = x + 1.0
    return x


def _scales(n, seed=0):
    return np.linspace(1.0, 2.0, n).astype(np.float32) + seed


def _mk_runtime(n_valid=8, instrument=False, capacity=64, cache=None,
                signature_cache=True, features=None):
    tables = TableSet([Table(
        "classes", {"scale": _scales(n_valid)}, n_valid=n_valid,
        instrument=instrument)])
    batch = {"cls": torch.arange(8, dtype=torch.int32) % min(n_valid, 8),
             "x": torch.ones((8, 4), dtype=torch.float32)}
    cfg = EngineConfig(
        sketch=SketchConfig(sample_every=2, max_hot=4, hot_coverage=0.5),
        features=dict(features or {}),
        exec_cache_capacity=capacity,
        signature_cache=signature_cache, device="cpu")
    rt = MorpheusRuntime(_user_step, tables, None, batch, cfg=cfg,
                         exec_cache=cache)
    rt._batch = batch
    return rt


def _expected(rt, batch, boost=False):
    scale = np.asarray(rt.tables["classes"].fields["scale"])
    out = batch["x"].numpy() * scale[batch["cls"].numpy()][:, None]
    return out + 1.0 if boost else out


def _close(out, want):
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6)


def test_revalidation_zero_trace_zero_compile():
    """A recompile cycle whose plan signature is unchanged builds
    nothing: same executable object, restamped plan, no deopt."""
    rt = _mk_runtime()
    try:
        rt.recompile(block=True)                 # specialized active
        assert rt.stats.swaps == 1
        eng = rt.engine
        e0, l0, c0 = rt.exec, eng.lower_count, eng.compile_count
        rt.tables.bump_version("config-push")    # pure control churn
        assert rt.tables.version != rt.plan.version
        info = rt.recompile(block=True)
        assert info["revalidated"] is True
        assert rt.stats.revalidations == 1
        assert (eng.lower_count, eng.compile_count) == (l0, c0)
        assert rt.stats.swaps == 1               # no swap either
        assert rt.exec is e0                     # same executable object
        assert rt.plan.version == rt.tables.version   # restamped
        d0 = rt.stats.deopt_steps
        out = rt.step(rt._batch)                 # guard must NOT trip
        assert rt.stats.deopt_steps == d0
        _close(out, _expected(rt, rt._batch))
    finally:
        rt.close()


def test_oscillation_a_b_a_compiles_at_most_twice():
    """A -> B -> A control oscillation: two distinct signatures, two
    builds total — the third cycle swaps to the cached A executable."""
    rt = _mk_runtime()       # no instrumented sites => twins share code
    try:
        eng = rt.engine
        base = eng.compile_count
        for i, boost in enumerate((True, False, True)):
            rt.set_feature("boost", boost)
            info = rt.recompile(block=True)
            assert info["revalidated"] is False
            out = rt.step(rt._batch)
            _close(out, _expected(rt, rt._batch, boost=boost))
            if i == 1:
                after_b = eng.compile_count
        assert eng.compile_count - base <= 2
        assert eng.compile_count == after_b      # cycle 3: zero compiles
        assert rt.stats.swaps == 3               # but it DID swap
    finally:
        rt.close()


def test_lru_eviction_recompiles_correctly():
    rt = _mk_runtime(capacity=2)
    try:
        eng = rt.engine
        for seed in (1, 2, 3):                   # distinct inline values
            rt.control_update("classes", {"scale": _scales(8, seed)})
            rt.recompile(block=True)
            _close(rt.step(rt._batch), _expected(rt, rt._batch))
        assert rt.exec_cache.stats.evictions > 0
        # back to an evicted signature: must recompile, not crash
        c0 = eng.compile_count
        rt.control_update("classes", {"scale": _scales(8, 1)})
        rt.recompile(block=True)
        assert eng.compile_count > c0
        _close(rt.step(rt._batch), _expected(rt, rt._batch))
    finally:
        rt.close()


def test_cached_executable_still_deopts_after_racing_update():
    """A swap served from the cache is still covered by the program
    guard: a control update racing in after the recompile routes traffic
    to the generic executable (which reads the LIVE tables)."""
    rt = _mk_runtime()
    try:
        rt.control_update("classes", {"scale": _scales(8, 1)})
        rt.recompile(block=True)                 # plan A (compiled)
        rt.control_update("classes", {"scale": _scales(8, 2)})
        rt.recompile(block=True)                 # plan B (compiled)
        c0 = rt.engine.compile_count
        rt.control_update("classes", {"scale": _scales(8, 1)})
        rt.recompile(block=True)                 # plan A again: cache hit
        assert rt.engine.compile_count == c0
        assert rt.stats.cache_hits > 0
        # racing update AFTER the swap — no recompile before the step
        rt.control_update("classes", {"scale": _scales(8, 7)})
        d0 = rt.stats.deopt_steps
        out = rt.step(rt._batch)
        assert rt.stats.deopt_steps == d0 + 1    # guard tripped
        _close(out, _expected(rt, rt._batch))
    finally:
        rt.close()


def test_instrumented_twins_compiled_distinct_and_concurrently():
    """With instrumented sites the specialized executable and its twin
    are distinct cache entries, built in one recompile cycle."""
    rt = _mk_runtime(n_valid=40, instrument=True)
    try:
        assert rt.engine.instrumented_sites()
        assert rt.generic_instr_exec is not rt.generic_exec
        for i in range(4):
            rt.step(rt._batch)
        c0 = rt.engine.compile_count
        rt.control_update("classes", {"scale": _scales(40, 1)})
        rt.recompile(block=True)
        assert rt.plan.label.startswith("specialized")
        assert rt.instr_exec is not rt.exec
        assert rt.engine.compile_count == c0 + 2       # both twins
        # instrumented sampling keeps working after the swap
        s0 = rt.stats.instr_steps
        for i in range(4):
            rt.step(rt._batch)
        assert rt.stats.instr_steps > s0
    finally:
        rt.close()


def test_dispatch_reads_one_consistent_tuple():
    rt = _mk_runtime()
    try:
        plan, exe, instr_exe, generic_exe = rt._active
        assert rt.plan is plan
        assert rt.exec is exe
        assert rt.instr_exec is instr_exe
        assert rt.generic_exec is generic_exe
        rt.recompile(block=True)
        assert rt.plan is rt._active[0]          # swap replaced the tuple
    finally:
        rt.close()


def test_run_generic_oracle_shares_the_cache():
    rt = _mk_runtime()
    try:
        n0 = len(rt.exec_cache)
        h0 = rt.exec_cache.stats.hits
        s0 = rt.stats.cache_hits + rt.stats.cache_misses
        out1 = rt.run_generic(rt._batch)
        out2 = rt.run_generic(rt._batch)
        # the oracle runs the generic executable the serving path holds
        assert len(rt.exec_cache) == n0
        assert rt.exec_cache.stats.hits == h0
        # oracle traffic stays OUT of the serving-cycle counters
        assert rt.stats.cache_hits + rt.stats.cache_misses == s0
        assert torch.equal(out1, out2)
        key = rt._exec_key(rt.generic_plan, rt._batch, rt._isites())
        assert rt.exec_cache.peek(key) is rt.generic_exec
        assert torch.equal(out1, rt.generic_exec(rt.params, rt.state,
                                                 rt._batch)[0])
    finally:
        rt.close()


def test_shared_cache_across_runtimes():
    """The multi-dataplane seam: two runtimes, one ExecutableCache —
    distinct namespaces keep their executables apart by default."""
    cache = ExecutableCache(capacity=32)
    rt1 = _mk_runtime(cache=cache)
    rt2 = _mk_runtime(cache=cache)
    try:
        assert rt1.exec_cache is cache and rt2.exec_cache is cache
        assert rt1._cache_ns != rt2._cache_ns
        n_generic = len(cache)                   # both generics cached
        assert n_generic >= 2
        rt1.recompile(block=True)
        rt2.recompile(block=True)
        out1, out2 = rt1.step(rt1._batch), rt2.step(rt2._batch)
        torch.testing.assert_close(out1, out2, rtol=1e-6, atol=0)
        assert len(cache) >= n_generic + 2       # one specialized each
    finally:
        rt1.close()
        rt2.close()


def test_version_keyed_baseline_recompiles_every_cycle():
    """EngineConfig(signature_cache=False) reproduces the pre-cache
    behavior: every version bump forces a full rebuild of behaviorally
    identical code."""
    rt = _mk_runtime(signature_cache=False)
    try:
        rt.recompile(block=True)
        c0 = rt.engine.compile_count
        rt.tables.bump_version("churn")
        info = rt.recompile(block=True)
        assert info["revalidated"] is False
        assert rt.engine.compile_count > c0
        assert rt.stats.revalidations == 0
    finally:
        rt.close()


def test_instr_structure_change_forces_swap_not_revalidation():
    """A control update that flips a site in or out of instrumentation
    (n_valid crossing max_inline) changes the PlaneState structure while
    leaving the plan signature unchanged — the cycle must rebuild
    against the new structure, never revalidate the old executable."""
    def rw_step(params, ctx, batch):
        row = ctx.lookup("sess", batch["cls"], fields=("val",))
        ctx.update("sess", batch["cls"],
                   {"val": row["val"] + 1.0})
        return row["val"]

    tables = TableSet([Table("sess", {"val": np.zeros(64, np.float32)},
                             n_valid=8, instrument=True)])
    batch = {"cls": torch.arange(8, dtype=torch.int32)}
    rt = MorpheusRuntime(rw_step, tables, None, batch,
                         cfg=EngineConfig(sketch=SketchConfig(
                             sample_every=2, max_hot=4), device="cpu"))
    try:
        assert rt.engine.instrumented_sites() == []     # 8 <= max_inline
        rt.recompile(block=True)
        sig0 = rt.plan.signature
        # grow past the inline threshold: the site becomes instrumented,
        # the state gains a sketch — but the plan stays the same
        rt.control_update("sess", {"val": np.zeros(64, np.float32)},
                          n_valid=40)
        assert rt.engine.instrumented_sites() == ["sess#0"]
        info = rt.recompile(block=True)
        assert rt.plan.signature == sig0                # same plan...
        assert info["revalidated"] is False             # ...new structure
        assert "sess#0" in rt.state.instr
        for i in range(4):                              # incl. sampled
            out = rt.step(batch)                        # instrumented steps
        assert torch.isfinite(out).all()
        # deopt target was refreshed for the new structure too
        rt.tables.bump_version("late-update")
        d0 = rt.stats.deopt_steps
        rt.step(batch)
        assert rt.stats.deopt_steps == d0 + 1
    finally:
        rt.close()


def test_batch_key_distinguishes_shapes_and_dtypes():
    b1 = {"x": torch.ones((8, 4))}
    b2 = {"x": torch.ones((4, 4))}
    b3 = {"x": torch.ones((8, 4), dtype=torch.bfloat16)}
    assert batch_key(b1) != batch_key(b2)
    assert batch_key(b1) != batch_key(b3)
    assert batch_key(b1) == batch_key({"x": torch.zeros((8, 4))})
