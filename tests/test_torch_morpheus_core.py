"""The twins of ``tests/test_morpheus_core.py`` on the port, on the CPU:
the sketch (heavy hitters and estimates, each equal to the reference's
on the same numpy keys), the passes' unit proposals, and the serving runtime end to end (analysis,
specialization preserving semantics, the empty adapter bank eliminated,
guard elision, the program guard's deopt and recovery, the dead-code
flag shrinking the program, the RW site guard).

The dead-code twin counts the torch calls one run of each executable
makes, where the reference counts jaxpr equations.  Already twinned
elsewhere: the sketch hash and ``record`` bit for bit
(``test_torch_core.py``); the cadence that backs off on a stable hot
set (``test_adaptive_controller_backs_off``), held on the sampler the
runtime uses by
``test_torch_controller.py::test_sampling_backs_off_then_disarms_and_rearms``
(the reference's ``AdaptiveController`` has no caller, so the port has
none).  ``test_sketch_merge``'s merge is held on the mesh, where the
reference merges sketches across the shards, by
``test_torch_sharded_runtime.py::test_sharded_record_merge_equals_reference_single_device``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.core import SketchConfig as JSketchConfig
from repro.core import instrument as JI
from repro.core.passes import dstruct as JD
from repro.core.tables import Table as JTable
from repro_torch.core import EngineConfig, MorpheusRuntime, SketchConfig, \
    Table
from repro_torch.core import instrument
from repro_torch.core.passes.const_prop import constant_fields, \
    propose_const_row
from repro_torch.core.passes.dstruct import lookup_cost, propose_dstruct
from repro_torch.core.passes.table_jit import propose_eliminate, \
    propose_inline
from repro_torch.serving import ServeConfig, build_params, build_tables, \
    make_serve_step, make_synthetic_batch

SK = SketchConfig(sample_every=2, max_hot=4, hot_coverage=0.5)
JSK = JSketchConfig(sample_every=2, max_hot=4, hot_coverage=0.5)


def _host(state):
    return {k: v.numpy() for k, v in state.items()}


# ---------------------------------------------------------------------------
# instrumentation
# ---------------------------------------------------------------------------

def test_sketch_heavy_hitters():
    state = instrument.init_site_state(SK, "cpu")
    jstate = JI.init_site_state(JSK)
    rng = np.random.default_rng(0)
    # 90% of lookups hit keys {3, 7}; the rest are uniform over 1000
    for _ in range(20):
        hot = rng.choice([3, 7], size=180)
        cold = rng.integers(0, 1000, size=20)
        keys = np.concatenate([hot, cold]).astype(np.int32)
        state = instrument.record(state, torch.from_numpy(keys), SK)
        jstate = JI.record(jstate, jnp.asarray(keys), JSK)
    hot, cov, total = instrument.hot_keys(_host(state), SK)
    assert total == 4000
    assert set(hot[:2].tolist()) == {3, 7}
    assert cov > 0.8
    jhot, jcov, jtotal = JI.hot_keys(jstate, JSK)
    np.testing.assert_array_equal(hot, jhot)
    assert (cov, total) == (jcov, jtotal)


def test_sketch_estimate_overcounts_only():
    keys = np.repeat(np.arange(50), 10).astype(np.int32)
    state = instrument.record(instrument.init_site_state(SK, "cpu"),
                              torch.from_numpy(keys), SK)
    est = instrument.estimate(state, torch.arange(50)).numpy()
    assert (est >= 10).all()          # count-min never undercounts
    jstate = JI.record(JI.init_site_state(JSK), jnp.asarray(keys), JSK)
    np.testing.assert_array_equal(
        est, np.asarray(JI.estimate(jstate, jnp.arange(50))))


# ---------------------------------------------------------------------------
# passes (unit)
# ---------------------------------------------------------------------------

def _fields(cap, const):
    rng = np.random.default_rng(1)
    vals = (np.ones((cap, 8), np.float32) if const
            else rng.standard_normal((cap, 8)).astype(np.float32))
    return {"v": vals, "f": np.zeros(cap, np.int32)}


def _table(n_valid, cap=32, const=False, cls=Table):
    return cls("t", _fields(cap, const), n_valid=n_valid,
               default={"v": 0.0})


def test_pass_eliminate_empty():
    assert propose_eliminate(_table(0)).impl == "eliminated"
    assert propose_eliminate(_table(3)) is None


def test_pass_inline_small_ro():
    t = _table(4)
    spec = propose_inline(t, "ro")
    assert spec.impl == "inline_const"
    assert propose_inline(t, "rw") is None
    assert propose_inline(_table(30), "ro") is None   # too big


def test_pass_const_prop():
    t = _table(8, const=True)
    assert set(constant_fields(t)) == {"v", "f"}
    assert propose_const_row(t, "ro").impl == "const_row"
    assert propose_const_row(_table(8), "ro") is None


def test_dstruct_cost_model_prefers_onehot_small():
    small, big = _table(8), _table(32, cap=4096)
    big.fields["v"] = np.zeros((4096, 8), np.float32)
    big.n_valid = 4096
    assert lookup_cost(small, "onehot", 1024) < lookup_cost(
        small, "gather", 1024)
    spec = propose_dstruct(big, "ro")
    # large tables may keep the gather
    assert spec is None or spec.impl == "onehot"
    # the cost model is the reference planner's, value for value
    jsmall, jbig = _table(8, cls=JTable), _table(32, cap=4096, cls=JTable)
    jbig.fields["v"] = np.zeros((4096, 8), np.float32)
    jbig.n_valid = 4096
    for t, jt in ((small, jsmall), (big, jbig)):
        for impl in ("onehot", "gather"):
            assert lookup_cost(t, impl, 1024) == \
                JD.lookup_cost(jt, impl, 1024)


# ---------------------------------------------------------------------------
# end-to-end runtime
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runtime():
    cfg = ServeConfig()
    ecfg = EngineConfig(sketch=SK,
                        features={"vision_enabled": False,
                                  "track_sessions": True},
                        moe_router_table="router", device="cpu")
    rt = MorpheusRuntime(make_serve_step(cfg), build_tables(cfg),
                         build_params(cfg, 0, "cpu"),
                         make_synthetic_batch(cfg, 0, device="cpu"),
                         cfg=ecfg)
    rt._serve_cfg = cfg
    yield rt
    rt.close()


def _batch(cfg, seed):
    return make_synthetic_batch(cfg, seed, device="cpu")


def test_analysis_classifies_tables(runtime):
    assert runtime.analysis["mutability"]["sessions"] == "rw"
    assert runtime.analysis["mutability"]["req_class"] == "ro"
    assert runtime.analysis["n_sites"] >= 5


def test_specialization_preserves_semantics(runtime):
    cfg = runtime._serve_cfg
    for i in range(6):
        runtime.step(_batch(cfg, i))
    runtime.recompile(block=True)
    assert runtime.plan.label.startswith("specialized")
    batch = _batch(cfg, 77)
    out_s = runtime.step(batch)
    out_g = runtime.run_generic(batch)
    torch.testing.assert_close(out_s, out_g, rtol=1e-5, atol=1e-5)


def test_empty_adapter_table_eliminated(runtime):
    impls = dict((sid.split("#")[0], s.impl) for sid, s in
                 runtime.plan.sites)
    assert impls.get("adapters") == "eliminated"


def test_guard_elision_ro_sites(runtime):
    for sid, s in runtime.plan.sites:
        if not sid.startswith("sessions"):
            assert not s.guarded, f"RO site {sid} should elide its guard"


def test_program_guard_deopt_and_recovery(runtime):
    cfg = runtime._serve_cfg
    batch = _batch(cfg, 5)
    runtime.recompile(block=True)
    d0 = runtime.stats.deopt_steps
    runtime.control_update(
        "req_class",
        {"temperature": np.full(cfg.n_classes, 2.0, np.float32)})
    out = runtime.step(batch)          # program guard must route generic
    assert runtime.stats.deopt_steps == d0 + 1
    # new temperature must be live immediately (generic path reads tables)
    runtime.recompile(block=True)
    out2 = runtime.step(batch)
    torch.testing.assert_close(out, out2, rtol=1e-5, atol=1e-5)


class _CountCalls(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_dead_code_flag_shrinks_program(runtime):
    cfg = runtime._serve_cfg
    eng = runtime.engine
    plan_off, _, _ = eng.build_plan({})
    plan_on = dataclasses.replace(
        plan_off, flags={**plan_off.flags, "vision_enabled": True})
    batch = _batch(cfg, 0)
    counts = []
    for plan in (plan_off, plan_on):
        exe, _ = eng.compile(plan, runtime.state)
        with _CountCalls() as mode:
            exe(runtime.params, runtime.state, batch)
        counts.append(mode.n)
    assert counts[0] < counts[1]


def test_rw_update_invalidates_site_guard(runtime):
    cfg = runtime._serve_cfg
    batch = _batch(cfg, 0)
    runtime.state = runtime.state.replace(
        guards=runtime.engine.init_guards())
    assert int(runtime.state.guards["sessions"][0]) == 0
    runtime.step(batch)                # step writes sessions
    assert int(runtime.state.guards["sessions"][0]) == 1
