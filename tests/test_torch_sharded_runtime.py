"""The port's sharded serving runtime on a debug mesh of four repeated
CPU devices (``Mesh(["cpu"] * 4, ("data",))``), held against the
reference's single-device runtime in process: the twins of
``tests/test_sharded_runtime.py`` (whose subprocesses show the
reference's 4-device runtime equal to its 1-device one), of
``test_health.py::test_device_loss_shrinks_mesh_and_hands_state_over``
and of ``test_plane_state.py::test_compile_accepts_per_leaf_shardings``.

Exact where the reference is exact: sketch counts, plan fingerprints,
hot experts, pass stats, table bytes.  On the mesh the specialized step
equals the generic one bit for bit (the port's contract, stricter than
the reference's 1e-4); the mesh's logits against the reference's are
held at ``TOL`` = 1e-4 (the two frameworks' sums run in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JEngineConfig, \
    MorpheusRuntime as JRuntime, SketchConfig as JSketchConfig
from repro.core import instrument as jinstr
from repro.serving import ServeConfig as JServeConfig, \
    build_params as j_build_params, build_tables as j_build_tables, \
    make_serve_step as j_make_serve_step, \
    make_synthetic_batch as j_make_synthetic_batch
from repro.testing.fingerprint import plan_fingerprint as j_fingerprint
from repro_torch.core import EngineConfig, MorpheusRuntime, SketchConfig, \
    instrument
from repro_torch.distributed.compat import Replicated, Sharded
from repro_torch.distributed.meshctx import Mesh
from repro_torch.serving import ServeConfig, build_tables, \
    make_serve_step, params_from_numpy
from repro_torch.testing.fingerprint import plan_fingerprint

TOL = dict(rtol=1e-4, atol=1e-4)
SKETCH = dict(sample_every=2, max_hot=4, hot_coverage=0.5)
FEATURES = {"vision_enabled": False, "track_sessions": True}


def _mesh(n=4):
    return Mesh(["cpu"] * n, ("data",))


def test_sharded_record_merge_equals_reference_single_device():
    """merge(record_sharded(stream)) == the reference's record(stream),
    count for count (the count-min sketch is linear); the device merge
    equals the host merge; and with a ring large enough to keep every
    key, the heavy-hitter readout is the reference's."""
    cfg, jcfg = SketchConfig(candidates=1024), JSketchConfig(candidates=1024)
    rng = np.random.default_rng(0)
    base = np.concatenate([np.repeat(i, 40 - 4 * i) for i in range(8)])
    streams = []
    for _ in range(5):
        s = np.concatenate([base, rng.integers(100, 2000, 8)])
        rng.shuffle(s)
        streams.append(s.astype(np.int32))
    single = jinstr.init_site_state(jcfg)
    sharded = instrument.init_site_state(cfg, "cpu", 4)
    assert instrument.n_shards(sharded) == 4
    assert isinstance(sharded["cms"], Sharded)
    for keys in streams:
        single = jinstr.record(single, jnp.asarray(keys), jcfg)
        sharded = instrument.record_sharded(sharded, torch.from_numpy(keys),
                                            cfg, _mesh(), ("data",))
    merged = instrument.merge_shards(sharded)
    np.testing.assert_array_equal(merged["cms"], np.asarray(single["cms"]))
    assert int(merged["total"]) == int(single["total"])
    dev = instrument.merge_on_device(sharded, _mesh())
    np.testing.assert_array_equal(dev["cms"].numpy(), merged["cms"])
    np.testing.assert_array_equal(dev["cand"].numpy(), merged["cand"])
    assert int(dev["total"]) == int(merged["total"])
    h1, c1, t1 = jinstr.hot_keys(single, jcfg)
    h2, c2, t2 = instrument.hot_keys(merged, cfg)
    assert t1 == t2 and abs(c1 - c2) < 1e-9
    np.testing.assert_array_equal(h1, h2)


def _jbatch(i, **kw):
    b = j_make_synthetic_batch(JServeConfig(), jax.random.PRNGKey(i), 8,
                               "high", **kw)
    return {k: np.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def pair():
    """The reference's 1-device runtime and the port's 4-shard one on
    the same numpy params (router skewed to experts 0-2) and tables."""
    jcfg = JServeConfig()
    params = j_build_params(jcfg, jax.random.PRNGKey(0))
    bias = np.zeros(jcfg.n_experts, np.float32)
    bias[:3] = 6.0
    for lp in params["layers"]:
        lp["moe"]["b_router"] = jnp.asarray(bias)
    jrt = JRuntime(j_make_serve_step(jcfg), j_build_tables(jcfg, None),
                   params, j_make_synthetic_batch(jcfg,
                                                  jax.random.PRNGKey(0)),
                   cfg=JEngineConfig(sketch=JSketchConfig(**SKETCH),
                                     features=dict(FEATURES),
                                     moe_router_table="router"))
    trt = MorpheusRuntime(
        make_serve_step(ServeConfig()), build_tables(ServeConfig()),
        params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
        _jbatch(0), cfg=EngineConfig(sketch=SketchConfig(**SKETCH),
                                     features=dict(FEATURES),
                                     moe_router_table="router",
                                     device="cpu", mesh=_mesh()))
    yield jrt, trt
    jrt.close()
    trt.close()


def test_sharded_plan_identical_to_reference_single_device(pair):
    """Same traffic, same plan: the merged 4-shard sketches feed the
    pass registry exactly what the reference's one device recorded."""
    jrt, trt = pair
    for i in range(12):
        b = _jbatch(i)
        np.testing.assert_allclose(trt.step(b).numpy(),
                                   np.asarray(jrt.step(b)), **TOL)
    for st in trt.state.instr.values():
        assert instrument.n_shards(st) == 4
    jinfo = jrt.recompile(block=True)
    tinfo = trt.recompile(block=True)
    assert plan_fingerprint(trt.plan) == j_fingerprint(jrt.plan)
    assert trt.plan.version == jrt.plan.version
    assert trt.hot_experts() == jrt.hot_experts() is not None
    assert tinfo["pass_stats"] == jinfo["pass_stats"]
    for f in ("count", "last_token"):
        np.testing.assert_array_equal(
            np.asarray(trt.state.tables["sessions"][f]),
            np.asarray(jrt.state.tables["sessions"][f]))
    # on the mesh, specialized == generic bit for bit
    for i in (99, 100):
        b = _jbatch(i)
        want = trt.run_generic(b)
        out = trt.step(b)
        assert torch.equal(out, want)
        np.testing.assert_allclose(out.numpy(), np.asarray(jrt.step(b)),
                                   **TOL)


def test_serve_driver_sharded():
    """``run_serve`` on a 4-entry mesh: per-shard sketches, two
    recompiles, the specialized plan served."""
    from repro_torch.launch.serve import run_serve
    stats, rt = run_serve(steps=24, recompile_every=12, quiet=True,
                          mesh=_mesh(), device="cpu")
    try:
        assert stats["n_devices"] == 4
        assert rt.stats.recompiles == 2
        assert rt.stats.instr_steps > 0
        for sid, st in rt.state.instr.items():
            assert instrument.n_shards(st) == 4, (sid, st["cms"].shape)
        assert rt.hot_experts() is not None
    finally:
        rt.close()


def test_control_update_on_mesh_deopts_then_respecializes():
    from repro_torch.launch.serve import run_serve
    from repro_torch.serving import make_synthetic_batch
    stats, rt = run_serve(steps=12, recompile_every=6, quiet=True,
                          mesh=_mesh(), device="cpu")
    try:
        rt.control_update("req_class",
                          {"temperature": np.full(4, 2.0, np.float32)})
        assert rt.tables.version != rt.plan.version
        rt.step(make_synthetic_batch(ServeConfig(), 5, 8, device="cpu"))
        assert rt.stats.deopt_steps >= 1
        rt.recompile(block=True)
        assert rt.plan.version == rt.tables.version
        t = rt.state.tables["req_class"]["temperature"]
        assert isinstance(t, Replicated)
        for copy in t.copies.values():         # every distinct device
            assert float(copy[0]) == 2.0
    finally:
        rt.close()


def test_device_loss_shrinks_mesh_and_hands_state_over():
    """On a mesh the fault path pulls live state to the host byte for
    byte, drops the mesh, rotates the cache namespace and swaps in a
    single-device generic executable; the shrunk plane continues
    exactly where a single-device twin stands."""
    from test_torch_health import _batch, _mk, _warm
    from repro_torch.distributed.fault import FailureInjector, \
        SimulatedDeviceLoss
    rt, twin = _mk(mesh=_mesh()), _mk()
    try:
        _warm(rt)
        _warm(twin)
        assert rt.mesh is not None
        np.testing.assert_array_equal(
            np.asarray(rt.state.tables["sess"]["count"]),
            twin.state.tables["sess"]["count"].numpy())
        ns_before = rt._cache_ns
        inj = FailureInjector()
        rt.set_fault_injector(inj)
        inj.arm_next(SimulatedDeviceLoss("lost device 1"))
        b = _batch(80)
        with pytest.raises(SimulatedDeviceLoss):
            rt.step(b)
        assert rt.degraded and rt.mesh is None
        assert rt._cache_ns != ns_before
        assert torch.equal(rt.step(b), twin.step(b))
        assert torch.equal(rt.state.tables["sess"]["count"],
                           twin.state.tables["sess"]["count"])
        res = rt.recompile(block=True)
        assert res.get("recovered") is True and not rt.degraded
        b2 = _batch(81)
        assert torch.equal(rt.step(b2), twin.step(b2))
    finally:
        rt.close()
        twin.close()


def test_compile_accepts_per_leaf_shardings():
    """The mesh engine's default placement, per leaf: tables and guards
    replicated, sketches split on ``"data"``, the batch on its leading
    dim; the executable built for it returns a PlaneState so placed."""
    from test_torch_health import _batch, _mk
    rt = _mk(mesh=_mesh())
    try:
        eng = rt.engine
        state = eng.init_state()
        batch = rt.place_batch(_batch(3))
        (p_sh, s_sh, b_sh), (o_sh, so_sh) = eng.default_shardings(state,
                                                                  batch)
        assert p_sh == () and o_sh is None and so_sh is s_sh
        assert all(v == () for t in s_sh.tables.values()
                   for v in t.values())
        assert all(v == (("data",),) for st in s_sh.instr.values()
                   for v in st.values())
        assert b_sh == {"cls": (("data",),), "x": (("data",),),
                        "slot": (("data",),)}
        exe, _ = eng.compile(eng.generic_plan(instrumented=True), state)
        out, st = exe(rt.params, state, batch)
        assert np.isfinite(out.numpy()).all() and out.shape == (16, 4)
        assert all(isinstance(v, Replicated) for t in st.tables.values()
                   for v in t.values())
        assert all(isinstance(v, Sharded) and len(v.shards) == 4
                   for s in st.instr.values() for v in s.values())
        assert all(isinstance(g, Replicated) for g in st.guards.values())
        assert int(np.asarray(st.guards["sess"])[0]) == 1
        assert eng.default_shardings(state, batch)[0] is not None
    finally:
        rt.close()
