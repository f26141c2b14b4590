"""The port's serving slice against the reference at ``ServeConfig()``
widths, with the reference's weights carried across: the MoE layer (both
paths), the generic step's logits (atol=rtol=1e-4), expert ids and the
sessions table (exact); after the same traffic and a recompile, an equal
plan fingerprint and specialized output equal to generic bit for bit;
and the program guard's deopt and revalidation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JEngineConfig, \
    MorpheusRuntime as JRuntime, SketchConfig as JSketchConfig
from repro.core.passes.branch_inject import \
    moe_ffn_hotpath as j_moe_ffn_hotpath
from repro.models.config import ModelConfig as JModelConfig, \
    MoEConfig as JMoEConfig
from repro.models.moe import moe_ffn_local as j_moe_ffn_local, \
    route as j_route
from repro.serving import ServeConfig as JServeConfig, \
    build_params as j_build_params, build_tables as j_build_tables, \
    make_serve_step as j_make_serve_step, \
    make_synthetic_batch as j_make_synthetic_batch
from repro.testing.fingerprint import plan_fingerprint
from repro_torch.core import EngineConfig, MorpheusRuntime, SketchConfig
from repro_torch.core.passes.branch_inject import moe_ffn_hotpath
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.moe import moe_ffn_local, route
from repro_torch.serving import ServeConfig, build_params, build_tables, \
    make_serve_step, make_synthetic_batch, params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
FEATURES = {"vision_enabled": False, "track_sessions": True}
SKETCH = dict(sample_every=2, max_hot=32, hot_coverage=0.8)


@pytest.fixture(scope="module")
def weights():
    """The reference's params (router skewed to experts 0-2, as in the
    quickstart) and the same weights in the port, on the CPU."""
    cfg = JServeConfig()
    params = j_build_params(cfg, jax.random.PRNGKey(0))
    bias = np.zeros(cfg.n_experts, np.float32)
    bias[:3] = 6.0
    for lp in params["layers"]:
        lp["moe"]["b_router"] = jnp.asarray(bias)
    return params, params_from_numpy(jax.tree.map(np.asarray, params),
                                      "cpu")


def _batch(i, locality="high", **kw):
    b = j_make_synthetic_batch(JServeConfig(), jax.random.PRNGKey(i), 8,
                               locality, **kw)
    return {k: np.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def runtimes(weights):
    jparams, tparams = weights
    jcfg, tcfg = JServeConfig(), ServeConfig()
    jrt = JRuntime(j_make_serve_step(jcfg),
                   j_build_tables(jcfg, None, uniform_temperature=False),
                   jparams, j_make_synthetic_batch(jcfg,
                                                   jax.random.PRNGKey(0)),
                   cfg=JEngineConfig(sketch=JSketchConfig(**SKETCH),
                                     features=dict(FEATURES),
                                     moe_router_table="router"))
    trt = MorpheusRuntime(make_serve_step(tcfg),
                          build_tables(tcfg, uniform_temperature=False),
                          tparams, _batch(0),
                          cfg=EngineConfig(sketch=SketchConfig(**SKETCH),
                                           features=dict(FEATURES),
                                           moe_router_table="router",
                                           device="cpu"))
    yield jrt, trt
    jrt.close()
    trt.close()


def _x2d(seed, T=128, d=64):
    return np.random.default_rng(seed).standard_normal((T, d)).astype(
        np.float32)


def test_route_and_moe_ffn_local_match_reference(weights):
    jparams, tparams = weights
    moe = JServeConfig()
    for li in range(2):
        x = _x2d(li)
        jp, tp = jparams["layers"][li]["moe"], tparams["layers"][li]["moe"]
        _, jids, _ = j_route(jp["w_router"], jnp.asarray(x), moe.top_k,
                             jp["b_router"])
        _, tids, _ = route(tp["w_router"], torch.from_numpy(x), moe.top_k,
                           tp["b_router"])
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        jy, jm = j_moe_ffn_local(jp, jnp.asarray(x), JMoEConfig(
            num_experts=moe.n_experts, top_k=moe.top_k,
            expert_d_ff=moe.d_ff))
        ty, tm = moe_ffn_local(tp, torch.from_numpy(x), MoEConfig(
            num_experts=moe.n_experts, top_k=moe.top_k,
            expert_d_ff=moe.d_ff))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_array_equal(tm["expert_counts"].numpy(),
                                      np.asarray(jm["expert_counts"]))
        np.testing.assert_allclose(float(tm["aux_loss"]),
                                   float(jm["aux_loss"]), **TOL)


def test_moe_sort_is_stable_like_jnp_argsort():
    """MoE ordering: ``jnp.argsort`` is stable; the port sorts with
    ``stable=True`` so rows of one expert keep token order, which both
    MoE paths rely on to issue the same GEMM on the same rows."""
    ids = np.random.default_rng(0).integers(0, 4, 200).astype(np.int32)
    np.testing.assert_array_equal(
        torch.argsort(torch.from_numpy(ids), stable=True).numpy(),
        np.asarray(jnp.argsort(jnp.asarray(ids))))


@pytest.mark.parametrize("hot", [(0, 1, 2), (2, 0, 1, 5), (0, 1)],
                         ids=["all-hot", "all-hot-extra", "miss"])
def test_moe_ffn_hotpath_matches_reference(weights, hot):
    """The hot path against the reference's, and against the port's own
    generic path: bit for bit when every token routes to hot experts.
    The reference's ``ragged_dot`` is a per-expert GEMM loop here, and
    both paths issue the same GEMM on the same rows per expert, which is
    what keeps specialized output equal to generic."""
    jparams, tparams = weights
    s = JServeConfig()
    x = _x2d(7)
    jcfg = JModelConfig(d_model=s.d_model, moe=JMoEConfig(
        num_experts=s.n_experts, top_k=s.top_k, expert_d_ff=s.d_ff))
    tcfg = ModelConfig(d_model=s.d_model, moe=MoEConfig(
        num_experts=s.n_experts, top_k=s.top_k, expert_d_ff=s.d_ff))
    jp, tp = jparams["layers"][0]["moe"], tparams["layers"][0]["moe"]
    jy, jm = j_moe_ffn_hotpath(jp, jnp.asarray(x), jcfg, hot)
    ty, tm = moe_ffn_hotpath(tp, torch.from_numpy(x), tcfg, hot)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert int(tm["fastpath_hit"]) == int(jm["fastpath_hit"]) == \
        (hot != (0, 1))
    local, _ = moe_ffn_local(tp, torch.from_numpy(x), tcfg.moe)
    assert torch.equal(ty, local)


def test_generic_step_matches_reference(runtimes):
    jrt, trt = runtimes
    for i in (11, 12):
        b = _batch(i, "low")
        jout = np.asarray(jrt.run_generic(b))
        tout = trt.run_generic(b)
        assert tout.shape == jout.shape == (8, 16, 2048)
        np.testing.assert_allclose(tout.numpy(), jout, **TOL)
        np.testing.assert_array_equal(tout[:, -1].argmax(-1).numpy(),
                                      jout[:, -1].argmax(-1))


def test_same_traffic_same_plan_and_specialized_equals_generic(runtimes):
    """After the same batches, both runtimes sample the same steps,
    record the same keys (expert ids included) and plan the same
    signature; the port's specialized step, which launches ``hot_gather``
    through the dispatcher, equals its generic oracle bit for bit."""
    jrt, trt = runtimes
    for i in range(12):
        b = _batch(100 + i, slot_offset=3, hot_slots=4)
        jout = np.asarray(jrt.step(b))
        tout = trt.step(b)
        np.testing.assert_allclose(tout.numpy(), jout, **TOL)
    for f in ("count", "last_token"):
        np.testing.assert_array_equal(
            trt.state.tables["sessions"][f].numpy(),
            np.asarray(jrt.state.tables["sessions"][f]))
    jrt.recompile(block=True)
    trt.recompile(block=True)
    assert plan_fingerprint(trt.plan) == plan_fingerprint(jrt.plan)
    impls = {sid: s.impl for sid, s in trt.plan.sites}
    assert impls["vocab_embed#0"] == "hot_cache"
    assert trt.hot_experts() == jrt.hot_experts() is not None
    for i in range(4):
        b = _batch(200 + i)
        want = trt.run_generic(b)
        assert torch.equal(trt.step(b), want)
        np.testing.assert_allclose(want.numpy(),
                                   np.asarray(jrt.step(b)), **TOL)


def test_run_generic_leaves_the_live_state_untouched(runtimes):
    """"Compile": executables are closures that never write their input
    state, so the generic oracle can read the live state as it is."""
    _, trt = runtimes
    before = {f: t.clone() for f, t in
              trt.state.tables["sessions"].items()}
    guards = {n: t.clone() for n, t in trt.state.guards.items()}
    steps = trt.stats.steps
    trt.run_generic(_batch(400))
    for f, t in before.items():
        assert torch.equal(trt.state.tables["sessions"][f], t)
    for n, t in guards.items():
        assert torch.equal(trt.state.guards[n], t)
    assert trt.stats.steps == steps


def test_control_update_deopts_and_revalidation_builds_nothing(runtimes):
    _, trt = runtimes
    trt.recompile(block=True)
    b = _batch(300)
    d0 = trt.stats.deopt_steps
    trt.control_update("req_class", {"temperature": np.linspace(
        0.6, 1.4, 64).astype(np.float32)})
    out = trt.step(b)
    assert trt.stats.deopt_steps == d0 + 1
    assert torch.equal(out, trt.run_generic(b))
    trt.recompile(block=True)
    assert trt.tables.version == trt.plan.version
    n = trt.engine.compile_count
    info = trt.recompile(block=True)
    assert info["revalidated"]
    assert trt.engine.compile_count == n
    assert torch.equal(trt.step(b), trt.run_generic(b))


def test_port_build_params_and_batches_are_seeded():
    cfg = ServeConfig(n_layers=1)
    a, b = build_params(cfg, 3, "cpu"), build_params(cfg, 3, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
    assert not torch.equal(a["unembed"], build_params(cfg, 4,
                                                      "cpu")["unembed"])
    b1 = make_synthetic_batch(cfg, 5, device="cpu")
    b2 = make_synthetic_batch(cfg, 5, device="cpu")
    assert all(torch.equal(b1[k], b2[k]) for k in b1)
    assert b1["tokens"].dtype == torch.int32 and int(b1["tokens"].max()) < 32
    ops.reset_launches()
    assert ops.launches() == {}
