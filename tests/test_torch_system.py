"""The twins of ``tests/test_system.py`` on the port, on the CPU: the
paper's headline claims at miniature scale.

  1. dynamic specialization beats the generic data plane under skewed
     traffic (Fig 5);
  2. specialization NEVER changes semantics (guards + exact fast paths);
  3. control-plane updates deopt immediately (program-level guard) and
     recompilation re-converges (Fig 10);
  4. traffic drift re-targets the hot set (unsupervised adaptation).

The speed claim is asserted here, on the host, as the reference states
it; on the card the serving phase of ``chip_smoke.py`` prints both times
and asserts none.  Claims 2-4 also run on the card (their ``[cuda]``
case, marked ``cuda``)."""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import EngineConfig, MorpheusRuntime, SketchConfig
from repro_torch.serving import ServeConfig, build_params, build_tables, \
    make_serve_step, make_synthetic_batch


DEVICES = ["cpu", pytest.param("cuda", marks=[
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA card")])]


def _runtime(device):
    cfg = ServeConfig()
    params = build_params(cfg, 0, device)
    for lp in params["layers"]:
        with torch.no_grad():
            lp["moe"]["b_router"][:3] = 6.0
    # per-class temperatures vary: the class table is NOT constant, so
    # the traffic-dependent fast path (not const-prop) is what fires
    tables = build_tables(cfg, uniform_temperature=False)
    rt = MorpheusRuntime(
        make_serve_step(cfg), tables, params,
        make_synthetic_batch(cfg, 0, device=device),
        cfg=EngineConfig(
            sketch=SketchConfig(sample_every=2, max_hot=4,
                                hot_coverage=0.6),
            features={"vision_enabled": False, "track_sessions": True},
            moe_router_table="router", device=device))
    return cfg, rt


@pytest.fixture(scope="module", params=DEVICES)
def system(request):
    """A runtime on each device, warmed on skewed traffic."""
    cfg, rt = _runtime(request.param)
    for i in range(30):
        rt.step(_batch(cfg, 100 + i, request.param))
    yield cfg, rt, request.param
    rt.close()


def _batch(cfg, seed, device="cpu", **kw):
    return make_synthetic_batch(cfg, seed, 8, "high", device=device, **kw)


def _median_step_time(rt, cfg, n=30, seed0=100):
    ts = []
    for i in range(n):
        b = _batch(cfg, seed0 + i)
        t0 = time.time()
        rt.step(b)
        ts.append(time.time() - t0)
    return float(np.median(ts))


def test_specialization_speeds_up_skewed_traffic():
    cfg, rt = _runtime("cpu")
    try:
        t_generic = _median_step_time(rt, cfg)
        rt.recompile(block=True)
        assert rt.hot_experts() is not None, "hot experts not detected"
        t_spec = _median_step_time(rt, cfg)
    finally:
        rt.close()
    assert t_spec < t_generic * 0.85, (
        f"expected >=15% speedup, got {t_generic/t_spec:.2f}x")


def test_specialization_is_semantics_preserving(system):
    cfg, rt, device = system
    rt.recompile(block=True)
    assert rt.hot_experts() is not None
    b = _batch(cfg, 4242, device)
    out_s = rt.step(b)
    out_g = rt.run_generic(b)
    torch.testing.assert_close(out_s, out_g, rtol=1e-4, atol=1e-4)


def test_control_plane_update_deopt_and_recover(system):
    cfg, rt, device = system
    rt.recompile(block=True)
    d0 = rt.stats.deopt_steps
    rt.control_update("req_class", {"temperature": np.full(
        cfg.n_classes, 1.7, np.float32)})
    b = _batch(cfg, 7, device)
    out_deopt = rt.step(b)
    assert rt.stats.deopt_steps == d0 + 1
    rt.recompile(block=True)
    out_spec = rt.step(b)
    torch.testing.assert_close(out_deopt, out_spec, rtol=1e-4, atol=1e-4)


def test_unsupervised_adaptation_to_drift(system):
    cfg, rt, device = system
    # earlier tests let the adaptive sampler back off; pin the cadence
    rt.sampler.pin(2)
    # ...and the control-plane test made temperatures CONSTANT, which
    # (correctly) promotes const-prop over the fast path — re-diversify
    rng = np.random.default_rng(1)
    rt.control_update("req_class", {"temperature": rng.uniform(
        0.5, 1.5, cfg.n_classes).astype(np.float32)})
    # phase A traffic
    for i in range(12):
        rt.step(_batch(cfg, i, device, hot_offset=0))
    rt.recompile(block=True)
    plan_a = rt.plan.sites
    # drift: new hot classes/tokens
    for i in range(12):
        rt.step(_batch(cfg, 500 + i, device, hot_offset=17))
    rt.recompile(block=True)
    plan_b = rt.plan.sites

    def hot_of(sites, table):
        return [s.hot_keys for sid, s in sites
                if sid.startswith(table) and s.impl == "hot_cache"]
    # the request-class hot set must have moved with the traffic
    a, b = hot_of(plan_a, "req_class"), hot_of(plan_b, "req_class")
    assert b, f"no fast path planned after drift: {plan_b}"
    assert a != b, f"hot set did not move: {a} vs {b}"
