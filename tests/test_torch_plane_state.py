"""The twins of ``tests/test_plane_state.py`` on the port, on the CPU:
the PlaneState's three fields holding every tensor of the plane and
``replace`` sharing the rest, executables replaying one state, the flag-keying contract, and the pluggable pass
registry (order and lookup, register before / after / remove, a custom
pass claiming a site first, the MoE hot path as a ``moe_fastpath`` site
spec).

The port's PlaneState is a plain dataclass, not a pytree: nothing in the
port flattens it.  The twins of the two pytree tests hold the same
properties through its fields.  The port does not donate
(``core/state.py``): the twin of ``test_donation_does_not_change_results``
replays the same PlaneState twice and gets equal outputs and states.  ``test_compile_accepts_per_leaf_shardings``
waits for the mesh (ROADMAP item 12).  The registry's order equal to the
reference's is also held by
``test_torch_passes.py::test_default_registry_has_the_reference_passes_in_order``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import DataPlaneCtx, EngineConfig, MorpheusEngine, \
    MorpheusRuntime, PlaneState, SiteSpec, SketchConfig, \
    SpecializationPass, default_registry
from repro_torch.serving import ServeConfig, build_params, build_tables, \
    make_serve_step, make_synthetic_batch

SK = SketchConfig(sample_every=2, max_hot=4, hot_coverage=0.5)
FEATURES = {"vision_enabled": False, "track_sessions": True}


def _batch(cfg, seed=0, **kw):
    return make_synthetic_batch(cfg, seed, device="cpu", **kw)


@pytest.fixture(scope="module")
def engine():
    cfg = ServeConfig()
    params = build_params(cfg, 0, "cpu")
    eng = MorpheusEngine(
        make_serve_step(cfg), build_tables(cfg),
        EngineConfig(sketch=SK, features=dict(FEATURES),
                     moe_router_table="router", device="cpu"))
    batch = _batch(cfg)
    eng.analyze(params, batch)
    return cfg, eng, params, batch


# ---------------------------------------------------------------------------
# PlaneState
# ---------------------------------------------------------------------------

def _leaves(state):
    """Every tensor of a PlaneState, in field and key order."""
    out = []
    for f in dataclasses.fields(state):
        for sub in getattr(state, f.name).values():
            out.extend(sub.values() if isinstance(sub, dict) else [sub])
    return out


def test_plane_state_fields_roundtrip(engine):
    _, eng, _, _ = engine
    state = eng.init_state()
    assert [f.name for f in dataclasses.fields(PlaneState)] == \
        ["tables", "instr", "guards"]
    leaves = _leaves(state)
    assert len(leaves) > 0
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in leaves)
    rebuilt = PlaneState(**{f.name: getattr(state, f.name)
                            for f in dataclasses.fields(state)})
    assert set(rebuilt.tables) == set(state.tables)
    assert set(rebuilt.instr) == set(state.instr)
    assert set(rebuilt.guards) == set(state.guards)
    for a, b in zip(leaves, _leaves(rebuilt)):
        assert torch.equal(a, b)


def test_plane_state_replace_shares_leaves(engine):
    _, eng, _, _ = engine
    state = eng.init_state()
    temps = state.tables["req_class"]["temperature"]
    doubled = state.replace(tables={**state.tables, "req_class": {
        **state.tables["req_class"], "temperature": temps * 2}})
    assert isinstance(doubled, PlaneState)
    assert torch.equal(doubled.tables["req_class"]["temperature"],
                       2 * temps)
    assert state.tables["req_class"]["temperature"] is temps
    swapped = state.replace(guards={})
    assert swapped.guards == {} and swapped.tables is state.tables


def test_replaying_a_state_does_not_change_results(engine):
    """The port's form of the reference's donation test: executables
    never write their input, so one state stepped twice gives equal
    outputs and equal new states, and the input is left as it was."""
    _, eng, params, batch = engine
    exe, _ = eng.compile(eng.generic_plan(), eng.init_state())
    state = eng.init_state()
    before = [t.clone() for t in _leaves(state)]
    out_a, st_a = exe(params, state, batch)
    out_b, st_b = exe(params, state, batch)
    assert torch.equal(out_a, out_b)
    for a, b in zip(_leaves(st_a), _leaves(st_b)):
        assert torch.equal(a, b)
    for a, b in zip(before, _leaves(state)):
        assert torch.equal(a, b)
    assert int(st_a.guards["sessions"][0]) == 1      # the step did write


# ---------------------------------------------------------------------------
# flag keying contract
# ---------------------------------------------------------------------------

def test_ctx_flag_and_plan_flags_agree_on_keying(engine):
    """Regression: plan flags are keyed by flag NAME (what ctx.flag looks
    up), never by the flag call site's id."""
    _, eng, _, _ = engine
    plan, _, _ = eng.build_plan({})
    assert plan.flags["vision_enabled"] is False
    assert plan.flags["track_sessions"] is True
    flag_sites = [s.site_id for s in eng.sites if s.kind == "flag"]
    assert flag_sites, "serve step registers flag sites"
    assert not any(sid in plan.flags for sid in flag_sites)

    ctx = DataPlaneCtx(plan, eng.init_state(), eng.cfg.sketch)
    assert ctx.flag("vision_enabled", default=True) is False
    assert ctx.flag("unplanned_flag", default=True) is True


# ---------------------------------------------------------------------------
# pass registry
# ---------------------------------------------------------------------------

def test_default_registry_order_and_lookup():
    reg = default_registry("router")
    names = reg.names()
    assert names.index("eliminated") < names.index("inlined") \
        < names.index("const_row") < names.index("moe_fastpath") \
        < names.index("fastpath") < names.index("onehot")
    assert names[-1] == "guard_elision"
    assert reg.get("moe_fastpath").router_table == "router"


def test_registry_register_before_after_remove():
    reg = default_registry(None)

    class NopPass(SpecializationPass):
        name = "nop"
    reg.register(NopPass(), before="fastpath")
    names = reg.names()
    assert names.index("nop") == names.index("fastpath") - 1
    reg.remove("nop")
    assert "nop" not in reg.names()
    reg.register(NopPass(), after="eliminated")
    assert reg.names().index("nop") == reg.names().index("eliminated") + 1
    with pytest.raises(ValueError):
        reg.register(NopPass())          # duplicate name

    class OtherPass(SpecializationPass):
        name = "other"
    before = reg.names()
    with pytest.raises(KeyError):
        reg.register(OtherPass(), before="does_not_exist")
    # failed register must leave the pipeline unchanged
    assert reg.names() == before


def test_custom_pass_claims_site_first(engine):
    """A user-registered pass ahead of the pipeline overrides the
    engine's decision for the sites it matches."""
    cfg_s, _, params, batch = engine

    class PinGather(SpecializationPass):
        name = "pin_gather"

        def match(self, site):
            return site.kind == "lookup" and site.table == "req_class"

        def plan(self, site, snapshot, stats):
            return SiteSpec(impl="gather")

    reg = default_registry("router")
    reg.register(PinGather(), before="eliminated")
    eng = MorpheusEngine(
        make_serve_step(cfg_s), build_tables(cfg_s),
        EngineConfig(sketch=SK, passes=reg, moe_router_table="router",
                     device="cpu"))
    eng.analyze(params, batch)
    plan, _, stats = eng.build_plan({})
    assert stats["pin_gather"] >= 1
    impls = {sid.split("#")[0]: s.impl for sid, s in plan.sites}
    assert impls["req_class"] == "gather"     # not const_row/inline


def test_moe_pass_emits_site_spec_not_flag():
    """The MoE hot path is a registered pass producing a moe_fastpath
    SiteSpec on the router site — no __moe_hot__ side-channel."""
    cfg_s = ServeConfig()
    params = build_params(cfg_s, 0, "cpu")
    for lp in params["layers"]:
        with torch.no_grad():
            lp["moe"]["b_router"][:3] = 6.0
    rt = MorpheusRuntime(
        make_serve_step(cfg_s), build_tables(cfg_s), params,
        _batch(cfg_s),
        cfg=EngineConfig(sketch=SK, features=dict(FEATURES),
                         moe_router_table="router", device="cpu"))
    try:
        for i in range(8):
            rt.step(_batch(cfg_s, i, batch_size=8, locality="high"))
        rt.recompile(block=True)
        hot = rt.hot_experts()
        assert hot is not None and len(hot) >= 1
        assert rt.plan.hot_experts("router") == hot
        assert "__moe_hot__" not in (rt.plan.flags or {})
        impls = {sid: s.impl for sid, s in rt.plan.sites}
        assert any(sid.startswith("router#") and impl == "moe_fastpath"
                   for sid, impl in impls.items())
    finally:
        rt.close()
