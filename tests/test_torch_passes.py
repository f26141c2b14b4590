"""Plan parity: on the same table snapshot and the same sketches, the
port's pass registry plans what the reference's plans — equal
``repro.testing.fingerprint.plan_fingerprint`` — under high, low and no
locality, with constant and varying request-class tables."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JEngineConfig, \
    SketchConfig as JSketchConfig
from repro.core import instrument as JI
from repro.core.engine import MorpheusEngine as JEngine
from repro.core.passes import default_registry as j_default_registry
from repro.serving import ServeConfig as JServeConfig, \
    build_params as j_build_params, build_tables as j_build_tables, \
    make_serve_step as j_make_serve_step, \
    make_synthetic_batch as j_make_synthetic_batch
from repro.testing.fingerprint import plan_fingerprint
from repro_torch.core import EngineConfig, SketchConfig
from repro_torch.core.engine import MorpheusEngine
from repro_torch.core.passes import default_registry
from repro_torch.serving import ServeConfig, build_tables, \
    make_serve_step, params_from_numpy

FEATURES = {"vision_enabled": False, "track_sessions": True}


def test_default_registry_has_the_reference_passes_in_order():
    assert default_registry("router", "s").names() == \
        j_default_registry("router", "s").names()


def test_cost_constants_are_the_reference_planners():
    """Cost constants: the data-structure pass keeps the reference
    planner's parameters unchanged, so both packages plan the same
    sites; retuning them would break plan parity."""
    from repro.core.passes import dstruct as J
    from repro_torch.core.passes import dstruct as T
    for name in ("MXU_FLOPS", "HBM_BW", "GATHER_TXN_BYTES"):
        assert getattr(T, name) == getattr(J, name)


@pytest.fixture(scope="module")
def planes():
    """Both engines, analyzed on the serving plane with the reference's
    weights carried across; sketch config max_hot=32 as in the smoke.
    Static analysis: the reference traces abstractly (``eval_shape``),
    the port runs the step once, eagerly, on a scratch copy of the
    tables; both must register the same call sites."""
    jcfg, tcfg = JServeConfig(), ServeConfig()
    params = j_build_params(jcfg, jax.random.PRNGKey(0))
    batch = j_make_synthetic_batch(jcfg, jax.random.PRNGKey(0))
    sketch = dict(sample_every=4, max_hot=32, hot_coverage=0.8)
    out = {}
    for uniform in (True, False):
        je = JEngine(j_make_serve_step(jcfg),
                     j_build_tables(jcfg, None,
                                    uniform_temperature=uniform),
                     JEngineConfig(sketch=JSketchConfig(**sketch),
                                   features=dict(FEATURES),
                                   moe_router_table="router"))
        je.analyze(params, batch)
        te = MorpheusEngine(
            make_serve_step(tcfg),
            build_tables(tcfg, uniform_temperature=uniform),
            EngineConfig(sketch=SketchConfig(**sketch),
                         features=dict(FEATURES),
                         moe_router_table="router", device="cpu"))
        te.analyze(params_from_numpy(jax.tree.map(np.asarray, params),
                                     "cpu"),
                   {k: torch.from_numpy(np.array(v))
                    for k, v in batch.items()})
        out[uniform] = (je, te)
    return jcfg, out


def _sketches(jcfg, je, locality, seed=0):
    """Sketches recorded by the reference's ``record`` from batches of
    the given locality (expert ids drawn with the same skew), as the
    host numpy arrays a recompile cycle reads."""
    cfg = je.cfg.sketch
    rng = np.random.default_rng(seed)
    n_exp = {"high": 3, "low": 8, "none": 16}[locality]
    st = {sid: JI.init_site_state(cfg) for sid in je.instrumented_sites()}
    for i in range(6):
        b = j_make_synthetic_batch(jcfg, jax.random.PRNGKey(seed + i), 8,
                                   locality)
        keys = {"req_class": b["class_id"], "vocab_embed": b["tokens"],
                "router": jnp.asarray(rng.integers(0, n_exp, 8 * 16 * 2),
                                      jnp.int32)}
        for sid in st:
            st[sid] = JI.record(st[sid], keys[sid.split("#")[0]], cfg)
    return {sid: {k: np.asarray(v) for k, v in s.items()}
            for sid, s in st.items()}


@pytest.mark.parametrize("uniform", [True, False],
                         ids=["const-classes", "varied-classes"])
@pytest.mark.parametrize("locality", ["high", "low", "none"])
def test_plan_fingerprint_matches_reference(planes, locality, uniform):
    jcfg, by_uniform = planes
    je, te = by_uniform[uniform]
    assert [(s.site_id, s.kind, s.fields) for s in te.sites] == \
        [(s.site_id, s.kind, s.fields) for s in je.sites]
    assert te.mutability == je.mutability
    assert te.instrumented_sites() == je.instrumented_sites()
    instr = _sketches(jcfg, je, locality)
    for instrumented in (False, True):
        jplan, _, jstats = je.build_plan(instr, instrumented=instrumented)
        tplan, _, tstats = te.build_plan(instr, instrumented=instrumented)
        assert tstats == jstats
        assert [(sid, s.impl, s.hot_keys) for sid, s in tplan.sites] == \
            [(sid, s.impl, s.hot_keys) for sid, s in jplan.sites]
        assert plan_fingerprint(tplan) == plan_fingerprint(jplan)
    impls = dict((sid, s.impl) for sid, s in tplan.sites)
    if locality == "high":
        assert impls["vocab_embed#0"] == "hot_cache"
        assert impls["router#0"] == "moe_fastpath"
    else:
        assert "vocab_embed#0" not in impls
