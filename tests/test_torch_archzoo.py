"""The port's arch-zoo planes against the reference's, for every arch in
``ARCH_IDS``: the numpy generators (tables, batches, frontend rows) give
the same arrays bit for bit; one generic plane step on the same tables,
weights (the reference's, carried across) and batch gives the same
logits and table writes (atol=rtol=1e-5: f32 arithmetic summed in other
orders; integer counters exact); and an equal plan fingerprints equally
in both packages."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.core import MorpheusEngine as JEngine
from repro.core.passes.table_jit import _Frozen as JFrozen
from repro.core.specialize import SiteSpec as JSiteSpec, \
    SpecializationPlan as JPlan
from repro.testing import archzoo as JA
from repro.testing.fingerprint import plan_fingerprint as j_fingerprint
from repro_torch.core import MorpheusEngine, SiteSpec, SpecializationPlan
from repro_torch.core.passes.table_jit import _Frozen
from repro_torch.testing import archzoo as TA
from repro_torch.testing.fingerprint import plan_fingerprint

TOL = dict(rtol=1e-5, atol=1e-5)


def _planes(arch):
    jplane = JA.build_plane(arch)
    tplane = TA.build_plane(arch)
    return jplane, tplane


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plane_and_generators_equal_the_reference(arch):
    jplane, tplane = _planes(arch)
    assert dataclasses.asdict(tplane.cfg) == dataclasses.asdict(jplane.cfg)
    assert tplane.blocks == tuple(
        type(tplane.blocks[0])(**dataclasses.asdict(b))
        for b in jplane.blocks)
    for f in ("seq", "vocab", "has_ssm", "has_moe", "has_cross",
              "has_media", "features", "batch_fields"):
        assert getattr(tplane, f) == getattr(jplane, f), f
    jt, tt = JA.build_tables(jplane, 5), TA.build_tables(tplane, 5)
    assert list(tt.tables) == list(jt.tables)
    for name, t in tt.tables.items():
        j = jt.tables[name]
        assert (t.n_valid, t.mutability, t.max_inline) == \
            (j.n_valid, j.mutability, j.max_inline)
        assert list(t.fields) == list(j.fields)
        for k, v in t.fields.items():
            assert v.dtype == j.fields[k].dtype
            np.testing.assert_array_equal(v, j.fields[k])
    for seed in (0, 7):
        traffic = (TA.TrafficState(3, 5, 2), JA.TrafficState(3, 5, 2))
        tb = TA.make_batch(tplane, np.random.default_rng(seed), traffic[0])
        jb = JA.make_batch(jplane, np.random.default_rng(seed), traffic[1])
        assert list(tb) == list(jb)
        for k in tb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
        tr = TA.make_rows(tplane, np.random.default_rng(seed), 5)
        jr = JA.make_rows(jplane, np.random.default_rng(seed), 5)
        for a, b in zip(tr, jr):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_generic_plane_step_matches_reference(arch):
    """One generic step through each package's engine, on the same
    tables, the reference's weights and one batch: logits and every
    table the step writes."""
    jplane, tplane = _planes(arch)
    jparams = JA.build_params(jplane, 0)
    tparams = TA.params_from_numpy(_np(jparams), "cpu")
    batch = JA.make_batch(jplane, np.random.default_rng(11))

    jeng = JEngine(JA.make_step(jplane), JA.build_tables(jplane, 0),
                   JA.conformance_engine_config(jplane))
    jeng.analyze(jparams, batch)
    jstep = jax.jit(jeng.make_step_fn(jeng.generic_plan()))
    jout, jstate = jstep(jparams, jeng.init_state(), batch)

    teng = MorpheusEngine(TA.make_step(tplane), TA.build_tables(tplane, 0),
                          TA.conformance_engine_config(tplane,
                                                       device="cpu"))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    teng.analyze(tparams, tbatch)
    assert [(s.table, s.site_id, s.kind) for s in teng.sites] == \
        [(s.table, s.site_id, s.kind) for s in jeng.sites]
    tout, tstate = teng.make_step_fn(teng.generic_plan())(
        tparams, teng.init_state(), tbatch)

    assert tout.shape == jout.shape == (4, tplane.seq, tplane.vocab)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for name in ("sessions", "ssm_state"):
        if name not in jstate.tables:
            continue
        for k, v in tstate.tables[name].items():
            ref = np.asarray(jstate.tables[name][k])
            if ref.dtype.kind == "f":
                np.testing.assert_allclose(v.numpy(), ref, **TOL)
            else:
                np.testing.assert_array_equal(v.numpy(), ref)


def test_equal_plans_fingerprint_equally_in_both_packages():
    inline = np.linspace(0.5, 1.5, 8, dtype=np.float32)
    const = np.zeros(3, np.int32)

    def plan(SS, Plan, Frozen):
        return Plan(version=4, sites=(
            ("req_class#0", SS(impl="inline_const",
                               inline_fields=(("temperature",
                                               Frozen(inline)),))),
            ("sessions#0", SS(impl="hot_cache", hot_keys=(3, 1, 2),
                              guarded=True)),
            ("ssm_state#0", SS(impl="ssd_fastpath", hot_keys=(0, 5))),
            ("flags#0", SS(impl="const_row",
                           const_fields=(("bits", Frozen(const)),))),
        ), flags={"aux_bias": True, "out_norm": False}, instrumented=True,
            label="specialized")

    tplan = plan(SiteSpec, SpecializationPlan, _Frozen)
    jplan = plan(JSiteSpec, JPlan, JFrozen)
    assert plan_fingerprint(tplan) == j_fingerprint(jplan)
    assert plan_fingerprint(tplan) == j_fingerprint(tplan)
    other = dataclasses.replace(tplan, flags={"aux_bias": False,
                                              "out_norm": False})
    assert plan_fingerprint(other) != plan_fingerprint(tplan)
