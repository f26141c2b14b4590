"""The port's core data model against the reference's, bit for bit, on
the same numpy inputs: the sketch hash, ``record`` / ``estimate`` /
``hot_keys`` (including more keys than the candidate ring holds, and -1
keys), ``dispatch_lookup`` for every impl, and ``ctx.update`` with
repeated slots."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import instrument as JI
from repro.core import specialize as JS
from repro.core.ctx import DataPlaneCtx as JCtx
from repro.core.passes import const_prop as JCP, table_jit as JTJ
from repro.core.state import PlaneState as JState
from repro.core.tables import Table as JTable
from repro_torch.core import instrument as TI
from repro_torch.core import specialize as TS
from repro_torch.core.ctx import DataPlaneCtx as TCtx
from repro_torch.core.passes import const_prop as TCP, table_jit as TTJ
from repro_torch.core.state import PlaneState as TState
from repro_torch.core.tables import Table as TTable, TableSet as TTableSet


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _keys(n, seed, lo=-1, hi=200):
    return np.random.default_rng(seed).integers(lo, hi, n).astype(np.int32)


# ---------------------------------------------------------------------------
# instrumentation
# ---------------------------------------------------------------------------

def test_hash_wraps_like_the_reference_uint32_hash():
    """Hash: the reference multiplies in uint32 and wraps; the port
    computes in int64 and masks to 32 bits.  Negative keys read as
    uint32 (-1 -> 0xFFFFFFFF)."""
    keys = np.concatenate([
        np.asarray([-1, -2, 0, 1, 2**31 - 1, -2**31], np.int32),
        np.random.default_rng(0).integers(-2**31, 2**31 - 1, 500,
                                          dtype=np.int64).astype(np.int32)])
    for row in range(9):
        for width in (512, 97, 1):
            want = JI._hash(jnp.asarray(keys), row, width)
            got = TI._hash(torch.from_numpy(keys), row, width)
            np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("n", [50, 128, 300, 1024])
def test_record_estimate_hot_keys_match_reference(n):
    """Candidate ring with repeated positions: a step with more keys
    than ``candidates`` (the router site sees B*S*top_k = 1024 at the
    smoke size) writes positions more than once; the reference keeps the
    last write, and so must the port."""
    cfg = JI.SketchConfig(max_hot=8)
    tcfg = TI.SketchConfig(max_hot=8)
    js = JI.init_site_state(cfg)
    ts = TI.init_site_state(tcfg, "cpu")
    for step in range(3):
        keys = _keys(n, step, hi=40 + 60 * step)
        js = JI.record(js, jnp.asarray(keys), cfg)
        ts = TI.record(ts, torch.from_numpy(keys), tcfg)
        for k in ("cms", "cand", "ptr", "total"):
            np.testing.assert_array_equal(_np(ts[k]), np.asarray(js[k]),
                                          err_msg=f"{k} step {step}")
    probe = np.arange(-1, 250, dtype=np.int32)
    np.testing.assert_array_equal(
        _np(TI.estimate(ts, torch.from_numpy(probe))),
        np.asarray(JI.estimate(js, jnp.asarray(probe))))
    host_j = {k: np.asarray(v) for k, v in js.items()}
    host_t = {k: _np(v) for k, v in ts.items()}
    hj, cj, nj = JI.hot_keys(host_j, cfg)
    ht, ct, nt = TI.hot_keys(host_t, tcfg)
    np.testing.assert_array_equal(ht, hj)
    assert (ct, nt) == (cj, nj)


def test_candidate_ring_keeps_the_last_write():
    cfg = JI.SketchConfig(candidates=3)
    tcfg = TI.SketchConfig(candidates=3)
    for keys in ([10, 11, 12, 13, 14], [10, 11, 12, 13, -1],
                 [-1, -1, 7, 8, 9, -1, 5]):
        keys = np.asarray(keys, np.int32)
        js = JI.record(JI.init_site_state(cfg), jnp.asarray(keys), cfg)
        ts = TI.record(TI.init_site_state(tcfg, "cpu"),
                       torch.from_numpy(keys), tcfg)
        np.testing.assert_array_equal(_np(ts["cand"]),
                                      np.asarray(js["cand"]))
    np.testing.assert_array_equal(_np(ts["cand"]), [5, 9, -1])


def test_double_buffer_publishes_a_copy():
    buf = TI.SketchDoubleBuffer()
    st = {"s#0": TI.init_site_state(TI.SketchConfig(), "cpu")}
    buf.publish(st)
    st["s#0"]["cms"] += 1                  # the live sketch moves on
    assert int(buf.read()["s#0"]["cms"].sum()) == 0
    assert buf.seq == 1


# ---------------------------------------------------------------------------
# dispatch_lookup, every impl
# ---------------------------------------------------------------------------

def _table_fields(seed=0):
    rng = np.random.default_rng(seed)
    return {"vec": rng.standard_normal((12, 6)).astype(np.float32),
            "cls": rng.integers(0, 5, 12).astype(np.int32)}


def _spec_pair(impl, fields):
    """The same SiteSpec in both packages, made by each package's own
    pass where a pass makes it."""
    if impl == "inline_const":
        return (JTJ.propose_inline(JTable("t", fields, 12, max_inline=16),
                                   "ro"),
                TTJ.propose_inline(TTable("t", fields, 12, max_inline=16),
                                   "ro"))
    if impl == "const_row":
        const = {k: np.broadcast_to(v[:1], v.shape).copy()
                 for k, v in fields.items()}
        return (JCP.propose_const_row(JTable("t", const, 12), "ro"),
                TCP.propose_const_row(TTable("t", const, 12), "ro"))
    if impl == "eliminated":
        return (JTJ.propose_eliminate(JTable("t", fields, 0,
                                             default={"vec": 0.5})),
                TTJ.propose_eliminate(TTable("t", fields, 0,
                                             default={"vec": 0.5})))
    kw = {"hot_keys": (3, 7, 0)} if impl in ("hot_cache",
                                              "moe_fastpath") else {}
    if impl == "hot_cache_guarded":
        impl, kw = "hot_cache", {"hot_keys": (3, 7, 0), "guarded": True}
    return JS.SiteSpec(impl=impl, **kw), TS.SiteSpec(impl=impl, **kw)


@pytest.mark.parametrize("impl", [
    "gather", "onehot", "hot_cache", "hot_cache_guarded", "inline_const",
    "const_row", "eliminated", "moe_fastpath", "ssd_fastpath"])
@pytest.mark.parametrize("guard", [0, 1])
def test_dispatch_lookup_matches_reference(impl, guard):
    fields = _table_fields()
    if impl == "const_row":
        fields = {k: np.broadcast_to(v[:1], v.shape).copy()
                  for k, v in fields.items()}
    jspec, tspec = _spec_pair(impl, fields)
    assert jspec is not None and tspec is not None
    jplan = JS.SpecializationPlan(sites=(("t#0", jspec),))
    tplan = TS.SpecializationPlan(sites=(("t#0", tspec),))
    idx = np.asarray([[0, 3, 11], [7, 7, 2]], np.int32)
    jguards = {"t": jnp.full((1,), guard, jnp.int32)}
    tguards = {"t": torch.full((1,), guard, dtype=torch.int32)}
    jtab = {"t": {k: jnp.asarray(v) for k, v in fields.items()}}
    ttab = {"t": {k: torch.from_numpy(v.copy()) for k, v in fields.items()}}
    for names in (("vec",), ("cls",), None):
        want = JS.dispatch_lookup(jplan, "t#0", "t", jtab,
                                  jnp.asarray(idx), names, jguards)
        consts = TS.plan_constants(tplan, ttab, "cpu")
        for c in (None, consts):
            got = TS.dispatch_lookup(tplan, "t#0", "t", ttab,
                                     torch.from_numpy(idx), names,
                                     tguards, c)
            assert sorted(got) == sorted(want)
            for f in want:
                assert got[f].dtype == getattr(torch, str(want[f].dtype))
                np.testing.assert_array_equal(_np(got[f]),
                                              np.asarray(want[f]))


# ---------------------------------------------------------------------------
# ctx.update with repeated slots
# ---------------------------------------------------------------------------

def test_ctx_update_repeated_slots_last_write_wins():
    """Sessions scatter with repeated slots: the reference's scatter
    keeps the last write (checked here against it); the port writes, at
    each repeated slot, the value of its last occurrence, so any write
    order on the card gives the same table."""
    n = 16
    count = np.arange(n, dtype=np.int32) * 10
    last = np.zeros(n, np.int32)
    slot = np.asarray([3, 5, 3, 9, 5, 3, 0, 15], np.int32)
    new_count = np.arange(8, dtype=np.int32) + 100
    new_tok = np.arange(8, dtype=np.int32) + 1000
    jst = JState({"sessions": {"count": jnp.asarray(count),
                               "last_token": jnp.asarray(last)}},
                 {}, {"sessions": jnp.zeros((1,), jnp.int32)})
    tst = TState({"sessions": {"count": torch.from_numpy(count.copy()),
                               "last_token": torch.from_numpy(last.copy())}},
                 {}, {"sessions": torch.zeros((1,), dtype=torch.int32)})
    jctx = JCtx(JS.GENERIC_PLAN, jst, JI.SketchConfig())
    tctx = TCtx(TS.GENERIC_PLAN, tst, TI.SketchConfig())
    jctx.update("sessions", jnp.asarray(slot),
                {"count": jnp.asarray(new_count),
                 "last_token": jnp.asarray(new_tok)})
    tctx.update("sessions", torch.from_numpy(slot),
                {"count": torch.from_numpy(new_count),
                 "last_token": torch.from_numpy(new_tok)})
    jout, tout = jctx.outputs(), tctx.outputs()
    for f in ("count", "last_token"):
        np.testing.assert_array_equal(_np(tout.tables["sessions"][f]),
                                      np.asarray(jout.tables["sessions"][f]))
    assert int(tout.tables["sessions"]["count"][3]) == 105
    assert int(tout.guards["sessions"][0]) == 1
    # the input state is not written
    np.testing.assert_array_equal(_np(tst.tables["sessions"]["count"]),
                                  count)


def test_table_set_control_update_is_copy_on_write():
    ts = TTableSet([TTable("t", _table_fields(), 12)])
    v0, snap = ts.cow_snapshot()
    before = snap["t"].fields["vec"].copy()
    assert ts.control_update("t", {"vec": np.zeros((2, 6), np.float32)}) \
        == v0 + 1
    np.testing.assert_array_equal(snap["t"].fields["vec"], before)
    assert not ts["t"].fields["vec"][:2].any()
    dev = ts["t"].device_arrays("cpu")["vec"]
    dev += 1                                # device copy never aliases
    assert not ts["t"].fields["vec"][:2].any()
