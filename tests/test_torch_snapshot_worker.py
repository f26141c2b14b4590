"""The twins of ``tests/test_snapshot_worker.py`` on the port, on the
CPU: off-thread t1 snapshots with a versioned copy-on-write handoff (the
worker thread takes them, ``get`` waits for a version, a snapshot is
immune to later writes, writers hammering the TableSet never tear one,
a stopped worker raises) and the runtime's use of it (a blocking
recompile's snapshot taken off the caller's thread, a plan stamped with
its snapshot's version, ``close`` final and idempotent while the data
plane serves on)."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import EngineConfig, MorpheusRuntime, SketchConfig, \
    Table, TableSet, TableSnapshotWorker
from repro_torch.serving import ServeConfig, build_params, build_tables, \
    make_serve_step, make_synthetic_batch


def _tables(n=4):
    return TableSet([Table("t", {"a": np.zeros(n, np.int64),
                                 "b": np.zeros(n, np.int64)},
                           n_valid=n)])


def test_snapshot_runs_on_worker_thread():
    ts = _tables()
    w = TableSnapshotWorker(ts)
    try:
        snap = w.get(0)
        assert snap.version == 0
        assert snap.thread_ident != threading.get_ident()
        assert snap.thread_ident == w._thread.ident
        assert snap.thread_name == "morpheus-snapshot"
    finally:
        w.stop()


def test_get_waits_for_requested_version():
    ts = _tables()
    w = TableSnapshotWorker(ts)
    try:
        assert w.get(0).version == 0
        v = ts.control_update("t", {"a": np.arange(4)})
        snap = w.get(v)
        assert snap.version == v
        np.testing.assert_array_equal(snap.tables["t"].fields["a"],
                                      np.arange(4))
        with pytest.raises(TimeoutError):
            w.get(v + 100, timeout=0.2)     # future version never arrives
    finally:
        w.stop()


def test_cow_snapshot_immune_to_later_updates():
    """The handed-off snapshot is frozen at its version: control-plane
    writes after the handoff must not leak into it (copy-on-write)."""
    ts = _tables()
    ts.control_update("t", {"a": np.full(4, 7), "b": np.full(4, 7)})
    w = TableSnapshotWorker(ts)
    try:
        snap = w.get(ts.version)
        ts.control_update("t", {"a": np.full(4, 9), "b": np.full(4, 9)})
        np.testing.assert_array_equal(snap.tables["t"].fields["a"],
                                      np.full(4, 7))
        fresh = w.get(ts.version)
        np.testing.assert_array_equal(fresh.tables["t"].fields["a"],
                                      np.full(4, 9))
    finally:
        w.stop()


def test_concurrent_updates_observe_consistent_versions():
    """Hammer the TableSet from a writer thread while snapshotting: every
    snapshot must be internally consistent (paired fields agree — no torn
    reads) and stamped with the version its contents belong to."""
    ts = _tables()
    w = TableSnapshotWorker(ts)
    stop = threading.Event()
    expected = {0: 0}

    def writer():
        i = 0
        while not stop.is_set():
            i += 1
            v = ts.control_update("t", {"a": np.full(4, i),
                                        "b": np.full(4, i)})
            expected[v] = i
            time.sleep(0)

    th = threading.Thread(target=writer)
    th.start()
    try:
        seen = 0
        for _ in range(200):
            snap = w.get(None, timeout=5.0)
            t = snap.tables["t"]
            a, b = t.fields["a"], t.fields["b"]
            np.testing.assert_array_equal(a, b)       # no torn snapshot
            assert (a == a[0]).all()
            assert expected[snap.version] == int(a[0])  # version matches
            seen += 1
        assert seen == 200
    finally:
        stop.set()
        th.join()
        w.stop()


def test_stopped_worker_raises():
    w = TableSnapshotWorker(_tables())
    w.stop()
    with pytest.raises(RuntimeError):
        w.get(0)


# ---------------------------------------------------------------------------
# runtime integration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runtime():
    cfg = ServeConfig()
    rt = MorpheusRuntime(
        make_serve_step(cfg), build_tables(cfg),
        build_params(cfg, 0, "cpu"),
        make_synthetic_batch(cfg, 0, device="cpu"),
        cfg=EngineConfig(sketch=SketchConfig(sample_every=2, max_hot=4,
                                             hot_coverage=0.5),
                         features={"vision_enabled": False,
                                   "track_sessions": True},
                         moe_router_table="router", device="cpu"))
    yield cfg, rt
    rt.close()


def test_recompile_t1_snapshot_off_caller_thread(runtime):
    """Even a blocking recompile never runs the t1 table snapshot on the
    control-plane caller's thread."""
    cfg, rt = runtime
    for i in range(4):
        rt.step(make_synthetic_batch(cfg, i, 8, device="cpu"))
    info = rt.recompile(block=True)
    assert info is not None
    snap = rt.last_snapshot
    assert snap is not None
    assert snap.thread_ident != threading.get_ident()
    assert snap.thread_ident == rt.snapshot_worker._thread.ident
    assert rt.stats.snapshot_versions[-1] == snap.version


def test_recompile_uses_snapshot_version_not_live_version(runtime):
    """A control update racing past the snapshot leaves the new plan
    stamped with the snapshot's version, so the program guard deopts it
    instead of serving a plan that claims to match newer tables."""
    cfg, rt = runtime
    snap = rt.snapshot_worker.get(rt.tables.version)
    plan, _, _ = rt.engine.build_plan({}, snapshot=snap.tables,
                                      version=snap.version)
    assert plan.version == snap.version
    with pytest.raises(ValueError):
        # an injected snapshot without its version would get stamped
        # with the live version and dodge the deopt guard
        rt.engine.build_plan({}, snapshot=snap.tables)
    rt.control_update("req_class",
                      {"temperature": np.full(4, 1.5, np.float32)})
    assert rt.tables.version > plan.version   # guard would deopt this plan
    rt.recompile(block=True)
    assert rt.plan.version == rt.tables.version


def test_close_is_final_and_idempotent(runtime):
    """After close(), recompiles raise instead of silently restarting
    the worker thread.  Runs last in this module: the fixture's teardown
    close() stays a no-op."""
    cfg, rt = runtime
    rt.close()
    with pytest.raises(RuntimeError):
        rt.recompile(block=True)
    rt.close()                                # idempotent
    # the data plane keeps serving
    out = rt.step(make_synthetic_batch(cfg, 7, 8, device="cpu"))
    assert torch.isfinite(out).all()
