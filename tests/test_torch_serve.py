"""The port's serving CLI (``repro_torch.launch.serve``) on the CPU.

``run_serve`` at the default config gives the same outputs, tables and
plans whether it serves single steps or fused windows of 4, with one or
two units in flight; ``--no-morpheus`` recompiles nothing; the
controller fleet and the request frontend account for every step and
request; ``main`` runs with ``--device cpu``; ``--mesh`` and
``--xla-cache-dir`` follow the port's rules.  The plans against the
reference's ``run_serve`` are in ``test_torch_serve_plans.py``."""
import pytest
import torch

import repro_torch.launch.serve as T
from repro_torch.core import MorpheusRuntime
from repro_torch.testing.fingerprint import plan_fingerprint


def _tap_outputs(monkeypatch):
    """Record every step's output (windows split into their steps)."""
    outs = []
    real_step, real_many = MorpheusRuntime.step, MorpheusRuntime.step_many

    def step(self, batch):
        out = real_step(self, batch)
        outs.append(out.clone())
        return out

    def step_many(self, batches, k=None):
        out = real_many(self, batches, k=k)
        outs.extend(o.clone() for o in out)
        return out

    monkeypatch.setattr(MorpheusRuntime, "step", step)
    monkeypatch.setattr(MorpheusRuntime, "step_many", step_many)
    return outs


STEPS = 24          # two recompiles, at 12 and 24, at fuse 1 and 4


def _serve(monkeypatch, **kw):
    with monkeypatch.context() as m:
        outs = _tap_outputs(m)
        stats, rt = T.run_serve(steps=STEPS, recompile_every=12,
                                quiet=True, device="cpu", **kw)
    try:
        tables = {f: v.clone() for f, v in
                  rt.state.tables["sessions"].items()}
        return stats, outs, tables, plan_fingerprint(rt.plan), \
            rt.hot_experts()
    finally:
        rt.close()


@pytest.fixture(scope="module")
def single_steps():
    """The default loop (fuse 1, inflight 1), served once for the file."""
    mp = pytest.MonkeyPatch()
    try:
        return _serve(mp)
    finally:
        mp.undo()


@pytest.mark.parametrize("fuse,inflight", [(4, 1), (1, 2), (4, 2)])
def test_run_serve_fused_and_pipelined_equal_single_steps(
        monkeypatch, single_steps, fuse, inflight):
    base = single_steps
    got = _serve(monkeypatch, fuse=fuse, inflight=inflight)
    stats, outs, tables, fp, hot = got
    assert stats["steps"] == base[0]["steps"] == STEPS
    assert stats["fuse"] == fuse and stats["inflight"] == inflight
    assert len(outs) == len(base[1]) == STEPS
    for a, b in zip(outs, base[1]):
        assert torch.equal(a, b)
    for f in tables:
        assert torch.equal(tables[f], base[2][f])
    assert (fp, hot) == (base[3], base[4])
    assert hot is not None
    s = stats["runtime"]
    assert s.recompiles == 2 and s.steps == STEPS
    assert stats["p50_ms"] > 0 and stats["p99_ms"] >= stats["p50_ms"]
    assert stats["straggler_events"] == s.straggler_events


def test_no_morpheus_recompiles_nothing():
    stats, rt = T.run_serve(steps=8, recompile_every=4, morpheus=False,
                            quiet=True, device="cpu")
    try:
        assert stats["runtime"].recompiles == 0
        assert stats["runtime"].steps == 8
        assert rt.plan.label == "generic" and rt.hot_experts() is None
    finally:
        rt.close()


def test_controller_serve_accounts_for_every_step():
    stats, ctl, rts = T.run_controller_serve(
        planes=2, steps=12, recompile_every=6, quiet=True, device="cpu",
        fuse=2, inflight=2)
    try:
        assert stats["steps"] == 12 and stats["planes"] == 2
        cs = stats["controller"]
        assert set(cs.planes) == {"plane-0", "plane-1"}
        for rt in rts:
            assert rt.stats.steps == 12
            assert rt.stats.recompiles >= 1
        assert cs.scheduler["completed"] >= 2
    finally:
        for rt in rts:
            rt.close()
        ctl.close()


def test_frontend_serve_accounts_for_every_request():
    stats, ctl, rts, fes = T.run_frontend_serve(
        planes=2, requests=120, rate=4000.0, quiet=True, device="cpu",
        recompile_every_s=0.05)
    try:
        s = [rt.stats for rt in rts]
        assert sum(x.requests_submitted for x in s) == 120
        assert sum(x.requests_completed + x.requests_rejected
                   + x.requests_shed + x.requests_failed
                   for x in s) == 120
        assert stats["completed"] == sum(x.requests_completed for x in s)
        assert stats["completed"] > 0
        assert set(stats["per_plane"]) == {"plane-0", "plane-1"}
    finally:
        for rt in rts:
            rt.close()
        ctl.close()


def test_main_runs_on_the_host(capsys):
    assert T.main(["--steps", "8", "--recompile-every", "4",
                   "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] recompile@4" in out and "straggler_events=" in out
    assert T.main(["--steps", "4", "--planes", "2", "--recompile-every",
                   "2", "--device", "cpu"]) == 0
    assert T.main(["--fuse", "0", "--device", "cpu"]) == 2
    assert T.main(["--frontend", "--no-morpheus", "--device", "cpu"]) == 2


def test_mesh_and_xla_cache_dir_rules(monkeypatch):
    from repro_torch.distributed.meshctx import Mesh
    assert T._resolve_mesh("none", "cpu") is None
    assert T._resolve_mesh("auto", "cpu") is None
    mesh = Mesh(["cpu"] * 2, ("data",))
    assert T._resolve_mesh(mesh, "cpu") is mesh
    with pytest.raises(TypeError, match="Mesh"):
        T._resolve_mesh(object(), "cpu")
    # more than one card visible: auto spans them all on "data"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    auto = T._resolve_mesh("auto", "cuda")
    assert auto.size == 2 and tuple(auto.shape) == ("data",)
    assert auto.device_list == (torch.device("cuda", 0),
                                torch.device("cuda", 1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert T._resolve_mesh("auto", "cuda") is None
    monkeypatch.undo()
    with pytest.raises(ValueError, match="xla_cache_dir"):
        T.main(["--steps", "4", "--xla-cache-dir", "/nonexistent",
                "--device", "cpu"])
