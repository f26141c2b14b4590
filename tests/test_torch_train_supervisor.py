"""The port's training supervisor, the twins of
``tests/test_train_supervisor.py`` (plan signatures, the heavy-hitter
decision function, profile checkpoint-coupling, the cache-key anatomy
that lets ``ExecutableCache.quarantine`` purge train executables), then
the port's own fault boundary: a fault in the forward or the backward
deopts and retries the same batch, one after the optimizer's first
in-place write raises ``LostStepError``, and the device-loss arc on one
device, the reference's own case (the survivors are the same device).
The end-to-end arcs live in ``tests/test_torch_train_chaos.py``, the
arc on a mesh in ``tests/test_torch_sharded_train.py``."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core.execcache import ExecutableCache
from repro_torch.distributed.fault import FailureInjector, LostStepError, \
    SimulatedDeviceLoss
from repro_torch.training import (SupervisorConfig, TrainPlan, TrainProfile,
                                  TrainSupervisor, plan_hot_experts)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-scale ops gain nothing from torch's intra-op threads, and the
    suite's parallel workers oversubscribe the cores with them (the chaos
    cells take 17 s with one thread, several times that with the default
    beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- TrainPlan ----------------------------------------------------------

def test_plan_signature_is_version_free():
    a = TrainPlan((0, 2), version=1)
    b = TrainPlan((0, 2), version=9)
    assert a.signature == b.signature == ("train", "hot", (0, 2))
    assert TrainPlan(None).signature == ("train", "generic")
    assert not TrainPlan(None).specialized and TrainPlan((1,)).specialized


def test_plan_labels():
    assert TrainPlan(None).label == "generic"
    assert TrainPlan((2, 0)).label == "specialized(hot=2,0)"


# ---- the decision function ----------------------------------------------

def test_plan_hot_experts_coverage_prefix():
    counts = np.array([100, 50, 10, 5])
    assert plan_hot_experts(counts, 0.60) == (0,)
    assert plan_hot_experts(counts, 0.90) == (0, 1)
    assert plan_hot_experts(counts, 0.95) == (0, 1, 2)
    assert plan_hot_experts(counts, 1.0) is None
    assert plan_hot_experts(np.zeros(4), 0.9) is None


def test_plan_hot_experts_deterministic_on_ties():
    counts = np.array([10, 10, 10, 1])
    a = plan_hot_experts(counts, 0.6)
    for _ in range(10):
        assert plan_hot_experts(counts.copy(), 0.6) == a


def test_plan_hot_experts_sorted_canonical():
    counts = np.array([1, 100, 2, 50])
    assert plan_hot_experts(counts, 0.9) == (1, 3)


# ---- TrainProfile checkpoint coupling -----------------------------------

def test_profile_meta_roundtrip_exact_through_json():
    p = TrainProfile(4)
    p.observe(np.array([7, 1, 3, 9]), loss=2.5)
    p.observe(np.array([2, 2, 2, 2]), loss=2.25)
    meta = json.loads(json.dumps(p.to_meta()))
    q = TrainProfile(4)
    q.from_meta(meta)
    np.testing.assert_array_equal(q.counts_acc, p.counts_acc)
    assert q.steps_acc == p.steps_acc
    assert q.mixture_ema == p.mixture_ema
    assert q.loss_ema == p.loss_ema
    assert q.decide(0.7) == p.decide(0.7)


def test_profile_decide_resets_accumulator():
    p = TrainProfile(3)
    p.observe(np.array([9, 1, 0]))
    assert p.decide(0.8) == (0,)
    assert p.counts_acc.sum() == 0 and p.steps_acc == 0
    assert p.decide(0.8) is None


# ---- cache-key anatomy --------------------------------------------------

def test_quarantine_purges_train_executables_by_signature():
    """Train keys are (ns, (signature, ()), bkey) — the serving runtime's
    anatomy, so the shared cache's signature quarantine purges them."""
    cache = ExecutableCache(8)
    sig_a = TrainPlan((0, 1)).signature
    sig_b = TrainPlan(None).signature
    ka = ExecutableCache.make_key("train/t@0", (sig_a, ()), "bk")
    kb = ExecutableCache.make_key("train/t@0", (sig_b, ()), "bk")
    cache.put(ka, "exe-a")
    cache.put(kb, "exe-b")
    cache.quarantine(sig_a)
    assert cache.is_quarantined(sig_a)
    assert cache.peek(ka) is None and cache.peek(kb) == "exe-b"


def test_namespace_rotation_drops_old_topology():
    cache = ExecutableCache(8)
    sig = TrainPlan(None).signature
    k0 = ExecutableCache.make_key("train/t@0", (sig, ()), "bk")
    k1 = ExecutableCache.make_key("train/t@1", (sig, ()), "bk")
    cache.put(k0, "epoch0")
    cache.put(k1, "epoch1")
    assert cache.purge_namespace("train/t@0") == 1
    assert cache.peek(k0) is None and cache.peek(k1) == "epoch1"


# ---- the port's fault boundary ------------------------------------------

def _plane(injector=None):
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.train import build_state
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig
    cfg = get_config("starcoder2-3b").smoke()
    model = Model(cfg)
    state = build_state(model, 0, "cpu")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq=16,
                                    global_batch=2), device="cpu")
    sup = TrainSupervisor(model, AdamWConfig(lr=1e-3), state,
                          pipe.peek_batch(), cfg=SupervisorConfig(),
                          injector=injector, log_fn=lambda m: None)
    return model, sup, state, pipe


def test_the_cache_key_holds_the_state_and_batch_shapes():
    _, sup, state, pipe = _plane()
    (key,) = list(sup.cache._entries)
    assert key[0] == "train/train@0"
    assert key[1] == (TrainPlan(None).signature, ())
    assert ("tokens", (2, 16), "torch.int32") in key[2][1]
    assert sup.stats()["sync_compiles"] == 1
    sup.close()


def test_a_fault_in_the_backward_retries_the_same_batch(monkeypatch):
    model, sup, state, pipe = _plane()
    real = model.loss
    fired = []

    def faulty(*a, **kw):
        loss, m = real(*a, **kw)
        if not fired:
            fired.append(1)

            def boom(g):
                raise RuntimeError("backward fault")
            loss.register_hook(boom)
        return loss, m
    monkeypatch.setattr(model, "loss", faulty)
    before = [p.detach().clone() for p in state["params"].parameters()]
    batch = pipe.next_batch()
    state, m = sup.step(state, batch)
    s = sup.stats()
    assert fired and s["step_faults"] == 1 and s["retried_steps"] == 1
    assert int(state["opt"]["step"]) == 1
    # the retry updated from the untouched state: one update, not two
    monkeypatch.setattr(model, "loss", real)
    _, sup2, state2, _ = _plane()
    state2, m2 = sup2.step(state2, batch)
    assert float(m["loss"]) == float(m2["loss"])
    for a, b in zip(state["params"].parameters(),
                    state2["params"].parameters()):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in
               zip(before, state["params"].parameters()))
    sup.close()
    sup2.close()


def test_a_fault_after_the_optimizers_first_write_loses_the_step(
        monkeypatch):
    from repro_torch.models.params import flat_tree
    from repro_torch.optim import adamw as adamw_mod
    _, sup, state, pipe = _plane()
    calls = []
    real_chunks = adamw_mod._chunks
    # global_norm chunks each gradient once, then the update chunks four
    # operands a leaf: fail as the update reaches its second leaf
    fail_at = len(flat_tree(state["params"])) + 4

    def chunks(t):
        if len(calls) == fail_at:
            raise RuntimeError("device fault mid-update")
        calls.append(1)
        return real_chunks(t)
    monkeypatch.setattr(adamw_mod, "_chunks", chunks)
    with pytest.raises(LostStepError, match="first in-place write"):
        sup.step(state, pipe.next_batch())
    assert sup.stats()["step_faults"] == 0
    sup.close()


def test_device_loss_raises_not_implemented():
    """The one-device arc, the reference's own case (the name predates
    it): the survivors are the same device.  A specialized MoE plane
    snapshots, reshards onto the survivors verified bit for bit under a
    new cache namespace, rebuilds its generic step (the one extra
    training-thread build), runs degraded on it, and the health probe
    and the next decision bring it back healthy and specialized; the
    grow-back has nothing to add."""
    from repro_torch.data import TokenPipeline
    from repro_torch.testing.chaos import _train_cell
    dcfg, make_sup = _train_cell(0, 32, "cpu")
    inj = FailureInjector()
    sup, state = make_sup(injector=inj)
    pipe = TokenPipeline(dcfg, "cpu")
    for i in range(32):
        if i == 14:
            assert sup.active_plan.specialized
            inj.arm_next(SimulatedDeviceLoss("lost"))
        state, m = sup.step(state, pipe.next_batch())
        if i == 14:
            s = sup.stats()
            assert (s["device_losses"], s["reshard_verified"],
                    s["mesh_epoch"], s["sync_compiles"],
                    s["n_devices"]) == (1, 1, 1, 2, 1)
            assert s["health"] == "degraded" and s["active"] == "generic"
            assert all(k[0] == "train/train@1" for k in sup.cache._entries)
            assert sup.spec_meta()["mesh_epoch"] == 1
            assert sup.recover_devices(state) is state
    s = sup.stats()
    assert s["grow_backs"] == 0 and s["sync_compiles"] == 2
    assert s["health"] == "healthy" and s["active"].startswith("specialized")
    assert int(state["opt"]["step"]) == 32 and np.isfinite(float(m["loss"]))
    sup.close()
