"""The port's checkpoint layer (``repro_torch.checkpoint``), the twins of
``tests/test_ckpt.py``: the atomic two-rename swap, stale-writer GC,
retention, async error propagation, the bf16 / fp8 integer-view
round-trip, and the exact lr schedule and data-stream position on
resume.  The reference's elastic reshard test has no twin: restoring
onto a resized mesh waits for ROADMAP Queue 1 item 12.  Then the
on-disk layout both ways: the port restores, bit for bit, a training
state that the reference's ``save`` wrote, and the reference restores
the port's."""
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointHandle, latest_step, restore,
                                    save, save_async)


def _tree(step=7):
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": torch.ones(4, dtype=torch.bfloat16) * 1.5,
            "step": torch.tensor(step, dtype=torch.int32)}


def _empty():
    """A tree of the same structure whose values no checkpoint holds."""
    return {"w": torch.full((3, 4), -1.0),
            "b": torch.full((4,), -1.0, dtype=torch.bfloat16),
            "step": torch.tensor(-1, dtype=torch.int32)}


# ---- bf16 / fp8 integer-view round-trip ---------------------------------

def test_bf16_roundtrip_bitwise(tmp_path):
    """npz cannot store bf16 or fp8; the integer-view detour must
    round-trip every bit pattern, NaN payloads and denormals included."""
    patterns = np.arange(0, 2**16, 7, dtype=np.uint16)
    f8 = np.arange(0, 256, 3, dtype=np.uint8)
    tree = {"x": torch.from_numpy(patterns.view(np.int16)).view(
                torch.bfloat16),
            "f8": torch.from_numpy(f8).view(torch.float8_e4m3fn)}
    save(tmp_path, 1, tree)
    out = {"x": torch.zeros(len(patterns), dtype=torch.bfloat16),
           "f8": torch.zeros(len(f8), dtype=torch.float8_e4m3fn)}
    out, _ = restore(tmp_path, 1, out)
    assert out["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["x"].view(torch.int16).numpy().view(np.uint16), patterns)
    np.testing.assert_array_equal(out["f8"].view(torch.uint8).numpy(), f8)


def test_meta_and_values_roundtrip(tmp_path):
    tree = _tree()
    save(tmp_path, 3, tree, meta={"lr": 0.125, "arch": "t"})
    out, meta = restore(tmp_path, None, _empty())
    assert meta["step"] == 3 and meta["lr"] == 0.125
    for k in tree:
        assert out[k].dtype == tree[k].dtype
        assert torch.equal(out[k], tree[k])


def test_restore_writes_in_place_and_checks_shapes(tmp_path):
    save(tmp_path, 1, _tree())
    target = _empty()
    w = target["w"]
    out, _ = restore(tmp_path, 1, target)
    assert out is target and out["w"] is w and float(w[2, 3]) == 11.0
    bad = {**_empty(), "w": torch.zeros(4, 3)}
    with pytest.raises(ValueError, match="w"):
        restore(tmp_path, 1, bad)
    with pytest.raises(KeyError):
        restore(tmp_path, 1, {**_empty(), "extra": torch.zeros(1)})


# ---- the save crash window ----------------------------------------------

def test_overwrite_never_destroys_only_copy(tmp_path, monkeypatch):
    """Fail the tmp->final rename of an overwrite: a complete copy of the
    step must survive, and GC must leave no litter."""
    save(tmp_path, 5, _tree())
    real_rename = os.rename

    def exploding_rename(src, dst):
        if Path(src).name.startswith(".tmp_"):
            raise OSError("simulated crash mid-swap")
        return real_rename(src, dst)

    monkeypatch.setattr(os, "rename", exploding_rename)
    with pytest.raises(OSError, match="mid-swap"):
        save(tmp_path, 5, _tree(step=0))
    monkeypatch.undo()

    assert latest_step(tmp_path) == 5
    out, _ = restore(tmp_path, 5, _empty())
    assert int(out["step"]) in (0, 7)       # a complete copy, not a mix
    assert not list(Path(tmp_path).glob(".tmp_*"))
    assert not list(Path(tmp_path).glob(".old_*"))


def test_gc_promotes_complete_orphan(tmp_path):
    save(tmp_path, 2, _tree())
    os.rename(tmp_path / "step_2", tmp_path / ".tmp_9")
    assert latest_step(tmp_path) == 9
    out, meta = restore(tmp_path, 9, _empty())
    assert meta["step"] == 2          # manifest content survived intact
    assert int(out["step"]) == 7


def test_gc_deletes_incomplete_orphan(tmp_path):
    save(tmp_path, 1, _tree())
    half = tmp_path / ".tmp_4"
    half.mkdir()
    (half / "arrays.npz").write_bytes(b"truncated")
    assert latest_step(tmp_path) == 1
    assert not half.exists()


def test_gc_prefers_tmp_over_old(tmp_path):
    save(tmp_path, 6, _tree())
    os.rename(tmp_path / "step_6", tmp_path / ".old_6")
    save(tmp_path, 6, _tree(step=99))
    os.rename(tmp_path / "step_6", tmp_path / ".tmp_6")
    assert latest_step(tmp_path) == 6
    out, _ = restore(tmp_path, 6, _empty())
    assert int(out["step"]) == 99
    assert not (tmp_path / ".old_6").exists()


# ---- retention ----------------------------------------------------------

def test_keep_last_retention(tmp_path):
    tree = _tree()
    for s in (1, 2, 3, 4):
        save(tmp_path, s, tree, keep_last=2)
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]
    for s in (5, 6):
        save(tmp_path, s, tree)
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [3, 4, 5, 6]


# ---- async handle -------------------------------------------------------

def test_save_async_returns_handle(tmp_path):
    tree = _tree()
    h = save_async(tmp_path, 11, tree, meta={"k": 1}, keep_last=3)
    tree["w"].zero_()                 # the snapshot was taken at the call
    assert isinstance(h, CheckpointHandle)
    path = h.join(timeout=60)
    assert path is not None and path.endswith("step_11")
    assert h.done() and h.path() == path
    assert latest_step(tmp_path) == 11
    out, _ = restore(tmp_path, 11, _empty())
    assert float(out["w"][2, 3]) == 11.0


def test_save_async_error_reraised_on_join(tmp_path):
    target = tmp_path / "ckpt"
    target.write_text("not a directory")
    h = save_async(str(target), 1, _tree())
    with pytest.raises(OSError):
        h.join(timeout=60)
    assert h.done() and h.path() is None


# ---- resume position: lr schedule + data stream -------------------------

def test_resume_restores_lr_step_and_pipeline_position(tmp_path):
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state

    cfg = AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=10)
    grads = {"w": torch.full((4, 4), 0.25)}

    def fresh():
        params = {"w": torch.ones(4, 4)}
        return params, init_opt_state(params)

    p, opt = fresh()
    for _ in range(6):
        p, opt, metrics = adamw_update(cfg, grads, opt, params=p)
    lr_ref, w_ref = float(metrics["lr"]), p["w"].clone()

    p, opt = fresh()
    for _ in range(5):
        p, opt, _ = adamw_update(cfg, grads, opt, params=p)
    save(tmp_path, 5, {"params": p, "opt": opt})
    p2, opt2 = fresh()
    restored, _ = restore(tmp_path, 5, {"params": p2, "opt": opt2})
    assert int(restored["opt"]["step"]) == 5
    p3, _, metrics2 = adamw_update(cfg, grads, restored["opt"],
                                   params=restored["params"])
    assert float(metrics2["lr"]) == lr_ref
    assert torch.equal(p3["w"], w_ref)

    dcfg = DataConfig(vocab=64, seq=8, global_batch=2, seed=3)
    ref_pipe = TokenPipeline(dcfg, device="cpu")
    for _ in range(5):
        ref_pipe.next_batch()
    sixth = ref_pipe.next_batch()
    pipe = TokenPipeline(dcfg, device="cpu")
    for _ in range(5):
        pipe.next_batch()
    sd = pipe.state_dict()
    resumed = TokenPipeline(dcfg, device="cpu")
    resumed.load_state_dict(sd)
    got = resumed.next_batch()
    for k in sixth:
        assert torch.equal(sixth[k], got[k])
    resumed.load_state_dict(sd)
    assert torch.equal(resumed.peek_batch()["tokens"], sixth["tokens"])
    assert resumed.state_dict() == sd


# ---- the on-disk layout, across the two packages ------------------------

def _states(arch="starcoder2-3b"):
    """The reference's training state (bf16 params, f32 master / m / v,
    int32 step) and the port's of the same config."""
    from repro.configs import get_config as j_get_config
    from repro.launch.train import build_state as j_build_state
    from repro.models import Model as JModel
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_state
    from repro_torch.models.model import Model
    jstate, _ = j_build_state(JModel(j_get_config(arch).smoke()),
                              jax.random.PRNGKey(0))
    # moments and step that are not zeros, so every leaf is checked
    jstate["opt"]["m"] = jax.tree.map(lambda x: x + 0.5, jstate["opt"]["m"])
    jstate["opt"]["step"] = jnp.asarray(13, jnp.int32)
    return jstate, build_state(Model(get_config(arch).smoke()), 1, "cpu")


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_port_restores_a_checkpoint_the_reference_wrote(tmp_path):
    from repro.checkpoint import save as j_save
    from repro_torch.models.params import flat_tree
    jstate, state = _states()
    j_save(tmp_path, 4, jstate, meta={"data": {"step": 4, "seed": 0}})
    state, meta = restore(tmp_path, None, state)
    assert meta["step"] == 4 and meta["data"] == {"step": 4, "seed": 0}
    got = flat_tree(state)
    ref = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
           for path, leaf in jax.tree_util.tree_flatten_with_path(
               jstate)[0]}
    assert set(got) == set(ref)
    for k, leaf in got.items():
        assert str(leaf.dtype).removeprefix("torch.") == str(ref[k].dtype), k
        np.testing.assert_array_equal(_bits(leaf), _bits(ref[k]), err_msg=k)


def test_reference_restores_a_checkpoint_the_port_wrote(tmp_path):
    from repro.checkpoint import restore as j_restore
    from repro_torch.models.params import flat_tree
    jstate, state = _states()
    save(tmp_path, 2, state, meta={"arch": "x"})
    out, meta = j_restore(tmp_path, None, jstate)
    assert meta["step"] == 2 and meta["arch"] == "x"
    got = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
           for path, leaf in jax.tree_util.tree_flatten_with_path(out)[0]}
    for k, leaf in flat_tree(state).items():
        np.testing.assert_array_equal(_bits(got[k]), _bits(leaf), err_msg=k)
