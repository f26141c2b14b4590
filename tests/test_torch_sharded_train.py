"""Training on a device mesh: the ZeRO-sliced train step, checkpoints
restored onto a resized mesh and the supervisor's device-loss arc, on a
CPU debug mesh (one ``cpu`` device at every coordinate), held to the
reference's single device in-process and to the port's own single-device
step:

- the param tree's logical axes equal the reference's on every arch;
- the twin of ``test_sharding_elastic.py::test_sharded_train_step_runs_on_debug_mesh``:
  phi3.5-MoE smoke on a ``(data 2, model 2)`` mesh with fsdp rules takes
  a step whose cross entropy matches the reference's single-device loss
  within ``LOSS_RTOL``, its expert state split over the model axis;
  every MoE case runs at capacity factor 2, where nothing drops, and
  asserts so;
- the mesh step against the port's single-device step (phi3.5-MoE,
  llama3-8b over two steps, the second in two microbatches, and jamba's
  first two layers): the loss within ``LOSS_RTOL``, every ``master``
  leaf within ``MASTER_RTOL`` of its largest entry, nothing dropped, and
  call == call bit for bit;
- the twins of ``test_sharding_elastic.py::test_elastic_resize_restore``
  and ``test_ckpt.py::test_elastic_reshard_shrink_and_grow``, and a
  sharded checkpoint of the port restored by the reference;
- the supervisor on a 4-entry mesh: a device lost at step 3 and grown
  back at step 6 ends on the uninterrupted run's leaves.

The expert-parallel MoE averages the load-balance loss over its token
shards, as the reference's ``moe_ffn_sharded`` does, which is another
number than the one-device loss over every token.  So the reference twin
holds the cross entropy (the loss less ``router_aux_weight`` times the
``aux_loss`` metric), and the leaf-by-leaf cases set the aux weight to 0
on both sides."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as j_restore
from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro.models import unzip
from repro_torch.checkpoint import restore, save
from repro_torch.configs import get_config
from repro_torch.distributed.compat import Replicated, Sharded
from repro_torch.distributed.fault import FailureInjector, \
    SimulatedDeviceLoss, elastic_reshard
from repro_torch.distributed.meshctx import Mesh, MeshPolicy
from repro_torch.distributed.sharding import NamedSharding, \
    gather_to_host, make_rules, named_shardings, param_pspecs, \
    place_train_state, shardings_for, train_state_shardings
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import build_state, cut_layers
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.models.params import flat_tree, trainable, unflat_tree
from repro_torch.optim import AdamWConfig, init_opt_state

LOSS_RTOL = 1e-5       # test_torch_train.py's loss tolerance
MASTER_RTOL = 1e-6     # a state leaf, of its largest entry
RULES = make_rules(False, fsdp=True)
PHI, LLAMA, JAMBA = ("phi3.5-moe-42b-a6.6b", "llama3-8b", "jamba-v0.1-52b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, aux=True):
    """The smoke config; a MoE one at capacity factor 2, where the
    expert-parallel body drops nothing on these batches (it drops past
    its capacity, the single device never), and without ``aux`` its
    load-balance weight 0."""
    cfg = get_config(arch).smoke()
    if arch == JAMBA:
        cfg = cut_layers(cfg, 2)       # Mamba + dense FFN, Mamba + MoE FFN
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=2.0,
            router_aux_weight=cfg.moe.router_aux_weight if aux else 0.0))
    return cfg


def _f32_state(model):
    params = trainable(model.init(0, "cpu").float())
    return {"params": params, "opt": init_opt_state(params)}


def _batch(cfg, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _mesh_state(model, mesh):
    state = _f32_state(model)
    sh = train_state_shardings(state["params"], mesh, RULES)
    return place_train_state(state, sh), sh


def _mesh_step(model, mesh, sh, microbatches=1):
    return make_train_step(model, AdamWConfig(), microbatches,
                           grad_shardings=sh["opt"]["master"],
                           policy=MeshPolicy(mesh=mesh))


def _assert_masters_close(got, ref, every_leaf=False):
    for k, a in ref.items():
        if not every_leaf and "/master/" not in f"/{k}":
            continue
        a, b = a.double(), got[k].double()
        err, scale = float((a - b).abs().max()), float(a.abs().max())
        assert err <= MASTER_RTOL * max(scale, 1e-30), (k, err, scale)


def test_param_axes_equal_the_reference_on_every_arch():
    for arch in ARCH_IDS:
        jp = JModel(j_get_config(arch).smoke()).init(
            jax.random.PRNGKey(0), abstract=True)
        _, j_axes = unzip(jp)
        want = {}

        def walk(t, prefix=""):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{prefix}{k}/")
            else:
                want[prefix[:-1]] = tuple(t)
        walk(j_axes)
        params = Model(get_config(arch).smoke()).init(0, "meta")
        pspecs = param_pspecs(params)
        got = {}
        for k in flat_tree(params):
            node = pspecs
            for part in k.split("/"):
                node = node[part]
            got[k] = node.axes
        assert got == want, arch


def test_sharded_train_step_runs_on_debug_mesh():
    cfg = _cfg(PHI)
    jm = JModel(j_get_config(PHI).smoke())
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      unzip(jm.init(jax.random.PRNGKey(0)))[0])
    nb = _batch(cfg)
    jl, jmet = jax.jit(lambda p, b: jm.loss(p, b))(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    j_ce = float(jl) - cfg.moe.router_aux_weight * float(jmet["aux_loss"])

    model = Model(cfg)
    mesh = make_debug_mesh(2, 2, device="cpu")
    params = trainable(params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu"))
    state = {"params": params, "opt": init_opt_state(params)}
    sh = train_state_shardings(params, mesh, RULES)
    state = place_train_state(state, sh)
    state, m = _mesh_step(model, mesh, sh)(state, _torch(nb))
    ce = float(m["loss"]) - cfg.moe.router_aux_weight * float(m["aux_loss"])
    assert np.isfinite(float(m["loss"]))
    assert abs(ce - j_ce) <= LOSS_RTOL * abs(j_ce), (ce, j_ce)
    assert float(m["dropped"]) == 0.0
    # the expert weights' optimizer state is split over the model axis
    for part in ("master", "m", "v"):
        w1 = state["opt"][part]["blocks"]["pos0"]["ffn"]["w1"]
        assert isinstance(w1, Sharded) and len(w1.shards) == 4
        assert sh["opt"][part]["blocks"]["pos0"]["ffn"]["w1"].spec[1] \
            == "model"
    assert int(state["opt"]["step"]) == 1


@pytest.mark.parametrize("arch", [PHI, LLAMA, JAMBA],
                         ids=["phi3.5-moe", "llama3-dense", "jamba-2layer"])
def test_mesh_step_matches_the_single_device_step(arch):
    cfg = _cfg(arch, aux=False)
    model = Model(cfg)
    mesh = make_debug_mesh(2, 2, device="cpu")
    batches = [_torch(_batch(cfg, seed=i)) for i in range(2)]
    # llama's second step accumulates two microbatches (the f32
    # accumulator holds the gradient's blocks)
    mbs = (1, 2) if arch == LLAMA else (1,)
    one = _f32_state(model)
    runs = []
    for _ in range(2):                   # call == call on the mesh
        state, sh = _mesh_state(model, mesh)
        losses = []
        for k, b in zip(mbs, batches):
            state, m = _mesh_step(model, mesh, sh, k)(state, b)
            losses.append(float(m["loss"]))
            assert float(m.get("dropped", 0.0)) == 0.0
        runs.append((losses, gather_to_host(state)))
    ref_losses = []
    for k, b in zip(mbs, batches):
        one, m = make_train_step(model, AdamWConfig(), k)(one, b)
        ref_losses.append(float(m["loss"]))
    (losses, got), (losses2, got2) = runs
    assert losses == losses2
    assert all(torch.equal(got[k], got2[k]) for k in got)
    for a, b in zip(losses, ref_losses):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (a, b)
    ref = gather_to_host(one)
    assert set(ref) == set(got)
    _assert_masters_close(got, ref)
    if arch == LLAMA:
        # a dense model's layers run as on one device and the blocked
        # update is elementwise: every leaf comes out the same bits
        assert all(torch.equal(got[k], ref[k]) for k in ref)


def _placed(tree, mesh):
    """A params tree laid out by its specs on ``mesh`` (nested dicts)."""
    sh = flat_tree(named_shardings(
        shardings_for(param_pspecs(tree), mesh, RULES), mesh))
    return unflat_tree({k: sh[k].place(v)
                        for k, v in flat_tree(tree).items()}), sh


def test_elastic_resize_restore(tmp_path):
    """Checkpoint on a (2, 2) mesh, restore onto (4, 2): every leaf
    equal, and a leaf the rules split twice lies over 8 coordinates."""
    params = Model(get_config(LLAMA).smoke()).init(0, "cpu")
    placed, _ = _placed(params, make_debug_mesh(2, 2, device="cpu"))
    save(str(tmp_path), 1, placed)
    mesh2 = make_debug_mesh(4, 2, device="cpu")
    sh2 = named_shardings(shardings_for(param_pspecs(params), mesh2,
                                        RULES), mesh2)
    example = unflat_tree({k: v.detach().clone()
                           for k, v in flat_tree(params).items()})
    out, meta = restore(str(tmp_path), None, example, shardings=sh2)
    assert meta["step"] == 1
    want = flat_tree(params)
    got = flat_tree(out)
    for k, v in want.items():
        assert torch.equal(torch.as_tensor(
            gather_to_host({"x": got[k]})["x"]), v), k
    wq = got["blocks/pos0/attn/wq"]
    assert isinstance(wq, Sharded) and len(wq.shards) == 8
    assert flat_tree(sh2)["blocks/pos0/attn/wq"].holds(wq)


def test_elastic_reshard_shrink_and_grow(tmp_path):
    """A checkpoint taken on a 4-entry mesh restores bitwise onto 2
    entries (device loss) and onto 8 (grow-back), laid out over them."""
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": (torch.arange(8, dtype=torch.float32) / 3).to(
                torch.bfloat16)}

    def shardings(n):
        mesh = Mesh(["cpu"] * n, ("data",))
        return {k: NamedSharding(mesh, ("data",)) for k in tree}
    sh4 = shardings(4)
    save(str(tmp_path), 1, {k: sh4[k].place(v) for k, v in tree.items()})
    for n in (2, 8):
        out, meta = elastic_reshard(str(tmp_path), dict(tree), shardings(n))
        assert meta["step"] == 1
        for k, v in tree.items():
            assert isinstance(out[k], Sharded) and len(out[k].shards) == n
            assert out[k].dtype == v.dtype
            assert torch.equal(out[k].gather("cpu"), v), (k, n)


def test_a_sharded_checkpoint_restores_in_the_reference(tmp_path):
    model = Model(_cfg(LLAMA))
    state, _ = _mesh_state(model, make_debug_mesh(2, 2, device="cpu"))
    assert isinstance(state["opt"]["master"]["embed"]["table"], Sharded)
    save(str(tmp_path), 3, state)
    jm = JModel(j_get_config(LLAMA).smoke())
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      unzip(jm.init(jax.random.PRNGKey(1)))[0])
    example = {"params": jp, "opt": {"master": jp, "m": jp, "v": jp,
                                     "step": jnp.zeros((), jnp.int32)}}
    out, meta = j_restore(str(tmp_path), None, example)
    assert meta["step"] == 3
    want = gather_to_host(state)
    got = {}

    def walk(t, prefix=""):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}/")
        else:
            got[prefix[:-1]] = np.asarray(t)
    walk(out)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


def test_a_spec_that_does_not_divide_by_three_replicates():
    """On a mesh of 3 the resolver falls back to replication where a
    dimension does not divide, and the placement takes it."""
    model = Model(_cfg(LLAMA))
    state = build_state(model, 0, "cpu")
    sh = train_state_shardings(state["params"],
                               Mesh(["cpu"] * 3, ("data",)), RULES)
    specs = {k: s.spec for k, s in flat_tree(sh["opt"]["master"]).items()}
    assert specs["embed/table"] == ()          # vocab 256, d_model 64
    state = place_train_state(state, sh)
    table = state["opt"]["master"]["embed"]["table"]
    # replicated over the mesh's one distinct device: one tensor there
    assert not isinstance(table, Sharded)
    assert flat_tree(sh["opt"]["master"])["embed/table"].holds(table)
    assert isinstance(NamedSharding(Mesh(["cpu"] * 3, ("data",)), ()).place(
        table), Replicated)
    host = gather_to_host(state)
    assert torch.equal(host["opt/master/embed/table"],
                       state["params"]["embed"]["table"].detach().float())


def _supervised(arch, lose):
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.training import SupervisorConfig, TrainSupervisor
    cfg = _cfg(arch)
    model = Model(cfg)
    state = build_state(model, 0, "cpu")
    params = state["params"]
    inj = FailureInjector()
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq=16,
                                    global_batch=12), device="cpu")
    sup = TrainSupervisor(
        model, AdamWConfig(lr=1e-3), state, pipe.peek_batch(),
        cfg=SupervisorConfig(respecialize_every=0), devices=["cpu"] * 4,
        sharding_fn=lambda devs: train_state_shardings(
            params, Mesh(devs, ("data",)), RULES),
        injector=inj, log_fn=lambda m: None)
    state = sup.place(state)
    n_devices = []
    for i in range(10):
        if lose and i == 3:
            inj.arm_next(SimulatedDeviceLoss("lost"))
        if lose and i == 6:
            state = sup.recover_devices(state)
        state, _ = sup.step(state, pipe.next_batch())
        n_devices.append(sup.stats()["n_devices"])
    s = sup.stats()
    sup.close()
    return state, s, n_devices


def test_supervisor_shrinks_and_grows_back_on_a_mesh():
    ref, _, _ = _supervised("starcoder2-3b", lose=False)
    state, s, n_devices = _supervised("starcoder2-3b", lose=True)
    assert (s["device_losses"], s["grow_backs"], s["reshard_verified"],
            s["mesh_epoch"]) == (1, 1, 2, 2)
    assert n_devices == [4, 4, 4, 3, 3, 3, 4, 4, 4, 4]
    assert int(state["opt"]["step"]) == 10
    master = state["opt"]["master"]["blocks"]["pos0"]["attn"]["wq"]
    assert isinstance(master, Sharded) and len(master.shards) == 4
    _assert_masters_close(gather_to_host(state), gather_to_host(ref),
                          every_leaf=True)


def test_sharded_blocks_split_gather_and_slice_in_shard_order():
    from repro_torch.distributed.compat import split_grid
    x = torch.arange(2 * 4 * 6, dtype=torch.float32).reshape(2, 4, 6)
    mesh = make_debug_mesh(2, 2, device="cpu")
    s = NamedSharding(mesh, (None, "model", "data"))
    assert (s.split_dims, s.grid, s.axes) == ((1, 2), (2, 2),
                                              ("model", "data"))
    blk = s.place(x)
    assert blk.shape == x.shape and blk.grid == (2, 2)
    # block i is shard i of Mesh.shard_coords(("model", "data"))
    for i, (t, sl) in enumerate(zip(blk.shards, blk.block_slices())):
        mi, di = mesh.shard_coords(("model", "data"))[i][::-1]
        assert torch.equal(t, x[:, 2 * mi:2 * mi + 2, 3 * di:3 * di + 3])
        assert torch.equal(t, x[sl]) and t.is_contiguous()
    assert torch.equal(blk.gather("cpu"), x)
    assert np.array_equal(np.asarray(blk), x.numpy())
    assert torch.equal(blk.select(1).gather("cpu"), x[1])
    assert s.holds(blk) and not NamedSharding(mesh, ("data",)).holds(blk)
    cut = s.cut(x)                       # views where the block lies
    assert cut.shards[0].data_ptr() == x.data_ptr()
    with pytest.raises(ValueError, match="does not divide"):
        split_grid(x, (2,), (4,), ["cpu"] * 4)


def test_a_fault_past_the_first_block_write_loses_the_step(monkeypatch):
    from repro_torch.distributed.fault import LostStepError
    from repro_torch.optim import adamw as adamw_mod
    model = Model(_cfg(LLAMA))
    state, sh = _mesh_state(model, make_debug_mesh(2, 2, device="cpu"))
    cut = flat_tree(sh["opt"]["master"])
    grads = {k: cut[k].cut(torch.ones_like(p))    # as the step cuts them
             for k, p in flat_tree(state["params"]).items()}
    n_norm = sum(len(getattr(v, "shards", (v,))) for v in
                 flat_tree(state["opt"]["master"]).values())
    calls, real = [], adamw_mod._chunks

    def chunks(t):
        # the norm chunks each block once, then the update chunks four
        # operands a block: fail as the update reaches its second block
        if len(calls) == n_norm + 4:
            raise RuntimeError("device fault mid-update")
        calls.append(1)
        return real(t)
    monkeypatch.setattr(adamw_mod, "_chunks", chunks)
    with pytest.raises(LostStepError, match="first in-place write"):
        adamw_mod.adamw_update(AdamWConfig(), grads, state["opt"],
                               params=state["params"])
