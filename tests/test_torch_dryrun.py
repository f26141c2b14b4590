"""The port's dry run (``repro_torch.launch.dryrun``, ``configs/shapes.py``
and ``launch/op_analysis.py``) against the reference's
(``repro.launch.dryrun``, ``repro.configs.shapes``,
``repro.launch.hlo_analysis``), on the CPU:

- the shapes, their skip reasons, batch specs and cache dims, the active
  parameter counts and model FLOPs, and every running cell's memory model
  (on both production meshes) equal the reference's; the reference's
  side is ``tree_device_bytes`` over its ``AbstractMesh`` in-process;
- the twins of ``test_properties.py::test_hlo_while_multiplier`` and
  ``test_sharding_elastic.py::test_hlo_analyzer_counts_collectives``,
  and the recorder's counting rules;
- a step recorded on ``meta`` counts exactly what the same step counts
  on CPU tensors (train, prefill and decode of llama3-8b and mamba2-1.3b
  at smoke scale; phi3.5-MoE on a (2, 2) mesh: equal FLOPs, and no fewer
  bytes on ``meta``, whose balanced router touches every expert; and
  partitioned by the rules, where one traced model group counts what a
  full dispatch counts at every coordinate, a batch of 1 whose KV slots
  split over (data, model) included);
- full-width cells on the production ``meta`` mesh, and the CLI.

Every comparison of counts is exact (integers, or sums of integers held
exactly in float64)."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import applies as j_applies
from repro.configs import batch_specs as j_batch_specs
from repro.configs import cache_dims as j_cache_dims
from repro.configs import get_config as j_get_config
from repro.distributed.compat import abstract_mesh as j_abstract_mesh
from repro.distributed.sharding import make_rules as j_make_rules
from repro.distributed.sharding import tree_device_bytes as j_device_bytes
from repro.models.model import Model as JModel
from repro.optim import init_opt_state as j_init_opt_state
from repro_torch.configs import (ARCH_IDS, SHAPES, applies, batch_specs,
                                 cache_dims, get_config)
from repro_torch.distributed import compat
from repro_torch.distributed.compat import abstract_mesh
from repro_torch.distributed.meshctx import MeshPolicy, use_policy
from repro_torch.kernels.work import flash_attention_work
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.op_analysis import Recorder, analyze
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.model import Model
from repro_torch.models.params import trainable
from repro_torch.optim import AdamWConfig, init_opt_state


def _reference_dryrun():
    """``repro.launch.dryrun`` sets ``XLA_FLAGS`` when imported (512 host
    devices for its own process); import it for its functions and put
    the variable back before any JAX backend reads it."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as j_dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return j_dryrun


J_DRYRUN = _reference_dryrun()
J_DTYPES = {np.dtype(jnp.int32): torch.int32,
            np.dtype(jnp.bfloat16): torch.bfloat16}
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


# ---------------------------------------------------------------------------
# shapes, parameter counts, memory model
# ---------------------------------------------------------------------------

def test_arch_ids_match_reference():
    assert ARCH_IDS == J_ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_match_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert list(SHAPES) == list(J_SHAPES)
    for name, shape in SHAPES.items():
        jshape = J_SHAPES[name]
        assert dataclasses.astuple(shape) == dataclasses.astuple(jshape)
        assert applies(cfg, shape) == j_applies(jcfg, jshape)
        assert cache_dims(cfg, shape) == j_cache_dims(jcfg, jshape)
        got, want = batch_specs(cfg, shape), j_batch_specs(jcfg, jshape)
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(v.shape)
            assert got[k].dtype == J_DTYPES[np.dtype(v.dtype)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_and_model_flops_match_reference(arch):
    cfg = get_config(arch)
    jcfg = j_get_config(arch)
    j_params = JModel(jcfg).init(None, abstract=True)
    params = Model(cfg).init(device="meta")
    from repro_torch.distributed.sharding import param_pspecs
    n = dryrun.active_params(param_pspecs(params), cfg)
    assert n == J_DRYRUN.active_params(j_params, jcfg)
    for name in SHAPES:
        assert dryrun.model_flops(cfg, SHAPES[name], n) == \
            J_DRYRUN.model_flops(jcfg, J_SHAPES[name], n)


def _reference_memory(jcfg, jshape, multi_pod):
    """The reference's ``run_cell`` memory model (``dryrun.py:78-136``)
    over its ``AbstractMesh``, with no lowering."""
    sizes, names = MESHES[multi_pod]
    mesh = j_abstract_mesh(sizes, names)
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    fsdp = jshape.kind == "train" or jcfg.name in ("deepseek-v2-236b",)
    rules = j_make_rules(multi_pod, fsdp=fsdp)
    model = JModel(jcfg)
    params = model.init(None, abstract=True)
    out = {}
    if jshape.kind == "train":
        n_batch_shards = 1
        for a in batch_axes:
            n_batch_shards *= mesh.shape[a]
        b_local = jshape.global_batch // n_batch_shards
        resid = jcfg.n_layers * b_local * jshape.seq_len * jcfg.d_model * 2
        K = 1
        while resid / K > 3e9 and K < b_local:
            K *= 2
        out["microbatches"] = K
        out["memory_model"] = {
            "params_bytes": j_device_bytes(params, mesh, rules),
            "opt_bytes": j_device_bytes(
                j_init_opt_state(params, abstract=True), mesh, rules),
            "residual_bytes": resid // K}
    else:
        B, cap, enc_cap = j_cache_dims(jcfg, jshape)
        cache = model.init_cache(B, cap, abstract=True, enc_cap=enc_cap)
        out["memory_model"] = {
            "params_bytes": j_device_bytes(params, mesh, rules),
            "cache_bytes": j_device_bytes(cache, mesh, rules)}
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_memory_model_matches_reference(arch):
    """Every running cell on both production meshes: the port's
    ``dryrun.memory_model`` (no trace) equals the reference's."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    model = Model(cfg)
    params = model.init(device="meta")
    for name, shape in SHAPES.items():
        if applies(cfg, shape):
            continue
        for multi_pod in (False, True):
            mesh = abstract_mesh(*MESHES[multi_pod])
            batch_axes, rules = dryrun._layout(cfg, shape, multi_pod)
            cache = None
            if shape.kind != "train":
                B, cap, enc_cap = cache_dims(cfg, shape)
                cache = model.init_cache(B, cap, device="meta",
                                         enc_cap=enc_cap)
            got = dryrun.memory_model(cfg, shape, mesh, rules, batch_axes,
                                      params, cache)
            want = _reference_memory(jcfg, J_SHAPES[name], multi_pod)
            assert got == want, (name, multi_pod)


# ---------------------------------------------------------------------------
# the analyser
# ---------------------------------------------------------------------------

@settings(max_examples=10, deadline=None)
@given(st.integers(1, 6), st.integers(1, 16))
def test_op_stream_loop_multiplier(trips, width):
    """Twin of ``test_hlo_while_multiplier``: a loop of ``trips`` f32
    products of (8w, 8w) counts 2 trips (8w)^3 FLOPs, exactly (the
    reference allows 5 %: it reads trip counts out of HLO)."""
    n = width * 8
    x = torch.ones((n, n), device="meta")
    w = torch.ones((trips, n, n), device="meta")
    with Recorder() as rec:
        c = x
        for i in range(trips):
            c = c @ w[i]
    ana = analyze(rec)
    assert ana["flops"] == 2.0 * trips * n ** 3
    assert ana["flops_by_class"] == {"f32": 2.0 * trips * n ** 3}


def test_op_stream_counts_collectives():
    """Twin of ``test_hlo_analyzer_counts_collectives``: a ``compat.psum``
    over ``"data"`` on a (4, 2) CPU debug mesh of a (64, 128) f32 counts
    each coordinate's operand, (64 / 4) x 128 x 4 B = 8192 bytes, under
    all-reduce."""
    mesh = make_debug_mesh(4, 2, device="cpu")
    x = torch.randn(64, 128)
    with Recorder(mesh) as rec:
        parts = compat.shard_map(lambda i, d: x[i * 16:(i + 1) * 16].to(d)
                                 * 1.0, mesh, ("data",))
        total = compat.psum(parts)
    assert torch.equal(total, sum(x.split(16)))
    ana = analyze(rec)
    assert ana["collective_bytes"] >= 8192
    assert ana["per_collective"]["all-reduce"] >= 8192
    for c in mesh.shard_coords(("data",)):
        key = ",".join(map(str, c))
        assert ana["per_coordinate"][key]["per_collective"][
            "all-reduce"] == 8192


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counting_rules(device):
    n = 1000
    a, b = torch.ones(n, device=device), torch.ones(n, device=device)
    with Recorder() as rec:
        a.view(10, 100).t()[3]
    assert analyze(rec)["hbm_bytes"] == 0                  # views: nothing
    with Recorder() as rec:
        a + b
    assert analyze(rec)["hbm_bytes"] == 12 * n             # 2 reads, 1 write
    with Recorder() as rec:
        torch.zeros(n, device=device)
        a.copy_(b)
    assert analyze(rec)["hbm_bytes"] == 4 * n + 8 * n      # a fill, a copy
    mesh = make_debug_mesh(2, 2, device=device)
    with Recorder(mesh) as rec:
        compat.shard_map(lambda i, d: a * (i + 1), mesh, ("model",))
        a * 3
    per = analyze(rec)["per_coordinate"]
    assert per["0,0"]["hbm_bytes"] == 16 * n               # shard 0 + home
    assert per["0,1"]["hbm_bytes"] == 8 * n                # shard 1
    assert per["0,1"]["peak_live_bytes"] == 4 * n


# ---------------------------------------------------------------------------
# meta against the host
# ---------------------------------------------------------------------------

SMOKE_ARCHS = ("llama3-8b", "mamba2-1.3b")
B, S = 2, 32


def _batch(cfg, device, kind):
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab, (B, S), generator=g, dtype=torch.int32)
    out = {"tokens": tok}
    if kind == "train":
        out["labels"] = torch.roll(tok, -1, 1)
    return {k: v.to(device) for k, v in out.items()}


def _step(model, kind, device, mesh=None):
    """The step of ``kind`` over ``model`` with its arguments on
    ``device`` (params from seed 0; their values do not change a count)."""
    params = model.init(0, device) if device != "meta" else \
        model.init(device="meta")
    batch = _batch(model.cfg, device, kind)
    pol = None if mesh is None else MeshPolicy(mesh=mesh)
    if kind == "train":
        trainable(params)
        state = {"params": params, "opt": init_opt_state(params)}
        step = make_train_step(model, AdamWConfig(), microbatches=2,
                               policy=pol)
        return lambda: step(state, batch)
    cache = model.init_cache(B, 2 * S, device=device)
    if kind == "prefill":
        prefill = make_prefill_step(model)
        return lambda: prefill(params, cache, batch)
    cache["filled"] = S
    decode = make_decode_step(model)
    return lambda: decode(params, cache, batch["tokens"][:, :1], S)


def _counts(step, mesh=None, policy=None):
    with use_policy(policy), dryrun._masks_keep_all(
            "meta" if mesh is not None and mesh.home.type == "meta"
            else "cpu"), Recorder(mesh) as rec:
        step()
    return analyze(rec)


def _same(a, b):
    assert a["flops_by_class"] == b["flops_by_class"]
    assert a["hbm_bytes"] == b["hbm_bytes"]
    assert a["collective_bytes"] == b["collective_bytes"]
    assert a["kernels"] == b["kernels"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_meta_counts_what_the_host_counts(arch, kind):
    """The same step, recorded once on ``meta`` and once on CPU tensors,
    counts the same FLOPs by class, bytes, collective bytes and kernel
    work: the dry run's counts are the real path's."""
    model = Model(get_config(arch).smoke())
    host = _counts(_step(model, kind, "cpu"))
    meta = _counts(_step(model, kind, "meta"))
    _same(meta, host)
    kern = "ssd_scan" if arch.startswith("mamba") else "flash_attention"
    if kind != "decode" or kern == "flash_attention":
        layers = model.cfg.n_layers
        calls = {"train": 2 * 2 * layers, "prefill": layers,
                 "decode": layers}[kind]    # train: 2 microbatches, remat
        assert host["kernels"][kern]["calls"] == calls
    if kind == "train":
        assert host["kernels"][kern + "_bwd"]["calls"] == 2 * layers
    assert host["peak_live_bytes"] == meta["peak_live_bytes"]


def test_moe_on_a_mesh_meta_against_the_host():
    """phi3.5-MoE smoke through the expert-parallel MoE on a (2, 2) mesh:
    the same FLOPs over the mesh (capacity factor 4: the host drops
    nothing, and the balanced router fills no shard past its capacity)
    and no fewer bytes on ``meta`` (every expert touched)."""
    cfg = get_config("phi3.5-moe-42b-a6.6b").smoke()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    model = Model(cfg)
    out = {}
    for dev in ("cpu", "meta"):
        mesh = make_debug_mesh(2, 2, device=dev)
        pol = MeshPolicy(mesh=mesh)
        res = {}
        with use_policy(pol):
            res = _counts(_step(model, "prefill", dev), mesh, pol)
        out[dev] = res
    tot = lambda a, k: sum(p[k] for p in a["per_coordinate"].values())
    assert tot(out["meta"], "flops") == tot(out["cpu"], "flops")
    assert tot(out["meta"], "hbm_bytes") >= tot(out["cpu"], "hbm_bytes")
    assert out["meta"]["kernels"] == out["cpu"]["kernels"]
    assert out["meta"]["per_collective"]["all-to-all"] > 0


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_moe_on_a_mesh_meta_against_the_host_under_rules(kind, monkeypatch):
    """The same phi3.5-MoE smoke step partitioned by the rules on a (2, 2)
    mesh (the all-to-all body at prefill, the psum body at decode):
    traced on ``meta`` with one model group standing for every row shard
    and with every coordinate dispatched, every coordinate's counts and
    every kernel's are equal; and against the host's run, the same FLOPs
    over the mesh (capacity factor 4: nothing dropped, and the balanced
    router fills no shard past its capacity), no fewer bytes, the same
    kernel work, and the body's collectives counted."""
    from repro_torch.distributed import tensor_parallel
    from repro_torch.distributed.sharding import (make_rules, place_cache,
                                                  place_params)
    cfg = get_config("phi3.5-moe-42b-a6.6b").smoke()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    model = Model(cfg)
    rules = make_rules(False, fsdp=False)

    def counts(dev, classes=True):
        monkeypatch.setattr(tensor_parallel, "CLASS_DISPATCH", classes)
        mesh = make_debug_mesh(2, 2, device=dev)
        pol = MeshPolicy(mesh=mesh, rules=rules)
        params = model.init(0, dev) if dev != "meta" else model.init(
            device="meta")
        params = place_params(params, mesh, rules)
        cache = place_cache(model.init_cache(B, 2 * S, device=dev), mesh,
                            rules)
        tok = _batch(cfg, dev, kind)["tokens"]
        if kind == "prefill":
            step = lambda: make_prefill_step(model)(params, cache,
                                                    {"tokens": tok})
        else:
            cache["filled"] = S
            step = lambda: make_decode_step(model)(params, cache,
                                                   tok[:, :1], S)
        return _counts(step, mesh, pol)

    host, full, classes = counts("cpu"), counts("meta", False), \
        counts("meta")
    assert len(full["per_coordinate"]) == 4
    assert classes["per_coordinate"] == full["per_coordinate"]
    assert classes["kernels"] == full["kernels"] == host["kernels"]
    tot = lambda a, k: sum(p[k] for p in a["per_coordinate"].values())
    assert tot(full, "flops") == tot(host, "flops")
    assert tot(full, "hbm_bytes") >= tot(host, "hbm_bytes")
    coll = full["per_coordinate"]["1,1"]["per_collective"]
    assert coll == host["per_coordinate"]["1,1"]["per_collective"]
    if kind == "prefill":
        assert coll["all-to-all"] > 0 and coll["all-gather"] > 0
    else:       # the rows gathered over the data axis
        assert coll["all-gather"] > 0 and coll["all-to-all"] > 0


# ---------------------------------------------------------------------------
# full-width cells on the production meta mesh
# ---------------------------------------------------------------------------

# the most loaded coordinate's peak live bytes of a partitioned cell,
# where a smaller bound than 16 GB was reckoned for it
PEAK_BELOW = {("mamba2-1.3b", "prefill_32k"): 6e9,
              ("jamba-v0.1-52b", "prefill_32k"): 16e9}


@pytest.mark.parametrize("arch,shape", [
    ("llama3-8b", "decode_32k"),
    ("llama3-8b", "prefill_32k"),
    ("gemma2-9b", "prefill_32k"),
    ("gemma2-9b", "decode_32k"),
    ("phi3.5-moe-42b-a6.6b", "prefill_32k"),
    ("mamba2-1.3b", "long_500k"),
    ("jamba-v0.1-52b", "prefill_32k"),
    ("mamba2-1.3b", "train_4k"),
])
def test_full_width_cell_on_the_production_mesh(arch, shape):
    rec = dryrun.run_cell(arch, shape, multi_pod=False)
    assert rec["status"] == "ok"
    cfg = get_config(arch)
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.pattern[i % len(cfg.pattern)].kind == "attn")
    n_ssm = cfg.n_layers - n_attn
    kern = rec["kernels"]
    # every serving cell of the zoo's GQA / Mamba stacks is partitioned
    tp = SHAPES[shape].kind != "train"
    assert rec["layout"] == ("tensor_parallel" if tp else "home")
    B, cap, _ = cache_dims(cfg, SHAPES[shape])
    windows = [cfg.pattern[i % len(cfg.pattern)].window
               for i in range(cfg.n_layers)
               if cfg.pattern[i % len(cfg.pattern)].kind == "attn"]

    def kv_shards(window):
        """The 16 KV shards' indices holding a slot the last position
        sees (its window, or every slot)."""
        lo = 0 if window is None else cap - window
        return [j for j in range(16) if (j + 1) * cap // 16 > lo]

    if tp and SHAPES[shape].kind == "prefill":
        # every coordinate attends its query heads and scans its SSM
        # heads over its rows
        assert set(kern) <= {"flash_attention", "ssd_scan"}
        assert kern.get("flash_attention", {}).get("calls", 0) == \
            n_attn * 256
        assert kern.get("ssd_scan", {}).get("calls", 0) == n_ssm * 256
        # wo, w_down and out_proj row-parallel, the Mamba norm's sums;
        # new k / v from heads to sequence, a Mamba layer's columns and
        # channels (and a MoE layer's packs to their expert shards)
        assert rec["per_collective"]["all-reduce"] > 0
        assert rec["per_collective"]["all-to-all"] > 0
        assert rec["useful_flop_ratio"] >= (0.4 if n_attn == 0 else 0.3)
    elif SHAPES[shape].kind == "decode":
        # decode: the sequence-parallel flash decode, one call a KV shard
        # with visible slots (16 data rows each) at 32k over (16, 16)
        assert kern.get("flash_attention", {}).get("calls", 0) == \
            sum(16 * len(kv_shards(w)) for w in windows)
        assert "ssd_scan" not in kern
        # partitioned, the row-parallel sums (and the Mamba norm's)
        assert rec["per_collective"]["all-reduce"] > 0
    elif SHAPES[shape].kind == "prefill":
        assert kern["flash_attention"]["calls"] == n_attn
        assert kern["ssd_scan"]["calls"] == n_ssm
        assert rec["per_collective"]["all-to-all"] > 0      # expert parallel
        assert rec["moe_sizes"] == "balanced"
    else:
        K = rec["microbatches"]
        assert kern["ssd_scan"]["calls"] == 2 * K * n_ssm   # remat
        assert kern["ssd_scan_bwd"]["calls"] == K * n_ssm
        assert rec["per_collective"]["reduce-scatter"] > 0  # ZeRO
    if tp and any(w is not None for w in windows) \
            and SHAPES[shape].kind == "decode":
        # a windowed decode: each windowed layer's attention lies on the
        # KV shards holding the window (2 of 16), so the coordinates'
        # FLOPs take two values, the heavy ones on those shards, apart by
        # exactly the windowed layers' attention over a shard's slots
        win = [w for w in windows if w is not None]
        heavy = set(kv_shards(win[0]))
        assert all(set(kv_shards(w)) == heavy for w in win)
        flops = {}
        for key, p in rec["per_coordinate"].items():
            flops.setdefault(int(key.split(",")[1]) in heavy,
                             set()).add(p["flops"])
        assert len(flops[True]) == len(flops[False]) == 1
        hd, bf16 = cfg.head_dim_, torch.bfloat16
        q = torch.empty((B // 16, 1, cfg.n_heads, hd), dtype=bf16,
                        device="meta")
        k = torch.empty((B // 16, cap // 16, cfg.n_kv_heads, hd),
                        dtype=bf16, device="meta")
        attn = flash_attention_work(q, k, causal=False, window=None,
                                    return_lse=True).total_flops
        assert flops[True].pop() - flops[False].pop() == len(win) * attn
        assert rec["load_balance"]["flops"] < 1.31     # 1.304 measured
    elif tp:
        # partitioned: the most loaded coordinate does no more than 1.25x
        # the mean work
        assert rec["load_balance"]["flops"] <= 1.25
        assert rec["load_balance"]["hbm_bytes"] <= 1.25
    if tp:
        # it holds only its blocks, and fits one card
        assert rec["memory"]["fits_80gb"]
        assert rec["memory"]["peak_live_bytes"] < PEAK_BELOW.get(
            (arch, shape), 16e9)
    else:
        assert rec["memory"]["coordinate"] == "0,0"
    assert 0 < rec["useful_flop_ratio"] < 1
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")


@pytest.mark.parametrize("arch,kind,B", [
    pytest.param(a, k, 8, id=f"{a}-{k}") for a in ("gemma2-9b", "pixtral-12b")
    for k in ("prefill", "decode")] + [
    ("jamba-v0.1-52b", "prefill", 8), ("jamba-v0.1-52b", "prefill", 1),
    ("jamba-v0.1-52b", "decode", 1)])
def test_class_dispatch_counts_what_full_dispatch_counts(arch, kind, B,
                                                         monkeypatch):
    """The partitioned step on a (4, 2) meta mesh, traced once with one
    model group standing for every row shard (the dry run's class
    dispatch) and once dispatching all 8 coordinates: every coordinate's
    FLOPs by class, bytes, collective bytes, operation count and peak
    live bytes, and every kernel's calls and work, are equal (gemma2's
    window and tied table, pixtral's media, jamba's Mamba layers and
    their exchanges; decode at slot 47 of 48, so one KV shard writes).
    At B 1 the rows are not split and the KV slots split over (data,
    model): coordinates of one class hold other slots, and each attends
    and writes its own."""
    from repro_torch.distributed import tensor_parallel
    from repro_torch.distributed.sharding import (make_rules, place_batch,
                                                  place_cache, place_params)
    model = Model(get_config(arch).smoke())
    mesh = make_debug_mesh(4, 2, device="meta")
    rules = make_rules(False, fsdp=False)
    pol = MeshPolicy(mesh=mesh, rules=rules)
    cfg = model.cfg

    def counts(classes: bool):
        monkeypatch.setattr(tensor_parallel, "CLASS_DISPATCH", classes)
        params = place_params(model.init(device="meta"), mesh, rules)
        cache = place_cache(model.init_cache(B, 48, device="meta"), mesh,
                            rules)
        batch = {"tokens": torch.zeros((B, 40 - cfg.num_media_tokens),
                                       dtype=torch.int32, device="meta")}
        if cfg.num_media_tokens:
            batch["media"] = torch.zeros(
                (B, cfg.num_media_tokens, cfg.d_model), device="meta",
                dtype=torch.bfloat16)
        if kind == "decode":
            cache["filled"] = 47
            batch = {"tokens": batch["tokens"][:, :1]}
        batch = place_batch(batch, mesh, rules)
        if kind == "prefill":
            step = lambda: make_prefill_step(model)(params, cache, batch)
        else:
            step = lambda: make_decode_step(model)(params, cache,
                                                   batch["tokens"], 47)
        return _counts(step, mesh, pol)

    full, classes = counts(False), counts(True)
    assert len(full["per_coordinate"]) == 8
    assert classes["per_coordinate"] == full["per_coordinate"]
    assert classes["kernels"] == full["kernels"]
    if B == 1:      # the blocks' partials cross the model groups
        assert full["per_coordinate"]["3,1"]["per_collective"][
            "all-to-all"] > 0


def test_skipped_cell_gives_the_reference_reason():
    rec = dryrun.run_cell("llama3-8b", "long_500k", multi_pod=True)
    assert rec["status"] == "skipped"
    assert rec["reason"] == j_applies(j_get_config("llama3-8b"),
                                      J_SHAPES["long_500k"])


def test_production_mesh_on_meta():
    mesh = make_production_mesh(multi_pod=True, device="meta")
    assert dict(mesh.shape) == {"pod": 2, "data": 16, "model": 16}
    assert mesh.home.type == "meta"
    with pytest.raises(ValueError):
        make_production_mesh()          # no 256 cards here


def test_cli_writes_one_record(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    assert dryrun.main(["--arch", "mamba2-1.3b", "--shape",
                        "long_500k"]) == 0
    rec = json.loads((tmp_path / "mamba2-1.3b__long_500k__pod16x16.json")
                     .read_text())
    assert rec["status"] == "ok"
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[dryrun] mamba2-1.3b long_500k pod16x16: ok ")
    assert " dom=" in line and " tcoll=" in line
    assert dryrun.main(["--arch", "llama3-8b", "--list"]) == 0
    assert "llama3-8b long_500k full-attention" in capsys.readouterr().out
