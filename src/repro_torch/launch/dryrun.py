"""Trace any assigned architecture x shape cell on the production mesh and
count it: the port's dry run.

Ported from ``repro.launch.dryrun``, which lowers and compiles each cell
for 256 (or 512) forced host devices and reads XLA's HLO.  PyTorch has no
program to lower, so the port runs the real step, through the entry
points a user calls (``make_train_step``, ``Model.prefill``,
``make_decode_step``) under the reference's :class:`MeshPolicy` and
rules, with every parameter, optimizer leaf, cache and batch on the
``meta`` device (shapes only, nothing allocated), inside a
:class:`~repro_torch.launch.op_analysis.Recorder`.  The step is the same
Python the card runs; only the device differs, and every kernel takes
its shape function (``kernels/ops.py``) and is counted by its own work
(``kernels/work.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape decode_32k [--multi-pod | --all-meshes] [--list]

What only a ``meta`` trace needs is done here (:func:`_prepare`),
and changes nothing on ``cuda`` or ``cpu``:

* a MoE layer reads its group sizes on the host; a ``meta`` tensor has
  none, so ``models.moe.host_sizes`` splits the routed rows evenly over
  the experts (recorded as ``"moe_sizes": "balanced"``);
* the optimizer's ``step`` is a host scalar (``init_opt_state`` on
  ``meta``), which AdamW reads;
* a decode cell sets ``cache["filled"] = seq_len - 1`` (and ``enc_len``
  to the encoder's slots) and decodes one token at ``seq_len - 1``: one
  new token against a ``seq_len``-deep state, the last slot being the
  one a full cache has room for;
* a boolean mask's selection keeps every entry (:func:`_masks_keep_all`:
  a balanced router drops nothing);
* a train cell makes its params trainable.

The record has the reference's keys; ``lower_s`` / ``compile_s`` are one
``trace_s``, ``hlo`` holds the op stream's counts of the most loaded
coordinate (``op_analysis.analyze``), and ``memory`` that coordinate's
argument, output and peak live bytes (the counterpart of
``compiled.memory_analysis()``) against the card's 80 GB.  XLA's raw
``cost_analysis`` and ``--save-hlo`` have no counterpart.

Layouts (the record's ``"layout"``).  A serving cell of a stack whose
every layer is GQA attention or a Mamba2 layer with a dense, MoE or no
FFN (llama3-8b, starcoder2-3b, gemma2-9b, deepseek-7b, pixtral-12b,
phi3.5-MoE, mamba2-1.3b, jamba) runs ``"tensor_parallel"``: the policy
carries the rules, and params, cache and batch are placed by them
(``distributed.sharding.place_params`` / ``place_cache`` /
``place_batch``), so each coordinate computes its batch rows, query
heads, MLP columns, experts, SSM heads and vocab rows, and holds only
its blocks (``distributed/tensor_parallel.py``; one model group is
traced and counted for every row shard; at ``long_500k``'s batch of 1
the KV slots split over (data, model) and each coordinate attends and
writes its own block).  Every other cell runs ``"home"``: the dense
layers whole on the mesh's home device, which then carries the dense
work of the whole global batch (the MLA and cross-attention stacks,
deepseek-v2's MoE among them, and every train cell).
``load_balance`` is the most loaded coordinate's FLOPs and HBM bytes
over their means over the coordinates.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..configs import (ARCH_IDS, SHAPES, applies, batch_specs, cache_dims,
                       get_config)
from ..distributed import compat
from ..distributed.meshctx import MeshPolicy, use_policy
from ..distributed.sharding import (batch_shardings, cache_pspecs,
                                    dense_layout, make_rules,
                                    named_shardings, param_pspecs,
                                    place_batch, place_cache, place_params,
                                    serving_shardings, tree_device_bytes,
                                    train_state_shardings, PSpec)
from ..models.model import Model
from ..models.params import flat_tree, trainable
from ..optim.adamw import AdamWConfig, init_opt_state
from . import op_analysis
from .mesh import make_production_mesh
from .steps import make_decode_step, make_prefill_step, make_train_step

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
HBM_BYTES = 80e9                   # one H100's memory


def active_params(params_pspec, cfg) -> float:
    """Parameter count weighted by activation fraction (MoE experts count
    at top_k/num_experts)."""
    frac = 1.0
    if cfg.moe is not None:
        frac = cfg.moe.top_k / cfg.moe.num_experts
    total = 0.0
    for p in _pspecs(params_pspec):
        n = float(np.prod(p.value.shape))
        total += n * frac if "experts" in p.axes else n
    return total


def model_flops(cfg, shape, n_active: float) -> float:
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token / seq


def _layout(cfg, shape, multi_pod: bool):
    """The reference's batch axes and rules: FSDP for training always; at
    inference only when TP alone can't fit the weights in 16 GB HBM."""
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    fsdp = shape.kind == "train" or cfg.name in ("deepseek-v2-236b",)
    return batch_axes, make_rules(multi_pod, fsdp=fsdp)


def memory_model(cfg, shape, mesh, rules, batch_axes, params,
                 cache=None) -> dict:
    """The reference's memory model of a cell, per device under the
    rules: ``{"memory_model": {...}}`` plus ``microbatches`` for a train
    cell (gradient accumulation keeps remat residuals under ~3 GB a
    device).  ``params``, ``cache``: the port's trees (``meta`` is
    enough)."""
    params_pspec = param_pspecs(params)
    out = {}
    if shape.kind == "train":
        n_batch_shards = 1
        for a in batch_axes:
            n_batch_shards *= mesh.shape[a]
        b_local = shape.global_batch // n_batch_shards
        resid = (cfg.n_layers * b_local * shape.seq_len *
                 cfg.d_model * 2)
        K = 1
        while resid / K > 3e9 and K < b_local:
            K *= 2
        f32 = lambda p: PSpec(torch.empty(p.value.shape, dtype=torch.float32,
                                          device="meta"), p.axes)
        opt_pspec = {part: _map(f32, params_pspec)
                     for part in ("master", "m", "v")}
        opt_pspec["step"] = PSpec(torch.empty((), dtype=torch.int32,
                                              device="meta"), ())
        out["microbatches"] = K
        out["memory_model"] = {
            "params_bytes": tree_device_bytes(params_pspec, mesh, rules),
            "opt_bytes": tree_device_bytes(opt_pspec, mesh, rules),
            "residual_bytes": resid // K,
        }
    else:
        out["memory_model"] = {
            "params_bytes": tree_device_bytes(params_pspec, mesh, rules),
            "cache_bytes": tree_device_bytes(cache_pspecs(cache), mesh,
                                             rules),
        }
    return out


def _pspecs(tree):
    if isinstance(tree, PSpec):
        yield tree
    else:
        for v in tree.values():
            yield from _pspecs(v)


def _map(fn, tree):
    if isinstance(tree, PSpec):
        return fn(tree)
    return {k: _map(fn, v) for k, v in tree.items()}


def resident_bytes(trees, home=()) -> dict:
    """``{coord: bytes}`` the placed trees hold on the device: a Sharded
    leaf's blocks at their coordinates, every other device tensor at
    ``home`` (host tensors, such as the optimizer's step on ``meta``,
    hold none)."""
    per: dict = {}
    for tree in trees:
        _resident(tree, home, per)
    return per


def _resident(tree, home, per: dict) -> None:
    for leaf in flat_tree(tree).values():
        if isinstance(leaf, compat.Sharded):
            for t, c in zip(leaf.shards, leaf.block_coords()):
                key = home if c is None else tuple(c)
                per[key] = per.get(key, 0) + t.numel() * t.element_size()
        elif isinstance(leaf, compat.Replicated):
            t = leaf.value
            per[home] = per.get(home, 0) + t.numel() * t.element_size()
        elif isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
            per[home] = per.get(home, 0) + leaf.numel() * leaf.element_size()


def placed_bytes(tree, shardings, mesh) -> dict:
    """``{coord: bytes}`` a tree placed by ``shardings`` (a tree of
    :class:`NamedSharding`, keyed as ``flat_tree``) holds at every
    coordinate of ``mesh``: each coordinate the block its spec gives it
    (a replicated leaf whole)."""
    per: dict = {}
    flat = flat_tree(tree)
    for key, sh in flat_tree(shardings).items():
        leaf = flat[key]
        for c in mesh.coords():
            t = (leaf.shards[sh.index_at(c)]
                 if isinstance(leaf, compat.Sharded) else
                 leaf.value if isinstance(leaf, compat.Replicated) else leaf)
            per[c] = per.get(c, 0) + t.numel() * t.element_size()
    return per


def _prepare(model, cfg, shape, policy, rules, device):
    """The step to trace, its arguments, the record's memory-model
    fields, and ``{coord: argument bytes}`` (None: ``resident_bytes``
    of the arguments), per the module docstring's layouts and
    ``meta``-only steps."""
    mesh, batch_axes = policy.mesh, policy.batch_axes
    params = model.init(device=device)
    b_specs = batch_specs(cfg, shape)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
             for k, v in b_specs.items() if v.dim()}
    if shape.kind == "train":
        mm = memory_model(cfg, shape, mesh, rules, batch_axes, params)
        trainable(params)
        sh = train_state_shardings(params, mesh, rules)
        state = {"params": params, "opt": init_opt_state(params, sh["opt"])}
        step = make_train_step(model, AdamWConfig(),
                               microbatches=mm["microbatches"],
                               grad_shardings=sh["opt"]["master"],
                               policy=policy)
        return (lambda: step(state, batch)), (state, batch), mm, None
    B, cap, enc_cap = cache_dims(cfg, shape)
    cache = model.init_cache(B, cap, device=device, enc_cap=enc_cap)
    mm = memory_model(cfg, shape, mesh, rules, batch_axes, params, cache)
    held = None
    if dense_layout(cfg, policy) == "tensor_parallel":
        psh, csh = serving_shardings(params, cache, mesh, policy.rules)
        params = place_params(params, mesh, policy.rules)
        cache = place_cache(cache, mesh, policy.rules)
        bsh = named_shardings(batch_shardings(batch, mesh, policy.rules),
                              mesh)
        batch = place_batch(batch, mesh, policy.rules)
        held = {}
        for tree, sh in ((params, psh), (cache, csh), (batch, bsh)):
            for c, n in placed_bytes(tree, sh, mesh).items():
                held[c] = held.get(c, 0) + n
    if shape.kind == "prefill":
        prefill = make_prefill_step(model)
        return (lambda: prefill(params, cache, batch)), (params, cache,
                                                         batch), mm, held
    cache["filled"] = shape.seq_len - 1
    if "enc_len" in cache:
        cache["enc_len"] = enc_cap
    decode = make_decode_step(model)
    return (lambda: decode(params, cache, batch["tokens"],
                           shape.seq_len - 1)), (params, cache, batch), mm, \
        held


def load_balance(ana: dict, n_coords: int) -> dict:
    """The analysed (most loaded) coordinate's FLOPs and HBM bytes over
    their means over the mesh's ``n_coords`` coordinates (one that
    reported nothing counts 0)."""
    per = ana["per_coordinate"].values()
    out = {}
    for key in ("flops", "hbm_bytes"):
        mean = sum(p[key] for p in per) / n_coords
        out[key] = ana[key] / mean if mean else 1.0
    return out


def _masks_keep_all(device):
    """On ``meta``, a boolean mask's selection (``x[mask]``, whose size
    is data) keeps every entry: the balanced router of
    ``models.moe.host_sizes`` fills no expert shard past its capacity, so
    its masks keep all.  Elsewhere nothing changes."""
    if torch.device(device).type != "meta":
        return contextlib.nullcontext()
    from torch.fx.experimental import _config
    return _config.patch(meta_nonzero_assume_all_nonzero=True)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             device="meta") -> dict:
    """Trace one cell on the production mesh over ``device`` and return
    its record (``status`` ``ok`` or ``skipped``; a fault raises)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind}

    skip = applies(cfg, shape)
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    n_chips = mesh.size
    batch_axes, rules = _layout(cfg, shape, multi_pod)
    # the rules partition the dense layers of a serving step only
    policy = MeshPolicy(mesh=mesh, batch_axes=batch_axes,
                        rules=None if shape.kind == "train" else rules)
    rec["layout"] = dense_layout(cfg, policy)

    model = Model(cfg)
    t0 = time.time()
    step, args, mm, held = _prepare(model, cfg, shape, policy, rules,
                                    device)
    params = args[0]["params"] if shape.kind == "train" else args[0]
    n_active = active_params(param_pspecs(params), cfg)
    rec["n_active_params"] = n_active
    rec["model_flops_global"] = model_flops(cfg, shape, n_active)
    rec.update(mm)
    if cfg.moe is not None and torch.device(device).type == "meta":
        rec["moe_sizes"] = "balanced"
    rec["setup_s"] = time.time() - t0

    t1 = time.time()
    with use_policy(policy), _masks_keep_all(device), \
            op_analysis.Recorder(mesh, host="cpu") as recorder:
        step()
    rec["trace_s"] = time.time() - t1

    t2 = time.time()
    ana = op_analysis.analyze(recorder)
    rec["analyze_s"] = time.time() - t2
    coord = tuple(int(i) for i in ana["coordinate"].split(","))
    if held is None:
        held = resident_bytes(args, (0,) * len(mesh.axis_names))
    arg_bytes = held.get(coord, 0)
    peak = arg_bytes + ana["peak_live_bytes"]
    rec["memory"] = {
        "coordinate": ana["coordinate"],
        "argument_bytes": arg_bytes,
        "output_bytes": ana["output_live_bytes"],
        "temp_bytes": ana["peak_live_bytes"] - ana["output_live_bytes"],
        "peak_live_bytes": peak,
        "fits_80gb": peak <= HBM_BYTES,
    }
    rec["hlo"] = {k: ana[k] for k in
                  ("flops", "hbm_bytes", "collective_bytes")}
    rec["flops_by_class"] = ana["flops_by_class"]
    rec["per_collective"] = ana["per_collective"]
    rec["kernels"] = ana["kernels"]
    rec["per_coordinate"] = ana["per_coordinate"]
    rec["load_balance"] = load_balance(ana, mesh.size)
    rec["roofline"] = op_analysis.roofline(ana)
    rec["n_chips"] = n_chips
    rec["model_flops_per_chip"] = rec["model_flops_global"] / n_chips
    if ana["flops"]:
        rec["useful_flop_ratio"] = rec["model_flops_per_chip"] / ana["flops"]
    rec["status"] = "ok"
    return rec


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Trace arch x shape cells on a meta production mesh "
                    "and count them (experiments/dryrun_torch/*.json).  "
                    "The reference's --save-hlo has no counterpart: "
                    "eager PyTorch has no HLO to save.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all-meshes", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.all_meshes else [args.multi_pod]

    if args.list:
        for a in archs:
            for s in shapes:
                print(a, s, applies(get_config(a), SHAPES[s]) or "runs")
        return 0

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                out = OUT_DIR / f"{arch}__{shape}__{mesh_name}.json"
                t0 = time.time()
                try:
                    rec = run_cell(arch, shape, mp)
                except Exception as e:  # a failure here is a bug — record it
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()}
                out.write_text(json.dumps(rec, indent=2, default=float))
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f"trace={rec['trace_s']:.1f}s "
                             f"dom={r['dominant']} "
                             f"tc={r['t_compute']:.4f} tm={r['t_memory']:.4f} "
                             f"tcoll={r['t_collective']:.4f}")
                elif status == "error":
                    extra = rec["error"][:160]
                print(f"[dryrun] {arch} {shape} {mesh_name}: {status} {extra}"
                      f" ({time.time() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
