"""Logical-axis -> mesh-axis sharding rules.

Ported from ``repro.distributed.sharding`` (the rule table and its
resolver are copied, so the port imports nothing of the reference).
Every parameter / cache leaf can be described by a tuple of logical axis
names; a rule table maps each logical name to an ordered preference of
mesh axes, and the resolver assigns mesh axes per array under two
constraints:

  * a mesh axis is used at most once per array, and
  * the dimension must divide by the product of the assigned axis sizes
    (falling back to fewer axes / replication otherwise).

A spec is a tuple with one entry per dimension — ``None``, an axis name,
or a tuple of names — with trailing ``None``\\ s trimmed, so it equals
``tuple(PartitionSpec(...))`` of the reference's.

What the port does with a spec: the serving data plane lays out its
state and batches by :func:`plane_state_shardings` /
:func:`plane_batch_shardings` (tables replicated, sketches and batches
split on ``"data"``); the home layout's expert-parallel MoE and
sequence-parallel decode split their operands by hand.  For serving a
stack whose every layer is GQA attention or a Mamba2 layer, with a
dense, MoE or no FFN (:func:`dense_layout` says ``"tensor_parallel"``:
the dense stacks, phi3.5-MoE, mamba2 and jamba), :func:`place_params`,
:func:`place_cache` and :func:`place_batch` lay params (the expert
stacks' experts over the model axis, the Mamba layers' ``ssm_heads``
and ``ssm_in`` dims there too), KV and Mamba state caches and batch
out by the specs, each block on its coordinate's device, and
``Model.prefill`` / ``decode_step`` run partitioned on them
(``distributed/tensor_parallel.py``).  A batch of 1 leaves the data
axes free, so the KV cache's ``seq_kv`` splits over ``("data",
"model")``, the reason the reference's rule exists.  Every other stack
(MLA, cross-attention, a dense prefix), and training's dense layers,
stay whole on the mesh's home device (``"home"``);
:func:`tree_device_bytes` reports the per-device bytes the rules give,
the figure the reference's dry run plans memory with.

Training places its state by the rules too (ZeRO): :class:`NamedSharding`
is a spec on a mesh, the reference's ``NamedSharding``;
:func:`param_pspecs` gives a param tree its logical axes (the
reference's ``Initializer`` records them per leaf; the port's leaves
carry none, so they come from the leaf's name, as
:data:`PARAM_AXES` lists them); :func:`train_state_shardings` and
:func:`place_train_state` lay a train state out (params whole on the
mesh's home device, ``master`` / ``m`` / ``v`` split by their specs),
and :func:`gather_to_host` reads any placed tree back whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.params import ParamTree, flat_tree, leaf_slots, \
    unflat_tree
from . import compat
from .meshctx import Mesh

AxisPref = Tuple[str, ...]
Rules = Dict[str, AxisPref]


class PSpec(NamedTuple):
    """A leaf with its logical axes: ``value`` is anything with
    ``shape`` and ``dtype`` (a tensor, a ``meta`` tensor)."""
    value: Any
    axes: Tuple[Optional[str], ...]


def is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def make_rules(multi_pod: bool, *, fsdp: bool = True,
               model_axis: str = "model") -> Rules:
    batch = ("pod", "data") if multi_pod else ("data",)
    fsdp_axes = ("data",) if fsdp else ()
    m = (model_axis,)
    return {
        # params
        "experts": m,
        "q_heads": m,
        "kv_heads": m,
        "vocab": m + fsdp_axes,       # falls back to fsdp if not divisible
        "mlp": m,
        # kv_lora is a contraction dim of MLA attention: FSDP-shard it,
        # heads carry the TP
        "kv_lora": fsdp_axes,
        "ssm_heads": m,
        "ssm_in": m,
        "embed": fsdp_axes,           # FSDP / ZeRO shard dim
        "head_dim": (),
        "layers": (),                 # stacked-layer dim — never sharded
        # activations / caches
        "batch": batch,
        "seq_kv": ("data", model_axis),
        "seq_enc": (model_axis,),
        # flattened token dim entering the EP all-to-all region
        "tokens": batch + m,
    }


def spec_for(axes: Tuple[Optional[str], ...], rules: Rules, mesh: Mesh,
             shape: Tuple[int, ...]) -> tuple:
    used = set()
    parts = []
    for dim, name in zip(shape, axes):
        assigned: Tuple[str, ...] = ()
        if name is not None:
            size = 1
            for ax in rules.get(name, ()):
                if ax in used or ax not in mesh.shape:
                    continue
                if dim % (size * mesh.shape[ax]) == 0:
                    assigned = assigned + (ax,)
                    size *= mesh.shape[ax]
                    used.add(ax)
        if len(assigned) == 0:
            parts.append(None)
        elif len(assigned) == 1:
            parts.append(assigned[0])
        else:
            parts.append(assigned)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _map_pspecs(fn, tree):
    if is_pspec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_pspecs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_pspecs(fn, v) for v in tree)
    raise TypeError(f"not a PSpec tree leaf: {type(tree).__name__}")


def logical_axes(tree_pspec, prefix: str = "") -> Dict[str, tuple]:
    """``{"a/b/c": axes}`` of a PSpec tree (``flat_tree``'s keys)."""
    if is_pspec(tree_pspec):
        return {prefix[:-1]: tree_pspec.axes}
    out = {}
    for k, v in tree_pspec.items():
        out.update(logical_axes(v, f"{prefix}{k}/"))
    return out


def shardings_for(tree_pspec, mesh: Mesh, rules: Rules):
    """PSpec tree -> spec tree (same structure)."""
    return _map_pspecs(
        lambda p: spec_for(p.axes, rules, mesh, tuple(p.value.shape)),
        tree_pspec)


def _n_shards(spec: tuple, mesh: Mesh) -> int:
    n = 1
    for entry in spec:
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            n *= mesh.shape[a]
    return n


def tree_device_bytes(tree_pspec, mesh: Mesh, rules: Rules) -> int:
    """Exact per-device resident bytes of a PSpec tree under the rules
    (shape product x dtype size / shard factor)."""
    total = 0

    def f(p: PSpec):
        nonlocal total
        shape = tuple(p.value.shape)
        spec = spec_for(p.axes, rules, mesh, shape)
        item = (p.value.element_size() if isinstance(p.value, torch.Tensor)
                else np.dtype(p.value.dtype).itemsize)
        total += int(np.prod(shape, dtype=np.int64)) * item // max(
            _n_shards(spec, mesh), 1)
        return None

    _map_pspecs(f, tree_pspec)
    return total


# ---------------------------------------------------------------------------
# Data-plane (Morpheus serving) placement
# ---------------------------------------------------------------------------

def plane_state_shardings(state, mesh: Mesh,
                          instr_axes: Tuple[str, ...] = ("data",)):
    """Per-leaf specs for a ``PlaneState`` (a PlaneState of specs):
    ``tables`` and ``guards`` replicated (``()``), every ``instr`` sketch
    leaf split on its leading shard axis over ``instr_axes``."""
    local = (tuple(instr_axes),)
    return state.replace(
        tables={n: {f: () for f in t} for n, t in state.tables.items()},
        instr={s: {k: local for k in st} for s, st in state.instr.items()},
        guards={n: () for n in state.guards})


def plane_batch_shardings(batch, mesh: Mesh,
                          axes: Tuple[str, ...] = ("data",),
                          stacked: bool = False) -> Dict[str, tuple]:
    """Request-batch placement for the serving data plane: the leading
    (batch) dim split over ``axes`` when it divides, scalars and
    indivisible leaves replicated (``()``).  With ``stacked=True`` (fused
    K-step windows) each leaf's leading window axis stays whole and the
    per-step batch dim under it is split."""
    n = mesh.axes_size(axes)
    d = 1 if stacked else 0
    out = {}
    for k, x in batch.items():
        shape = tuple(getattr(x, "shape", ()))
        if len(shape) >= d + 1 and shape[d] % n == 0:
            out[k] = (None,) * d + (tuple(axes),)
        else:
            out[k] = ()
    return out


def batch_shardings(batch_specs: dict, mesh: Mesh, rules: Rules):
    """Data-batch inputs: split the leading (batch) dim; 0-d position
    scalars are replicated."""
    out = {}
    for k, v in batch_specs.items():
        if len(v.shape) == 0:
            out[k] = ()
        else:
            axes = ("batch",) + (None,) * (len(v.shape) - 1)
            out[k] = spec_for(axes, rules, mesh, tuple(v.shape))
    return out


# ---------------------------------------------------------------------------
# Training state placement (ZeRO)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NamedSharding:
    """A spec (as :func:`spec_for` gives it) on a mesh: where a leaf's
    blocks lie.  A spec that splits nothing replicates the leaf."""
    mesh: Mesh
    spec: tuple

    @property
    def split_dims(self) -> Tuple[int, ...]:
        return tuple(d for d, e in enumerate(self.spec) if e is not None)

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the spec uses, in spec order (the shard order of
        :meth:`Mesh.shard_coords`)."""
        out: Tuple[str, ...] = ()
        for e in self.spec:
            if e is not None:
                out += e if isinstance(e, tuple) else (e,)
        return out

    @property
    def grid(self) -> Tuple[int, ...]:
        return tuple(_n_shards((self.spec[d],), self.mesh)
                     for d in self.split_dims)

    @property
    def coords(self) -> Tuple[Tuple[int, ...], ...]:
        """The mesh coordinate of each block, in shard order."""
        return self.mesh.shard_coords(self.axes)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The device of each block, in shard order."""
        return tuple(self.mesh.device_at(c) for c in self.coords)

    @property
    def replicated(self) -> bool:
        return not self.split_dims

    def place(self, x: torch.Tensor, dtype=None):
        """``x`` laid out by this sharding, as blocks of their own (no
        view of ``x`` survives): a :class:`~repro_torch.distributed.\
compat.Sharded` in shard order, or a :class:`~repro_torch.distributed.\
compat.Replicated` for a spec that splits nothing."""
        x = x.detach() if dtype is None else x.detach().to(dtype)
        if self.replicated:
            return compat.Replicated(
                {d: x.to(d, copy=True)
                 for d in self.mesh.distinct_devices})
        return compat.split_grid(x, self.split_dims, self.grid,
                                 self.devices, copy=True,
                                 coords=self.coords)

    def holds(self, leaf) -> bool:
        """True when ``leaf`` already lies as this sharding places it."""
        if self.replicated:
            if isinstance(leaf, compat.Replicated):
                return tuple(leaf.copies) == self.mesh.distinct_devices
            return (isinstance(leaf, torch.Tensor)
                    and self.mesh.distinct_devices == (leaf.device,))
        return (isinstance(leaf, compat.Sharded)
                and leaf.dims == self.split_dims
                and leaf.grid == self.grid
                and leaf.devices == self.devices)

    def index_at(self, coord) -> int:
        """The block held at mesh coordinate ``coord`` (every coordinate
        that differs only along axes the spec does not use holds the same
        block)."""
        return self.mesh.axis_index(coord, self.axes)

    def range_at(self, coord, dim: int, size: int) -> Tuple[int, int]:
        """``[lo, hi)`` of dimension ``dim`` (of length ``size``) in the
        block held at ``coord``."""
        entry = self.spec[dim] if dim < len(self.spec) else None
        if entry is None:
            return 0, size
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = size // self.mesh.axes_size(axes)
        k = self.mesh.axis_index(coord, axes)
        return k * n, (k + 1) * n

    def cut(self, x: torch.Tensor):
        """``x`` (a whole value, e.g. a gradient) as this sharding's
        blocks, each on its device: views of ``x`` where a block lies on
        ``x``'s device.  ``x`` itself for a spec that splits nothing."""
        if self.replicated:
            return x
        return compat.split_grid(x, self.split_dims, self.grid,
                                 self.devices, coords=self.coords)


# The logical axes of every param leaf of the zoo, by the leaf's name
# (the reference's ``Initializer`` calls: models/{attention,layers,moe,
# ssd}.py).  A stacked leaf has one more leading "layers" axis a stack.
PARAM_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "wq": ("embed", "q_heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("q_heads", "head_dim", "embed"),
    "w_dkv": ("embed", "kv_lora"),
    "w_krope": ("embed", "head_dim"),
    "w_uk": ("kv_lora", "q_heads", "head_dim"),
    "w_uv": ("kv_lora", "q_heads", "head_dim"),
    "scale": ("embed",),
    "table": ("vocab", "embed"),
    "w": ("embed", "vocab"),
    "w_up": ("embed", "mlp"),
    "w_gate": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
    "w_router": ("embed", None),
    "b_router": (None,),
    "w1": ("experts", "embed", "mlp"),
    "w3": ("experts", "embed", "mlp"),
    "w2": ("experts", "mlp", "embed"),
    "in_proj": ("embed", "ssm_in"),
    "conv_w": (None, "ssm_in"),
    "conv_b": ("ssm_in",),
    "A_log": ("ssm_heads",),
    "D": ("ssm_heads",),
    "dt_bias": ("ssm_heads",),
    "norm_scale": ("ssm_in",),
    "out_proj": ("ssm_in", "embed"),
}


def param_pspecs(params) -> Dict[str, Any]:
    """A params tree (a ParamTree or nested dicts) as a PSpec tree of
    nested dicts: each leaf with the reference's logical axes."""
    out = {}
    for key, v in flat_tree(params).items():
        base = PARAM_AXES[key.rsplit("/", 1)[-1]]
        extra = len(v.shape) - len(base)
        if extra not in (0, 1):
            raise ValueError(f"param_pspecs: {key} of shape "
                             f"{tuple(v.shape)} has no axes for {base}")
        out[key] = PSpec(v, ("layers",) * extra + base)
    return unflat_tree(out)


# The logical axes of every cache leaf, by its (entry, leaf) names (the
# reference's ``init_layer_cache``); a stacked leaf has one more leading
# "layers" axis.
CACHE_AXES: Dict[Tuple[str, str], Tuple[Optional[str], ...]] = {
    ("kv", "k"): ("batch", "seq_kv", "kv_heads", "head_dim"),
    ("kv", "v"): ("batch", "seq_kv", "kv_heads", "head_dim"),
    ("kv", "pos"): ("seq_kv",),
    ("kv", "ckv"): ("batch", "seq_kv", "kv_lora"),
    ("kv", "k_rope"): ("batch", "seq_kv", None),
    ("mamba", "conv"): ("batch", None, "ssm_in"),
    ("mamba", "ssm"): ("batch", "ssm_heads", None, None),
    ("xkv", "k"): ("batch", "seq_enc", "kv_heads", "head_dim"),
    ("xkv", "v"): ("batch", "seq_enc", "kv_heads", "head_dim"),
}


def cache_pspecs(cache) -> Dict[str, Any]:
    """A cache tree (``Model.init_cache``) as a PSpec tree of nested
    dicts with the reference's logical axes; the host-side entries
    (``filled``, ``enc_len``) are left out.  A placed leaf (``Sharded`` /
    ``Replicated``) counts by its whole shape."""
    out = {}
    for key, v in flat_tree(cache).items():
        if not hasattr(v, "shape"):
            continue
        entry, leaf = key.split("/")[-2:]
        base = CACHE_AXES[(entry, leaf)]
        extra = len(v.shape) - len(base)
        if extra not in (0, 1):
            raise ValueError(f"cache_pspecs: {key} of shape "
                             f"{tuple(v.shape)} has no axes for {base}")
        out[key] = PSpec(v, ("layers",) * extra + base)
    return unflat_tree(out)


def named_shardings(specs, mesh: Mesh):
    """A spec tree (:func:`shardings_for`) as :class:`NamedSharding`
    leaves on ``mesh``."""
    return _map_specs(lambda s: NamedSharding(mesh, s), specs)


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def train_state_shardings(params, mesh: Mesh, rules: Rules) -> dict:
    """The ZeRO layout of a train state ``{"params", "opt": {master, m,
    v, step}}``: ``master`` / ``m`` / ``v`` by the params' specs under
    ``rules`` (each block on its coordinate's device), the params and
    ``step`` replicated.  ``state["opt"]["master"]`` is also the
    ``grad_shardings`` of :func:`~repro_torch.launch.steps.\
make_train_step`."""
    zero = named_shardings(shardings_for(param_pspecs(params), mesh, rules),
                           mesh)
    rep = _map_specs(lambda _: NamedSharding(mesh, ()), zero)
    return {"params": rep,
            "opt": {"master": zero, "m": zero, "v": zero,
                    "step": NamedSharding(mesh, ())}}


@torch.no_grad()
def place_train_state(state: dict, shardings: dict) -> dict:
    """Lay ``state`` out by ``shardings`` (:func:`train_state_shardings`)
    and return it.  The params (a ParamTree, whose leaves must stay
    parameters) move whole to the mesh's home device, where the model
    runs; the other devices of the mesh take what they need per call
    (the expert-parallel MoE copies its experts' slices), so on a
    repeated-device mesh the params are the one copy the replicated
    layout asks for.  ``step`` stays a tensor on the home device.  Every
    other leaf is placed by its sharding, one leaf at a time, its old
    tensor dropped before the next is built."""
    home = shardings["opt"]["step"].mesh.home
    state["params"].to(home)
    opt = state["opt"]
    opt["step"] = opt["step"].to(home)
    for part in ("master", "m", "v"):
        sh = flat_tree(shardings["opt"][part])
        for box, name, key in leaf_slots(opt[part]):
            if sh[key].holds(box[name]):
                continue
            whole = compat.to_home(box[name], home)
            box[name] = None
            box[name] = sh[key].place(whole)
            del whole
    return state


# ---------------------------------------------------------------------------
# Serving placement of a dense stack (the tensor-parallel layout)
# ---------------------------------------------------------------------------

def dense_layout(cfg, policy) -> str:
    """``"tensor_parallel"`` when ``policy`` carries a mesh and a rule
    table and every layer of ``cfg`` is GQA self-attention or a Mamba2
    layer, with a dense, MoE or no FFN (no MLA, cross-attention, encoder
    or dense prefix layers: the dense stacks, phi3.5-MoE, mamba2 and
    jamba); else ``"home"``, the dense layers whole on the mesh's home
    device.  Chosen once, at placement, by the stack alone (not by the
    batch): under ``"tensor_parallel"`` the MoE FFN runs on placed
    expert blocks and the Mamba layers on their placed heads too."""
    if policy is None or policy.mesh is None or policy.rules is None:
        return "home"
    dense = (not cfg.encdec and cfg.mla is None and not cfg.first_k_dense
             and all(sp.kind in ("attn", "mamba")
                     and sp.ffn in ("dense", "moe", "none")
                     and not sp.cross_attn for sp in cfg.pattern))
    return "tensor_parallel" if dense else "home"


def serving_shardings(params, cache, mesh: Mesh, rules: Rules):
    """``(param shardings, cache shardings)``: :class:`NamedSharding`
    trees by ``param_pspecs`` / ``cache_pspecs`` under ``rules`` (the
    cache's host-side entries have none)."""
    return (named_shardings(shardings_for(param_pspecs(params), mesh,
                                          rules), mesh),
            named_shardings(shardings_for(cache_pspecs(cache), mesh,
                                          rules), mesh))


@torch.no_grad()
def _place_leaves(tree, shardings) -> Dict[str, Any]:
    """``{key: placed leaf}`` for every leaf that has a sharding, one at a
    time, each source leaf dropped from ``tree`` once its blocks are built
    (a ParamTree's parameter set to None), so the peak is the tree plus
    one leaf."""
    sh = flat_tree(shardings)
    out = {}
    for box, name, key in list(leaf_slots(tree)):
        if key not in sh:
            continue
        leaf = box[name]
        out[key] = leaf if sh[key].holds(leaf) else sh[key].place(leaf)
        if isinstance(box, ParamTree):
            setattr(box, name, None)
        else:
            box[name] = None
        del leaf
    return out


def place_params(params, mesh: Mesh, rules: Rules) -> Dict[str, Any]:
    """A params tree laid out by its specs under ``rules`` (nested dicts:
    a split leaf a :class:`~repro_torch.distributed.compat.Sharded` of
    its blocks, each on its coordinate's device; an unsplit one a
    :class:`~repro_torch.distributed.compat.Replicated`), leaf by leaf:
    each whole leaf is dropped from ``params`` once it is placed."""
    sh = named_shardings(shardings_for(param_pspecs(params), mesh, rules),
                         mesh)
    return unflat_tree(_place_leaves(params, sh))


def place_cache(cache, mesh: Mesh, rules: Rules) -> dict:
    """A cache tree (``Model.init_cache``) laid out by its specs under
    ``rules``, in place, leaf by leaf (each whole leaf dropped once
    placed); the host-side entries (``filled``, ``enc_len``) stay."""
    sh = named_shardings(shardings_for(cache_pspecs(cache), mesh, rules),
                         mesh)
    placed = _place_leaves(cache, sh)
    for box, name, key in list(leaf_slots(cache)):
        if key in placed:
            box[name] = placed.pop(key)
    return cache


def place_batch(batch: dict, mesh: Mesh, rules: Rules) -> dict:
    """A batch's tensors laid out by :func:`batch_shardings` (the batch
    dim split over the batch axes where it divides)."""
    specs = batch_shardings(batch, mesh, rules)
    return {k: NamedSharding(mesh, specs[k]).place(v) if v.dim() else v
            for k, v in batch.items()}


def gather_to_host(tree) -> Dict[str, torch.Tensor]:
    """``{key: whole leaf on the host}`` of a placed tree (blocks
    concatenated in shard order, a replicated leaf's first copy)."""
    return {k: compat.host_copy(v) for k, v in flat_tree(tree).items()}
