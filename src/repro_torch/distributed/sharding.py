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
split on ``"data"``); the expert-parallel MoE and the sequence-parallel
decode split their operands by hand.  Dense weights and activations are
not partitioned (there is no SPMD partitioner): :func:`tree_device_bytes`
reports the per-device bytes the rules *would* give, the figure the
reference's dry run plans memory with.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

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
