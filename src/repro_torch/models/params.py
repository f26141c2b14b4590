"""Parameter trees: an ``nn.Module`` indexed like the reference's dicts.

The reference keeps parameters as nested dicts of arrays (with logical
sharding axes beside them, which the single-device port does not need).
:class:`ParamTree` holds the same tree as a module — every leaf a frozen
``nn.Parameter``, every nested dict a ``ParamTree``, every list an
``nn.ModuleList`` — so ``.to(device)`` and ``state_dict`` work, while
model code keeps the reference's ``params["moe"]["w1"]`` indexing.
:func:`trainable` unfreezes a tree for training.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn


class ParamTree(nn.Module):
    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(ParamTree(x) for x in v))
            else:
                self.register_parameter(
                    k, nn.Parameter(torch.as_tensor(v), requires_grad=False))

    def __getitem__(self, k: str):
        return getattr(self, k)

    def __contains__(self, k: str) -> bool:
        return k in self._parameters or k in self._modules

    def get(self, k: str, default=None):
        return self[k] if k in self else default


def tree_from_numpy(tree, device) -> Any:
    """A nested dict/list of numpy arrays as tensors on ``device``
    (copied), in the same structure."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device) for v in tree]
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: through
        # float32, which holds every bfloat16 value exactly
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


class Initializer:
    """Draws parameters from a seeded ``torch.Generator`` on ``device``.
    ``normal`` is N(0, 1) scaled by ``scale / sqrt(fan_in)``, fan_in
    defaulting to ``shape[-2]`` as in the reference.  The numbers differ
    from the reference's ``jax.random`` draws; tests carry the
    reference's weights across with :func:`tree_from_numpy` instead.
    On the ``meta`` device it draws nothing and allocates nothing (the
    reference's ``abstract=True``: shapes for counting parameters)."""

    def __init__(self, seed: int, device, dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = (None if self.device.type == "meta" else
                    torch.Generator(device=self.device).manual_seed(seed))

    def normal(self, shape, scale: float = 1.0, fan_in: int = 0,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if self.gen is None:
            return torch.empty(tuple(shape), dtype=dtype or self.dtype,
                               device=self.device)
        fan = fan_in or (shape[-2] if len(shape) >= 2 else shape[-1])
        v = torch.randn(tuple(shape), generator=self.gen,
                        dtype=dtype or self.dtype, device=self.device)
        return v.mul_(scale / (fan ** 0.5))

    def zeros(self, shape, dtype: Optional[torch.dtype] = None):
        return torch.zeros(tuple(shape), dtype=dtype or self.dtype,
                           device=self.device)

    def ones(self, shape, dtype: Optional[torch.dtype] = None):
        return torch.ones(tuple(shape), dtype=dtype or self.dtype,
                          device=self.device)

    def constant(self, value, dtype: Optional[torch.dtype] = None):
        """``value`` (array-like) as a tensor on the device, in ``dtype``
        or the value's own type; draws nothing."""
        return torch.as_tensor(np.asarray(value), dtype=dtype,
                               device=self.device).clone()


def stack_pspecs(trees):
    """Stack a list of structurally identical trees (nested dicts of
    tensors) along a new leading "layers" axis, as the reference stacks
    its per-period PSpec trees into ``(n_periods, ...)``."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: stack_pspecs([t[k] for t in trees]) for k in t0}
    return torch.stack(trees)


def stack_draws(draw, n: int):
    """What ``stack_pspecs([draw() for _ in range(n)])`` gives, drawn in
    the same order, with one drawn tree alive beside the stack at a time
    (the list would hold every tree twice at the end)."""
    first = draw()

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((n,) + tuple(t.shape))

    def put(out, t, i):
        if isinstance(t, dict):
            for k, v in t.items():
                put(out[k], v, i)
        else:
            out[i].copy_(t)

    out = alloc(first)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, draw(), i)
    return out


def trainable(params: ParamTree) -> ParamTree:
    """Make every floating-point leaf of ``params`` require grad, in place,
    and return it: the trainer's tree (the serving path's leaves stay
    frozen, so its calls record no graph and take the plain kernel
    launches)."""
    for p in params.parameters():
        if p.is_floating_point():
            p.requires_grad_(True)
    return params


def _children(tree):
    if isinstance(tree, ParamTree):
        return list(tree._parameters.items()) + list(tree._modules.items())
    if isinstance(tree, nn.ModuleList):
        return [(str(i), m) for i, m in enumerate(tree)]
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def unbind_tree(tree, n: int):
    """The ``n`` entries of a stacked tree as ``n`` trees of views, one
    ``unbind`` a leaf: under autograd each leaf's gradient is then stacked
    once, where indexing entry ``i`` of the stack for each of ``n`` layers
    would add a zero-filled stack-sized gradient per layer."""
    kids = _children(tree)
    if kids is None:
        return list(tree.unbind(0))
    subs = {k: unbind_tree(v, n) for k, v in kids}
    return [{k: v[i] for k, v in subs.items()} for i in range(n)]


def flat_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` over a tree of dicts, lists and ParamTrees: the
    reference's checkpoint keys (its path entries joined by ``/``)."""
    kids = _children(tree)
    if kids is None:
        return {prefix[:-1]: tree}
    out: Dict[str, Any] = {}
    for k, v in kids:
        out.update(flat_tree(v, f"{prefix}{k}/"))
    return out


def leaf_slots(tree, prefix: str = ""):
    """``(container, name, key)`` for every leaf of a tree of dicts,
    lists and ParamTrees, in :func:`flat_tree` order: the leaf is
    ``container[name]`` (a ParamTree's, ``getattr``; a parameter, to be
    written in place only), and a dict's or list's may be replaced."""
    if isinstance(tree, ParamTree):
        for k in tree._parameters:
            yield tree, k, prefix + k
        for k, m in tree._modules.items():
            yield from leaf_slots(m, f"{prefix}{k}/")
        return
    for k, v in _children(tree):
        if _children(v) is None:
            yield tree, (int(k) if isinstance(tree, list) else k), \
                prefix + k
        else:
            yield from leaf_slots(v, f"{prefix}{k}/")


def unflat_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dicts from :func:`flat_tree`'s keys."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[last] = v
    return out


def index_tree(tree, i: int):
    """Entry ``i`` of every leaf of a stacked tree (views, no copies)."""
    if isinstance(tree, (dict, ParamTree)):
        keys = (tree.keys() if isinstance(tree, dict) else
                list(tree._parameters) + list(tree._modules))
        return {k: index_tree(tree[k], i) for k in keys}
    return tree[i]


def param_count(params) -> int:
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return params.numel()
