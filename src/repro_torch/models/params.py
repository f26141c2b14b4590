"""Parameter trees: an ``nn.Module`` indexed like the reference's dicts.

The reference keeps parameters as nested dicts of arrays (with logical
sharding axes beside them, which the single-device port does not need).
:class:`ParamTree` holds the same tree as a module — every leaf a frozen
``nn.Parameter``, every nested dict a ``ParamTree``, every list an
``nn.ModuleList`` — so ``.to(device)`` and ``state_dict`` work, while
model code keeps the reference's ``params["moe"]["w1"]`` indexing.
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
    return torch.from_numpy(np.array(tree)).to(device)


class Initializer:
    """Draws parameters from a seeded ``torch.Generator`` on ``device``.
    ``normal`` is N(0, 1) scaled by ``scale / sqrt(fan_in)``, fan_in
    defaulting to ``shape[-2]`` as in the reference.  The numbers differ
    from the reference's ``jax.random`` draws; tests carry the
    reference's weights across with :func:`tree_from_numpy` instead."""

    def __init__(self, seed: int, device, dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def normal(self, shape, scale: float = 1.0, fan_in: int = 0,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
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
