"""Common layers the serving data plane uses."""
from __future__ import annotations

import torch


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dtype)
