"""AdamW with f32 master weights, ported from ``repro.optim.adamw``.

State layout (``master``, ``m`` and ``v`` are trees keyed like the
params, as nested dicts):

  master: f32 copy of the params (the source of truth)
  m, v:   f32 first / second moments
  step:   scalar int32 tensor

The reference returns a new state and donates the old one.  Here
:func:`adamw_update` writes ``master``, ``m``, ``v``, ``step`` and the
params **in place**: at starcoder2-3b the f32 state alone is 36.4 GB, and
a functional copy of it does not fit beside the model on one 80 GB card.
The state is therefore consumed from the update's first write: a fault
past it raises :class:`~repro_torch.distributed.fault.LostStepError`
(the trainer restores a checkpoint), a fault before it leaves the state
as it was.  Each leaf is updated in chunks of ``CHUNK`` elements, so the
f32 temporaries stay at a few hundred MB whatever the leaf's size.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..distributed.fault import LostStepError
from ..models.params import flat_tree, unflat_tree

CHUNK = 1 << 26                    # elements a chunk of the update


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay, in f32 as the reference computes
    it; ``step`` an int or a tensor.  Returns a 0-d f32 tensor on the
    host (or on ``step``'s device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = t.clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> dict:
    """``{"master", "m", "v", "step"}`` for a tree of params (a ParamTree
    or nested dicts): f32 copies and zeros on each leaf's device (on
    ``meta`` only shapes), step 0."""
    flat = {k: p.detach() for k, p in flat_tree(params).items()}
    dev = next(iter(flat.values())).device
    return {
        "master": unflat_tree({k: p.to(torch.float32, copy=True)
                               for k, p in flat.items()}),
        "m": unflat_tree({k: torch.zeros_like(p, dtype=torch.float32)
                          for k, p in flat.items()}),
        "v": unflat_tree({k: torch.zeros_like(p, dtype=torch.float32)
                          for k, p in flat.items()}),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _chunks(t: torch.Tensor):
    flat = t.reshape(-1)
    for s in range(0, flat.numel(), CHUNK):
        yield flat[s:s + CHUNK]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (a 0-d f32 tensor on the
    leaves' device), chunk by chunk in a fixed order.  The squares and
    their sum are f64: the reference sums f32 squares, which overflow to
    inf once a gradient entry passes ~1.8e19 (or their sum 3.4e38), and
    its clip then zeroes the whole update.  starcoder2-3b at 30 layers
    with the reference's random init has such gradients (they grow ~2-3x
    a layer, in the reference as here)."""
    total = None
    for _, g in sorted(flat_tree(tree).items()):    # the reference's order
        for c in _chunks(g):
            s = c.double().square().sum()
            total = s if total is None else total + s
    return total.sqrt().float()


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params=None):
    """Returns ``(params, opt_state, metrics)``; ``opt_state`` is updated in
    place and returned.  ``params`` (a tree keyed like ``grads``): written
    in place, each leaf cast from its new master to its own dtype; without
    it new params are made, in each grad's dtype (bf16 weights stay bf16,
    f32 norm scales f32), as the reference returns them.  ``metrics``:
    ``grad_norm`` (device) and ``lr`` (host), as the reference's."""
    flat_g = flat_tree(grads)
    flat_ma = flat_tree(opt_state["master"])
    flat_m = flat_tree(opt_state["m"])
    flat_v = flat_tree(opt_state["v"])
    step = int(opt_state["step"]) + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = torch.tensor(step, dtype=torch.float32)
    bc1 = float(1 - torch.tensor(cfg.b1, dtype=torch.float32) ** stepf)
    bc2 = float(1 - torch.tensor(cfg.b2, dtype=torch.float32) ** stepf)
    lr_f = float(lr)
    flat_p = flat_tree(params) if params is not None else None
    try:
        for key, g in sorted(flat_g.items()):
            parts = zip(_chunks(g), _chunks(flat_ma[key]),
                        _chunks(flat_m[key]), _chunks(flat_v[key]))
            for gc, ma, m, v in parts:
                # the reference's operations, one rounding each
                gc = gc.float() * scale
                m.mul_(cfg.b1).add_(gc * (1 - cfg.b1))
                v.mul_(cfg.b2).add_(gc.square_().mul_(1 - cfg.b2))
                denom = (v / bc2).sqrt_().add_(cfg.eps)
                upd = (m / bc1).div_(denom).add_(ma * cfg.weight_decay)
                ma.sub_(upd.mul_(lr_f))
            if flat_p is not None:
                flat_p[key].copy_(flat_ma[key])
        opt_state["step"].fill_(step)
    except Exception as e:              # noqa: BLE001 — re-raised as lost
        raise LostStepError(
            f"the optimizer failed after its first in-place write: {e}"
        ) from e
    if params is None:
        params = unflat_tree({k: flat_ma[k].to(g.dtype, copy=True)
                              for k, g in flat_g.items()})
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
