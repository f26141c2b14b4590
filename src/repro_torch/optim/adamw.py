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

On a mesh (ZeRO), ``master``, ``m`` and ``v`` leaves are
:class:`~repro_torch.distributed.compat.Sharded` by their specs
(``distributed.sharding.train_state_shardings``), or
:class:`~repro_torch.distributed.compat.Replicated` where a spec splits
nothing: each block is updated on its own device, in place and chunked
as above, against the gradient's same block (a ``Sharded`` gradient cut
by the same specs, or a whole one cut here).  The gradient norm visits
every leaf's blocks in shard order and is summed once, so the clip is
one number for the whole tree; the new params are then gathered from
the blocks into the params' tensors in place.  The first write is then
the first block's, and a fault past it loses the step as before.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..distributed import compat
from ..distributed.compat import Replicated, Sharded, split_grid
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


def init_opt_state(params, shardings=None) -> dict:
    """``{"master", "m", "v", "step"}`` for a tree of params (a ParamTree
    or nested dicts): f32 copies and zeros on each leaf's device (on
    ``meta`` only shapes), step 0.  ``shardings`` (the ``"opt"`` part of
    ``distributed.sharding.train_state_shardings``): ``master``, ``m``
    and ``v`` are placed by it leaf by leaf, ``step`` on the mesh's home
    device.  On ``meta`` the step is a host scalar: the update reads it
    on the host, and a ``meta`` tensor has no value."""
    flat = {k: p.detach() for k, p in flat_tree(params).items()}
    dev = next(iter(flat.values())).device
    if shardings is not None:
        home = shardings["step"].mesh.home
        sh = flat_tree(shardings["master"])
        master = {k: sh[k].place(p, torch.float32) for k, p in flat.items()}
        return {
            "master": unflat_tree(master),
            "m": unflat_tree({k: _zeros_like(t) for k, t in master.items()}),
            "v": unflat_tree({k: _zeros_like(t) for k, t in master.items()}),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_step_device(home)),
        }
    return {
        "master": unflat_tree({k: p.to(torch.float32, copy=True)
                               for k, p in flat.items()}),
        "m": unflat_tree({k: torch.zeros_like(p, dtype=torch.float32)
                          for k, p in flat.items()}),
        "v": unflat_tree({k: torch.zeros_like(p, dtype=torch.float32)
                          for k, p in flat.items()}),
        "step": torch.zeros((), dtype=torch.int32, device=_step_device(dev)),
    }


def _step_device(dev) -> torch.device:
    dev = torch.device(dev)
    return torch.device("cpu") if dev.type == "meta" else dev


def _zeros_like(x):
    if isinstance(x, Sharded):
        out = []
        for t, c in zip(x.shards, x.block_coords()):
            with compat.at(c):
                out.append(torch.zeros_like(t))
        return x.like(out)
    if isinstance(x, Replicated):
        return Replicated({d: torch.zeros_like(t)
                           for d, t in x.copies.items()})
    return torch.zeros_like(x)


def _blocks(x) -> list:
    """A leaf's blocks in shard order: a Sharded's blocks, a Replicated's
    first copy, a tensor itself."""
    if isinstance(x, Sharded):
        return list(x.shards)
    if isinstance(x, Replicated):
        return [x.value]
    return [x]


def _coords(x) -> tuple:
    """The mesh coordinate of each of ``_blocks(x)`` (None: unknown),
    where a recorder counts the block's update."""
    if isinstance(x, Sharded):
        return x.block_coords()
    return (None,)


def _grad_blocks(g, like) -> list:
    """The gradient ``g`` (whole or Sharded) as blocks that line up with
    the state leaf ``like``'s."""
    if isinstance(like, Sharded):
        if not isinstance(g, Sharded):
            g = split_grid(g, like.dims, like.grid, like.devices)
        if g.grid != like.grid or g.dims != like.dims:
            raise ValueError(f"a gradient split {g.grid} over {g.dims} "
                             f"for a state split {like.grid} over "
                             f"{like.dims}")
        return list(g.shards)
    if isinstance(g, Sharded):
        g = g.gather(_blocks(like)[0].device)
    return [g]


def _sync_copies(x) -> None:
    """A Replicated state leaf's other copies set to its first."""
    if isinstance(x, Replicated):
        first = x.value
        for t in list(x.copies.values())[1:]:
            t.copy_(first)


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
    a layer, in the reference as here).  A sharded leaf's blocks are
    visited in shard order, their sums carried to the first block's
    device."""
    total = None
    for _, g in sorted(flat_tree(tree).items()):    # the reference's order
        for b, at in zip(_blocks(g), _coords(g)):   # then shard order
            with compat.at(at):
                for c in _chunks(b):
                    s = c.double().square().sum()
                    total = (s if total is None
                             else total + s.to(total.device))
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
            ma_leaf = flat_ma[key]
            blocks = zip(_grad_blocks(g, ma_leaf), _blocks(ma_leaf),
                         _blocks(flat_m[key]), _blocks(flat_v[key]),
                         _coords(ma_leaf))
            for gb, mab, mb, vb, at in blocks:
                with compat.at(at):
                    _update_block(cfg, gb, mab, mb, vb, scale, bc1, bc2,
                                  lr_f)
            for leaf in (ma_leaf, flat_m[key], flat_v[key]):
                _sync_copies(leaf)
            if flat_p is not None:
                _write_params(flat_p[key], ma_leaf)
        opt_state["step"].fill_(step)
    except Exception as e:              # noqa: BLE001 — re-raised as lost
        raise LostStepError(
            f"the optimizer failed after its first in-place write: {e}"
        ) from e
    if params is None:
        params = unflat_tree({k: _whole(flat_ma[k]).to(g.dtype, copy=True)
                              for k, g in flat_g.items()})
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def _update_block(cfg: AdamWConfig, gb, mab, mb, vb, scale, bc1: float,
                  bc2: float, lr_f: float) -> None:
    """One block's update in place, chunk by chunk."""
    sc = scale.to(mab.device)
    parts = zip(_chunks(gb), _chunks(mab), _chunks(mb), _chunks(vb))
    for gc, ma, m, v in parts:
        # the reference's operations, one rounding each
        gc = gc.float() * sc
        m.mul_(cfg.b1).add_(gc * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(gc.square_().mul_(1 - cfg.b2))
        denom = (v / bc2).sqrt_().add_(cfg.eps)
        upd = (m / bc1).div_(denom).add_(ma * cfg.weight_decay)
        ma.sub_(upd.mul_(lr_f))


def _whole(x) -> torch.Tensor:
    if isinstance(x, Sharded):
        return x.gather(x.devices[0])
    return _blocks(x)[0]


def _write_params(p: torch.Tensor, master) -> None:
    """The params' tensor ``p`` set from its master, cast to ``p``'s
    dtype: a Sharded master block by block into ``p``'s slices."""
    if isinstance(master, Sharded):
        for blk, sl in zip(master.shards, master.block_slices()):
            p[sl].copy_(blk)
    else:
        p.copy_(_blocks(master)[0])
