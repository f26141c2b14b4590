"""Step functions shared by the trainer and the serving runtime, ported
from ``repro.launch.steps``."""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from ..distributed import compat
from ..distributed.compat import Sharded
from ..distributed.meshctx import use_policy
from ..models.model import Model
from ..models.params import flat_tree
from ..optim.adamw import AdamWConfig, adamw_update


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    microbatches: int = 1,
                    hot_experts: Optional[Sequence[int]] = None,
                    grad_shardings=None, policy=None):
    """``train_step(state, batch) -> (state, metrics)`` over
    ``state = {"params": trainable ParamTree, "opt": {master, m, v,
    step}}``, the reference's step: the loss and its gradient
    (``Model.loss`` with remat, then ``backward``), AdamW, and the
    reference's metrics (``loss``, ``grad_norm``, ``lr`` and the MoE
    layers' ``aux_loss`` / ``dropped`` / ``expert_counts``).

    ``hot_experts`` fixes the MoE hot-expert plan of THIS step function
    (a tuple takes the branch-injected hot path, ``None`` or ``()`` the
    generic full dispatch).  It is passed down explicitly
    (``Model.loss`` -> ``lm_forward`` -> ``moe_ffn``): the reference
    installs it in a process-global around its trace, which the port,
    with no trace, does not need.

    ``microbatches`` > 1 accumulates the gradient over K sequential
    slices of the batch in f32 and averages it (the loss too; the MoE
    metrics are the last slice's).

    The state is updated in place (``optim/adamw.py``): the reference
    donates it to its step, and here it is consumed from the optimizer's
    first write, past which a fault raises ``LostStepError``.  A fault
    before it (in the forward or the backward) leaves the state as it
    was, and the step can be run again on the same batch.

    ``policy`` (a :class:`~repro_torch.distributed.meshctx.MeshPolicy`)
    runs the loss and its backward under that mesh's branches: the MoE
    layers through the expert-parallel ``moe_ffn_sharded`` (autograd
    runs back through ``compat``'s collectives), every other layer on
    the mesh's home device with the kernels it uses alone.

    ``grad_shardings`` (a params-shaped tree of
    :class:`~repro_torch.distributed.sharding.NamedSharding`, the
    ``master`` part of ``train_state_shardings``): right after the
    backward each gradient is cut into its spec's blocks, each on its
    coordinate's device, the counterpart of the reference's
    reduce-scatter, and the ZeRO-sliced optimizer updates each block
    where it lies.  With ``microbatches`` > 1 the f32 accumulator holds
    only those blocks: left whole, it would be the full gradient
    replicated on every microbatch (the reference measured 1.3 TB a
    device a step of all-reduce on phi3.5 at 4k, against ~84 GB of
    reduce-scatter with the accumulator sharded).  Without it the step
    is the single-device one."""
    hot = tuple(hot_experts) if hot_experts else None
    flat_sh = (flat_tree(grad_shardings) if grad_shardings is not None
               else None)

    def cut(key, g):
        if flat_sh is None or flat_sh[key].replicated:
            return g
        compat.record_collective("reduce-scatter", [g])
        return flat_sh[key].cut(g)

    def grads_of(params, batch):
        params.zero_grad(set_to_none=True)
        mesh = (use_policy(policy) if policy is not None
                else contextlib.nullcontext())
        with mesh:
            loss, metrics = model.loss(params, batch, hot_experts=hot)
            loss.backward()
        grads = {k: cut(k, p.grad if p.grad is not None
                        else torch.zeros_like(p))
                 for k, p in flat_tree(params).items()}
        return loss.detach(), metrics, grads

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            gacc, loss = None, 0.0
            for i in range(microbatches):
                def part(x):
                    n = x.shape[0] // microbatches
                    return x[i * n:(i + 1) * n]
                l, metrics, g = grads_of(params, {k: part(v) for k, v
                                                  in batch.items()})
                if gacc is None:
                    gacc = {k: _map_blocks(lambda t: t.float(), t)
                            for k, t in g.items()}
                else:
                    for k, t in g.items():
                        _add_blocks(gacc[k], t)
                loss = loss + l
            grads = {k: _map_blocks(lambda t: t / microbatches, t)
                     for k, t in gacc.items()}
            loss = loss / microbatches
        _, opt, opt_metrics = adamw_update(opt_cfg, grads, state["opt"],
                                           params=params)
        params.zero_grad(set_to_none=True)
        out = {"loss": loss, **opt_metrics}
        for k in ("aux_loss", "dropped", "expert_counts"):
            if k in metrics:
                out[k] = (metrics[k].detach()
                          if isinstance(metrics[k], torch.Tensor)
                          else metrics[k])
        return state, out

    return train_step


def _map_blocks(fn, x):
    """``fn`` of a tensor, or of each block of a Sharded gradient."""
    if isinstance(x, Sharded):
        out = []
        for t, c in zip(x.shards, x.block_coords()):
            with compat.at(c):
                out.append(fn(t))
        return x.like(out)
    return fn(x)


def _add_blocks(acc, x) -> None:
    if isinstance(acc, Sharded):
        for a, t, c in zip(acc.shards, x.shards, acc.block_coords()):
            with compat.at(c):
                a.add_(t)
    else:
        acc.add_(x)


def make_prefill_step(model: Model):
    def prefill(params, cache, batch):
        return model.prefill(params, cache, batch)
    return prefill


def make_decode_step(model: Model):
    def decode(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)
    return decode
