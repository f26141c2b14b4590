"""Step functions shared by the trainer and the serving runtime, ported
from ``repro.launch.steps``."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..models.model import Model
from ..models.params import flat_tree
from ..optim.adamw import AdamWConfig, adamw_update


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    microbatches: int = 1,
                    hot_experts: Optional[Sequence[int]] = None):
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
    was, and the step can be run again on the same batch."""
    hot = tuple(hot_experts) if hot_experts else None

    def grads_of(params, batch):
        params.zero_grad(set_to_none=True)
        loss, metrics = model.loss(params, batch, hot_experts=hot)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
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
                    gacc = {k: t.float() for k, t in g.items()}
                else:
                    for k, t in g.items():
                        gacc[k].add_(t)
                loss = loss + l
            grads = {k: t / microbatches for k, t in gacc.items()}
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


def make_prefill_step(model: Model):
    def prefill(params, cache, batch):
        return model.prefill(params, cache, batch)
    return prefill


def make_decode_step(model: Model):
    def decode(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)
    return decode
