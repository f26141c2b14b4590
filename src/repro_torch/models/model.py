"""Unified model API, ported from ``repro.models.model`` for serving.

``Model(cfg)`` binds a ModelConfig and exposes:

  init(seed, device)                    -> ParamTree of bf16 params
  init_cache(batch, cap, device, enc_cap) -> cache tree
  forward(params, batch, cache)         -> logits, cache, metrics
  loss(params, batch)                   -> scalar loss, metrics (train)
  prefill(params, cache, batch)         -> logits, cache
  decode_step(params, cache, tok, pos)  -> logits, cache

``batch`` is a dict holding ``tokens`` (B, S) int32 (and ``labels``
(B, S_text) for ``loss``); for a VLM config
(pixtral) ``media`` (B, S_media, D), the stub frontend's embeddings,
which ``forward`` and ``prefill`` put before the tokens' (positions
0..S_media-1; the logits cover them too, and a decode step after such a
prefill is at ``pos`` = S_media + S); and for an
encoder-decoder config (``cfg.encdec``: seamless), ``frames``
(B, S_enc, D), the stub frontend's embeddings.  Such a config takes the
branches of ``models/encdec.py``: ``forward`` and ``prefill`` with
frames run the encoder and write each cross-attention layer's
projection into the cache's ``enc_cap`` slots; ``decode_step`` reads
them; ``forward`` with neither frames nor a cache raises
``ValueError``, as do a decode before any frames and frames past
``enc_cap`` (``models/transformer.py``).  Its encoder raises
``TypeError`` on params that are not bf16, as the reference's scan does.
Entry points run on ``device="cuda"`` unless the caller passes another
device; every GQA self-attention call of prefill and decode, an
encoder layer's and a cross-attention layer's included, goes through
``kernels.ops.flash_attention`` and every Mamba layer's prefill through
``kernels.ops.ssd_scan`` (the CUDA kernels on the card; a Mamba decode
step is a plain single-token update).  An MLA layer (deepseek-v2)
attends in plain PyTorch, the reference's blocked loop
(``models/attention.py::mla_forward``), and launches no kernel.
Under a policy with rules (``distributed/meshctx.py``), a stack whose
every layer is GQA attention with a dense or MoE FFN (llama3-8b,
starcoder2-3b, gemma2-9b, deepseek-7b, pixtral-12b, phi3.5-MoE) runs
``prefill`` and ``decode_step`` partitioned over the mesh, on params and
a cache placed by ``distributed.sharding.place_params`` /
``place_cache`` (a leaf placed otherwise raises; the batch may come
whole or placed by ``place_batch``): the logits then come back as a
``compat.Sharded`` split over (batch rows, vocab), and :func:`greedy`
picks from it without gathering it; the metrics are the home layout's,
on the mesh's home device.
Caches are written in place (``models/attention.py`` says why), so a
consumed cache is not a fresh one; over a stack with Mamba layers a step
restarts at position 0 or continues at the filled position, and never
rolls back (``models/transformer.py``).  ``forward``'s metrics are the reference's
(``aux_loss``, ``dropped``, and ``expert_counts`` (n_periods, E) for a
MoE config); ``prefill`` and ``decode_step`` discard them, as the
reference's do, and so skip the MoE load-balance loss, unless called
with ``with_metrics=True`` (the controller's hot-expert planning reads
the counts).  A MoE layer reads its group sizes on the host once per
call (once per token shard on a mesh).

Training: ``forward`` and ``loss`` run with autograd as the caller has
it (the trainer's params are ``params.trainable``); ``loss`` is the
reference's: the mean cross entropy over the text positions (a VLM's
media positions are cut from the logits first, padded vocab columns are
left out) plus ``router_aux_weight`` times the MoE load-balance loss,
with ``remat`` on by default and ``hot_experts`` passed down to the MoE
layers' hot-expert branch.  On the card every GQA attention call then
goes through the ``flash_attention`` kernel's autograd function, whose
backward is the ``flash_attention_bwd`` kernel; a Mamba layer's
``ssd_scan`` kernel has no backward yet, and training a Mamba stack on
the card raises (``kernels/ops.py``).  ``prefill`` and ``decode_step``
run under ``torch.no_grad()``.
"""
from __future__ import annotations

import operator
from typing import Optional

import torch

from .. import resolve_device
from ..distributed.compat import Sharded
from .config import ModelConfig
from .encdec import encdec_forward, init_encdec, init_encdec_cache
from .params import ParamTree, tree_from_numpy
from .transformer import init_lm, init_lm_cache, lm_forward


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  n_valid: Optional[int] = None) -> torch.Tensor:
    """Stable softmax CE in f32, the mean over (B, S).  logits (B, S, V)
    any float dtype, labels (B, S).  ``n_valid``: the real vocab entries;
    the padded columns past it are left out (the reference masks them to
    -1e30, which adds exp(-1e30 - max) = 0 to every row's sum).  The
    reference's per-token ``mask`` has no caller and is not ported."""
    logits = logits.float()
    if n_valid is not None and n_valid < logits.shape[-1]:
        logits = logits[..., :n_valid]
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def params_from_numpy(tree, device="cuda") -> ParamTree:
    """The reference's Model params as the port's tree: ``tree`` is
    ``jax.tree.map(np.asarray, unzip(model.init(key))[0])``, nested dicts
    of numpy arrays (bf16 leaves as ``ml_dtypes.bfloat16``, carried
    across exactly through float32; f32 leaves, such as a bf16 model's
    MoE router or a Mamba layer's ``A_log``, ``D``, ``dt_bias`` and
    ``norm_scale``, stay f32).  Every subtree crosses as it stands: an
    MLA layer's ``wq``, ``w_dkv``, ``w_krope``, ``w_uk``, ``w_uv`` and
    ``wo``, the unrolled dense prefix layers ``prefix{i}``, a MoE
    layer's ``shared`` FFN, and an encoder-decoder config's ``encoder``
    (its stacked ``blocks`` and ``final_norm``) and ``decoder`` (the
    decoder-only tree, each layer's ``cross_norm`` and ``cross``
    beside its self-attention)."""
    return ParamTree(tree_from_numpy(tree, resolve_device(device)))


def greedy(logits) -> torch.Tensor:
    """The last position's argmax, (B, 1) int32 on the first block's
    device.  Logits split over the vocab (a ``compat.Sharded`` of the
    tensor-parallel layout, blocks over (batch rows, vocab)) take each
    block's max and pick across the vocab blocks in order, a later block
    only where it is strictly greater: the whole argmax (the first
    maximal index), without gathering the logits."""
    if not isinstance(logits, Sharded):
        return logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    R, V = logits.grid
    home = logits.shards[0].device
    rows = []
    for r in range(R):
        best = idx = None
        off = 0
        for j in range(V):
            blk = logits.shards[r * V + j][:, -1]
            i = blk.argmax(-1)
            val = blk.gather(-1, i[:, None])[:, 0].to(home)
            i = i.to(home) + off
            if best is None:
                best, idx = val, i
            else:
                take = val > best
                best, idx = torch.where(take, val, best), torch.where(
                    take, i, idx)
            off += blk.shape[-1]
        rows.append(idx)
    return torch.cat(rows).to(torch.int32)[:, None]


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ---- init ------------------------------------------------------------
    def init(self, seed: int = 0, device="cuda") -> ParamTree:
        """bf16 params drawn from ``seed`` on ``device``; on ``"meta"``
        only shapes (the reference's ``abstract=True``)."""
        if torch.device(device).type != "meta":
            device = resolve_device(device)
        if self.cfg.encdec:
            return init_encdec(seed, self.cfg, device)
        return init_lm(seed, self.cfg, device)

    def init_cache(self, batch: int, cap: int, device="cuda",
                   enc_cap: int = 0):
        """``enc_cap``: an encoder-decoder config's cross-attention slots
        (the frames a prefill may bring)."""
        device = resolve_device(device)
        if self.cfg.encdec:
            return init_encdec_cache(self.cfg, batch, cap, enc_cap, device)
        return init_lm_cache(self.cfg, batch, cap, device)

    # ---- forward paths ---------------------------------------------------
    def _run(self, params, batch, cache, start: int = 0,
             aux_loss: bool = True, remat: bool = False, hot_experts=None):
        cfg = self.cfg
        kw = dict(cache=cache, aux_loss=aux_loss, remat=remat,
                  hot_experts=hot_experts)
        if cfg.encdec:
            frames = batch.get("frames")
            if frames is None and cache is None:
                raise ValueError(
                    f"{cfg.name}: a forward pass without a cache needs the "
                    f"encoder's frames")
            return encdec_forward(params, cfg, frames, batch["tokens"],
                                  start, **kw)
        return lm_forward(params, cfg, batch["tokens"], start,
                          media_embeds=batch.get("media"), **kw)

    def forward(self, params, batch, cache=None, remat: bool = False,
                hot_experts=None):
        return self._run(params, batch, cache, remat=remat,
                         hot_experts=hot_experts)

    def loss(self, params, batch, remat: bool = True, hot_experts=None):
        """(scalar f32 loss, metrics): the reference's ``Model.loss``
        (``metrics["ce_loss"]`` is the total, as there)."""
        cfg = self.cfg
        logits, _, metrics = self.forward(params, batch, remat=remat,
                                          hot_experts=hot_experts)
        if cfg.num_media_tokens and "media" in batch:
            logits = logits[:, batch["media"].shape[1]:, :]
        loss = cross_entropy(logits, batch["labels"], n_valid=cfg.vocab)
        if cfg.moe is not None:
            loss = loss + cfg.moe.router_aux_weight * metrics["aux_loss"]
        return loss, {**metrics, "ce_loss": loss}

    @torch.no_grad()
    def prefill(self, params, cache, batch, with_metrics: bool = False):
        """(logits, cache), as the reference's; ``with_metrics``: (logits,
        cache, metrics), the metrics of :meth:`forward` (the MoE layers'
        load-balance loss computed)."""
        logits, cache, metrics = self._run(params, batch, cache,
                                           aux_loss=with_metrics)
        return (logits, cache, metrics) if with_metrics else (logits, cache)

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, pos,
                    with_metrics: bool = False):
        """tokens: (B, 1) int32; pos: the write index in the cache, a
        Python int (a tensor on the card would cost a host sync).  Raises
        on a ``pos`` past the cache's filled prefix.  ``with_metrics`` as
        :meth:`prefill`'s."""
        logits, cache, metrics = self._run(
            params, {"tokens": tokens}, cache, operator.index(pos),
            aux_loss=with_metrics)
        return (logits, cache, metrics) if with_metrics else (logits, cache)
