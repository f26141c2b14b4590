"""Unified model API, ported from ``repro.models.model`` for serving.

``Model(cfg)`` binds a ModelConfig and exposes:

  init(seed, device)                    -> ParamTree of bf16 params
  init_cache(batch, cap, device, enc_cap) -> cache tree
  forward(params, batch, cache)         -> logits, cache, metrics
  prefill(params, cache, batch)         -> logits, cache
  decode_step(params, cache, tok, pos)  -> logits, cache

``batch`` is a dict holding ``tokens`` (B, S) int32; for a VLM config
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
Caches are written in place (``models/attention.py`` says why), so a
consumed cache is not a fresh one; over a stack with Mamba layers a step
restarts at position 0 or continues at the filled position, and never
rolls back (``models/transformer.py``).  ``forward``'s metrics are the reference's
(``aux_loss``, ``dropped``, and ``expert_counts`` (n_periods, E) for a
MoE config); ``prefill`` and ``decode_step`` discard them, as the
reference's do, and so skip the MoE load-balance loss.  A MoE layer
reads its group sizes on the host once per call.  Training (``loss``)
is not ported yet and raises.
"""
from __future__ import annotations

import operator

import torch

from .. import resolve_device
from .config import ModelConfig
from .encdec import encdec_forward, init_encdec, init_encdec_cache
from .params import ParamTree, tree_from_numpy
from .transformer import init_lm, init_lm_cache, lm_forward


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
             aux_loss: bool = True):
        cfg = self.cfg
        if cfg.encdec:
            frames = batch.get("frames")
            if frames is None and cache is None:
                raise ValueError(
                    f"{cfg.name}: a forward pass without a cache needs the "
                    f"encoder's frames")
            return encdec_forward(params, cfg, frames, batch["tokens"],
                                  start, cache=cache, aux_loss=aux_loss)
        return lm_forward(params, cfg, batch["tokens"], start, cache=cache,
                          media_embeds=batch.get("media"), aux_loss=aux_loss)

    def forward(self, params, batch, cache=None, remat: bool = False):
        return self._run(params, batch, cache)

    def loss(self, params, batch, remat: bool = True):
        raise NotImplementedError(
            "loss / cross_entropy (training) are not ported yet: ROADMAP "
            "Queue 1 item 10")

    @torch.no_grad()
    def prefill(self, params, cache, batch):
        logits, cache, _ = self._run(params, batch, cache, aux_loss=False)
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, pos):
        """tokens: (B, 1) int32; pos: the write index in the cache, a
        Python int (a tensor on the card would cost a host sync).  Raises
        on a ``pos`` past the cache's filled prefix."""
        logits, cache, _ = self._run(params, {"tokens": tokens}, cache,
                                     operator.index(pos), aux_loss=False)
        return logits, cache
