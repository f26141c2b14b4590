"""Assigned input shapes and ``meta`` input specs.

Ported from ``repro.configs.shapes``.  Four shapes per LM architecture:

  train_4k     seq_len=4096    global_batch=256   runs train_step
  prefill_32k  seq_len=32768   global_batch=32    runs prefill
  decode_32k   seq_len=32768   global_batch=128   runs decode_step
  long_500k    seq_len=524288  global_batch=1     runs decode_step

``long_500k`` requires sub-quadratic sequence state and therefore only runs
for the SSM/hybrid families (mamba2, jamba); full-attention archs skip it.
``decode_*`` run a single new token against a KV/SSM state of ``seq_len``.

Modality frontends are stubs: ``batch_specs`` emits precomputed
patch/frame embeddings for [vlm]/[audio] archs.  A ``meta`` tensor plays
the part of the reference's ``jax.ShapeDtypeStruct``: a shape and a dtype,
and no memory.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..models.config import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applies(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the (arch, shape) cell runs; else a skip reason (the
    reference's words)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return ("full-attention architecture: 500k-token decode state is "
                "attention-dominated/quadratic-history; skipped per "
                "assignment rule (see DESIGN.md §Arch-applicability)")
    return None


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec,
                batch_override: Optional[int] = None,
                seq_override: Optional[int] = None) -> Dict:
    """``meta`` stand-ins for the *data* inputs of the step function
    selected by ``shape.kind`` (the reference's keys, shapes and dtypes;
    no memory)."""
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len

    if shape.kind in ("train", "prefill"):
        s_text = S - cfg.num_media_tokens
        batch = {"tokens": _sds((B, s_text), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = _sds((B, s_text), torch.int32)
        if cfg.num_media_tokens:
            batch["media"] = _sds((B, cfg.num_media_tokens, cfg.d_model),
                                  torch.bfloat16)
        if cfg.encdec:
            batch["frames"] = _sds((B, S // cfg.enc_seq_divisor, cfg.d_model),
                                   torch.bfloat16)
        return batch

    # decode: one new token against a seq_len-deep state
    return {"tokens": _sds((B, 1), torch.int32),
            "pos": _sds((), torch.int32)}


def cache_dims(cfg: ModelConfig, shape: ShapeSpec,
               batch_override: Optional[int] = None):
    B = batch_override or shape.global_batch
    cap = shape.seq_len
    enc_cap = shape.seq_len // cfg.enc_seq_divisor if cfg.encdec else 0
    return B, cap, enc_cap
