"""Deterministic synthetic token pipeline, ported from
``repro.data.pipeline``.

Every batch is a pure function of (seed, step): resuming from a
checkpointed ``step`` reproduces the exact stream.  The draws are the
reference's own (``np.random.default_rng((seed, step))``, the same calls
in the same order), so the port's batches equal the reference's bit for
bit: tokens and labels int32, and for a VLM or an encoder-decoder config
media / frames in bf16 (float64 draws rounded through float32, as both
numpy's ``ml_dtypes`` and torch round them), as tensors on ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from .. import resolve_device


@dataclass
class DataConfig:
    vocab: int = 1024
    seq: int = 128
    global_batch: int = 8
    seed: int = 0
    zipf_a: float = 1.2
    media_tokens: int = 0
    d_model: int = 0
    enc_seq: int = 0


class TokenPipeline:
    """state = {"step": int}; fully deterministic given (cfg, step).
    Batches land on ``device`` (the card unless the caller asks for
    another)."""

    def __init__(self, cfg: DataConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step = 0
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._probs = (p / p.sum()).astype(np.float64)

    # ---- checkpointable state -------------------------------------------
    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, state: Dict) -> None:
        assert state["seed"] == self.cfg.seed, "stream seed mismatch"
        self.step = int(state["step"])

    # ---- batch generation -------------------------------------------------
    def _bf16(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.float32)).to(
            device=self.device, dtype=torch.bfloat16)

    def next_batch(self) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, self.step))
        self.step += 1
        toks = rng.choice(cfg.vocab, p=self._probs,
                          size=(cfg.global_batch, cfg.seq + 1))
        toks = torch.from_numpy(toks.astype(np.int32))
        batch = {"tokens": toks[:, :-1].contiguous().to(self.device),
                 "labels": toks[:, 1:].contiguous().to(self.device)}
        if cfg.media_tokens:
            batch["media"] = self._bf16(rng.standard_normal(
                (cfg.global_batch, cfg.media_tokens, cfg.d_model)))
        if cfg.enc_seq:
            batch["frames"] = self._bf16(rng.standard_normal(
                (cfg.global_batch, cfg.enc_seq, cfg.d_model)))
        return batch

    def peek_batch(self) -> Dict[str, torch.Tensor]:
        """The batch ``next_batch`` would return, WITHOUT advancing the
        stream (the trainer keys its step functions by its shapes)."""
        step = self.step
        try:
            return self.next_batch()
        finally:
            self.step = step

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.next_batch()
