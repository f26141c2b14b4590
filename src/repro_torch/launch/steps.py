"""Step functions shared by the serving runtime, ported from
``repro.launch.steps``.  ``make_train_step`` waits for training (ROADMAP
Queue 1 item 10)."""
from __future__ import annotations

from ..models.model import Model


def make_prefill_step(model: Model):
    def prefill(params, cache, batch):
        return model.prefill(params, cache, batch)
    return prefill


def make_decode_step(model: Model):
    def decode(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)
    return decode
