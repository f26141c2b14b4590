"""Training-plane specialization plans and the traffic profile, ported
from ``repro.training.plan`` (host logic, copied as it stands).

The serving runtime keys executables by a version-free plan *signature*;
the training plane gets the same discipline: a :class:`TrainPlan` is the
constant set of one train-step executable — today the MoE hot-expert
tuple, ``None`` meaning the generic full dispatch — and its
``signature`` is the :class:`~repro_torch.core.execcache.ExecutableCache`
identity shared by every plan that builds the same step function.

:class:`TrainProfile` is the training-side traffic snapshot: router
expert counts accumulated since the last respecialization decision,
plus longer-horizon mixture statistics (EMA of the normalized expert
distribution, loss EMA).  It is **checkpoint-coupled**: the supervisor
serializes it into every checkpoint's meta and restores it on
``--resume``, so the respecialization decision sequence — a pure
function of (step, accumulated counts) — is reproduced bit-exactly
across a crash/resume boundary instead of restarting cold.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class TrainPlan:
    """One train-step specialization: ``hot`` is the MoE hot-expert
    tuple the step was built with (``None`` => the generic full
    dispatch — the resident deopt target)."""
    hot: Optional[Tuple[int, ...]] = None
    version: int = 0

    @property
    def specialized(self) -> bool:
        return self.hot is not None

    @property
    def signature(self) -> Tuple:
        """Executable identity: the step's constants only, no version —
        an oscillating hot set (A -> B -> A) re-uses A's executable."""
        if self.hot is None:
            return ("train", "generic")
        return ("train", "hot", tuple(self.hot))

    @property
    def label(self) -> str:
        if self.hot is None:
            return "generic"
        return f"specialized(hot={','.join(map(str, self.hot))})"


def plan_hot_experts(counts: np.ndarray, coverage: float
                     ) -> Optional[Tuple[int, ...]]:
    """The respecialization decision: the smallest heavy-hitter prefix
    covering ``coverage`` of routed tokens, ``None`` when that prefix
    is the whole expert set (no specialization win).  Deterministic in
    ``counts`` — ``np.argsort`` ties resolve identically on identical
    arrays, which the crash/resume bit-exactness contract relies on."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total <= 0:
        return None
    order = np.argsort(-counts, kind="stable")
    cum = np.cumsum(counts[order]) / total
    n_hot = int(np.searchsorted(cum, coverage) + 1)
    if n_hot >= counts.shape[0]:
        return None
    return tuple(sorted(int(e) for e in order[:n_hot]))


class TrainProfile:
    """Accumulated router/data-mixture statistics, checkpoint-coupled.

    ``counts_acc`` accumulates expert counts since the last decision
    boundary (reset by :meth:`decide`); ``mixture_ema``/``loss_ema``
    are long-horizon mixture stats carried for observability and for
    decisions that want smoothed traffic.  Integer counts serialize
    exactly; floats round-trip bitwise through JSON (``repr``-based)."""

    def __init__(self, num_experts: int, ema_alpha: float = 0.1):
        self.num_experts = int(num_experts)
        self.ema_alpha = float(ema_alpha)
        self.counts_acc = np.zeros(self.num_experts, np.int64)
        self.steps_acc = 0
        self.mixture_ema: Optional[List[float]] = None
        self.loss_ema: Optional[float] = None

    def observe(self, counts: np.ndarray,
                loss: Optional[float] = None) -> None:
        counts = np.asarray(counts, np.int64)
        self.counts_acc = self.counts_acc + counts
        self.steps_acc += 1
        total = int(counts.sum())
        if total > 0:
            mix = (counts / total).tolist()
            if self.mixture_ema is None:
                self.mixture_ema = mix
            else:
                a = self.ema_alpha
                self.mixture_ema = [
                    (1 - a) * old + a * new
                    for old, new in zip(self.mixture_ema, mix)]
        if loss is not None:
            self.loss_ema = (loss if self.loss_ema is None
                             else (1 - self.ema_alpha) * self.loss_ema
                             + self.ema_alpha * loss)

    def decide(self, coverage: float) -> Optional[Tuple[int, ...]]:
        """Consume the accumulated window: returns the hot-expert plan
        for the NEXT interval and resets the accumulator."""
        hot = plan_hot_experts(self.counts_acc, coverage)
        self.counts_acc = np.zeros(self.num_experts, np.int64)
        self.steps_acc = 0
        return hot

    # ---- checkpoint coupling ---------------------------------------------
    def to_meta(self) -> Dict[str, Any]:
        return {"num_experts": self.num_experts,
                "counts_acc": [int(c) for c in self.counts_acc],
                "steps_acc": self.steps_acc,
                "mixture_ema": self.mixture_ema,
                "loss_ema": self.loss_ema}

    def from_meta(self, meta: Optional[Dict[str, Any]]) -> None:
        if not meta:
            return
        counts = meta.get("counts_acc")
        if counts is not None and len(counts) == self.num_experts:
            self.counts_acc = np.asarray(counts, np.int64)
        self.steps_acc = int(meta.get("steps_acc", 0))
        self.mixture_ema = meta.get("mixture_ema")
        self.loss_ema = meta.get("loss_ema")
