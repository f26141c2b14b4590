"""Fault tolerance: failure injection and straggler mitigation.

Ported from ``repro.distributed.fault`` (host-only code, copied so the
port imports nothing of the reference).  On a real cluster these hooks
bind to the cluster manager (preemption notices, link errors, host
heartbeats); here they run against *simulated* events so the recovery
paths are exercised end to end:

  * ``FailureInjector`` — deterministic or probabilistic step failures.
    Its random draws come from ``np.random.default_rng(seed)`` exactly
    as the reference's do, so the same seed fails the same steps in
    either package.
  * ``StragglerMonitor`` — per-step wall-time tracking; a step slower
    than ``threshold x`` the rolling median marks the node suspect;
    after ``patience`` suspect steps the mitigation callback fires.
  * ``elastic_reshard`` — restore a checkpoint onto a resized mesh (a
    device lost, or grown back): ``checkpoint.restore`` with the new
    mesh's shardings.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


class SimulatedFailure(RuntimeError):
    pass


class SimulatedDeviceLoss(SimulatedFailure):
    """A device dropped out mid-step: the plane degrades to generic-only
    serving (``MorpheusRuntime.simulate_device_loss``)."""


class SimulatedCompileFailure(SimulatedFailure):
    """A recompile cycle 'failed' to build: injected into a recompile
    cycle to exercise the scheduler's backoff-retry / quarantine path."""


class LostStepError(RuntimeError):
    """A fault fired AFTER a step's inputs were consumed: the in-process
    fault boundary cannot retry, and the driver must restore the latest
    checkpoint and replay.  Raised by the optimizer's in-place update
    (``optim/adamw.py``) and passed on by the training supervisor."""


@dataclass
class FailureInjector:
    fail_at_step: Optional[int] = None
    fail_prob: float = 0.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._armed: list = []      # one-shot queued faults (arm_next)

    def arm_next(self, exc: Optional[BaseException] = None) -> None:
        """Queue a one-shot fault: the NEXT ``check`` call raises
        ``exc`` (default: a plain :class:`SimulatedFailure`), whatever
        the step number."""
        self._armed.append(exc if exc is not None
                           else SimulatedFailure("armed failure"))

    def check(self, step: int) -> None:
        if self._armed:
            raise self._armed.pop(0)
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise SimulatedFailure(f"injected failure at step {step}")
        if self.fail_prob and self._rng.random() < self.fail_prob:
            raise SimulatedFailure(f"random failure at step {step}")


@dataclass
class StragglerMonitor:
    threshold: float = 2.0
    patience: int = 3
    window: int = 32
    on_straggler: Optional[Callable[[int, float], None]] = None

    def __post_init__(self):
        self._times = deque(maxlen=self.window)
        self._suspect = 0
        self.events = []

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True when mitigation fired for this step."""
        fired = False
        if len(self._times) >= 8:
            med = float(np.median(self._times))
            if seconds > self.threshold * med:
                self._suspect += 1
                self.events.append((step, seconds, med))
                if self._suspect >= self.patience:
                    fired = True
                    self._suspect = 0
                    if self.on_straggler:
                        self.on_straggler(step, seconds)
            else:
                self._suspect = max(0, self._suspect - 1)
        self._times.append(seconds)
        return fired


def elastic_reshard(ckpt_dir: str, example_tree, new_shardings):
    """Resume a checkpoint onto a different mesh (fewer/more devices):
    the latest step restored into ``example_tree`` with every leaf laid
    out by ``new_shardings`` (``checkpoint.restore``)."""
    from ..checkpoint import restore
    return restore(ckpt_dir, None, example_tree, shardings=new_shardings)
