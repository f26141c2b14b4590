"""Adaptive sampling scheduler — per-plane instrumentation duty cycle.

The paper's adaptive instrumentation (§4.2/§6.2) has two regimes: while
the traffic profile is still moving, the data plane samples the
*instrumented* twin frequently to track it; once the specialization has
converged, instrumentation is pure overhead and Morpheus backs it off.
:class:`PlaneSampling` is that state machine, one instance per data
plane, driven by the **plan-churn rate** the controller observes — not by
raw traffic, which the sketches already summarize:

    ARMED    every recompile cycle compares the freshly planned
             signature with the previous cycle's.  Unchanged plans
             double ``sample_every`` (halve the duty cycle, up to
             ``max_every``); a changed plan halves it (down to
             ``min_every``).  This is the cadence half of the machine.
    DISARMED after ``disarm_after`` *consecutive* stable cycles the
             plane's instrumented twin is swapped out entirely: the
             controller plans with an empty instrumented-site set, so the
             next swap installs executables whose PlaneState carries no
             sketches at all — duty cycle 0, zero instrumentation cost
             on every step, and the plan keeps being rebuilt from the
             last sketch snapshot taken while armed.
    re-ARM   any control-plane update (table write, feature flip)
             re-arms the plane: the specialization basis moved, so the
             traffic profile must be re-measured.  The previously
             compiled instrumented twins are still in the
             ExecutableCache, so re-arming swaps back without paying t2.

``pin(every)`` freezes the cadence (min = max = ``every``) and disables
disarming — benchmarks that need identical instrumentation per repeated
phase use it instead of fighting the adaptation.

Mutation discipline: the writers — ``observe_cycle`` (the plane's
recompile cycle), ``rearm`` (any control-update thread) and ``pin`` —
serialize on one internal lock, so a ``rearm`` racing an
``observe_cycle`` can never be swallowed by the latter's
read-modify-write (a lost re-arm would leave a plane disarmed while its
specialization basis moved).  ``should_sample`` / ``duty_cycle`` read
single ints/bools locklessly: a racy read at worst samples one step
early or late.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

from ..instrument import SketchConfig


@dataclass
class SamplingConfig:
    """Controller-level knobs of the per-plane sampling state machine."""
    min_every: int = 2         # fastest cadence under churn
    max_every: int = 64        # slowest cadence while armed
    disarm_after: Optional[int] = 4   # consecutive stable cycles before
                                      # the instrumented twin is swapped
                                      # out (None: never disarm)


class PlaneSampling:
    """Sampling state of ONE data plane (see module docstring).

    ``sample_every`` starts at the plane's ``SketchConfig.sample_every``
    and adapts between ``min_every`` and ``max_every``; ``armed`` is the
    DISARMED latch.  The runtime consults :meth:`should_sample` on every
    step and the controller drives :meth:`observe_cycle` /
    :meth:`rearm`.
    """

    def __init__(self, sketch: SketchConfig,
                 cfg: Optional[SamplingConfig] = None):
        cfg = cfg or SamplingConfig()
        self.min_every = cfg.min_every
        self.max_every = cfg.max_every
        self.disarm_after = cfg.disarm_after
        self._initial = sketch.sample_every
        self.sample_every = sketch.sample_every
        self.armed = True
        self.stable_cycles = 0
        self.cycles = 0
        self.disarms = 0
        self.rearms = 0
        self._last_signature: Optional[Any] = None
        self._mu = threading.Lock()

    # ---- data-plane side --------------------------------------------------
    def should_sample(self, step: int) -> bool:
        """Route this step to the instrumented twin?  Always False while
        disarmed (the twin is not even installed then)."""
        return self.armed and step % self.sample_every == 0

    def window_every(self, k: int) -> int:
        """The window-granular cadence for fused K-step execution: one
        sampled window per ``sample_every`` *windows*.  A sampled window
        instruments all K of its steps, so this cadence preserves both
        the per-*step* duty cycle the machine converged to
        (K / (sample_every x K) = 1/sample_every) and the average sketch
        data rate (K steps of keys per sample_every x K steps) —
        dividing by K instead would instrument K times more steps than
        the adaptive machine decided to pay for."""
        del k                               # duty is a step fraction —
        return max(self.sample_every, 1)    # cadence is K-independent

    def should_sample_window(self, window: int, k: int) -> bool:
        """Route this fused K-step window to the instrumented twin?
        The window-granular twin of :meth:`should_sample` — the whole
        window runs instrumented or none of it does (the sampling
        decision is hoisted out of the ``lax.scan``, like the program
        guard).  Always False while disarmed."""
        return self.armed and window % self.window_every(k) == 0

    def duty_cycle(self) -> float:
        """Fraction of steps paying instrumentation cost (0 disarmed)."""
        return 0.0 if not self.armed else 1.0 / max(self.sample_every, 1)

    # ---- controller side --------------------------------------------------
    def observe_cycle(self, signature: Any) -> None:
        """Feed one recompile cycle's freshly *planned* signature: equal
        to the previous cycle's means the specialization has converged
        (back off, eventually disarm); different means churn (speed
        up)."""
        with self._mu:
            self.cycles += 1
            if signature == self._last_signature:
                self.stable_cycles += 1
                self.sample_every = min(self.sample_every * 2,
                                        self.max_every)
                if (self.armed and self.disarm_after is not None
                        and self.stable_cycles >= self.disarm_after):
                    self.armed = False
                    self.disarms += 1
            else:
                self.stable_cycles = 0
                self.sample_every = max(self.min_every,
                                        self.sample_every // 2)
            self._last_signature = signature

    def rearm(self) -> None:
        """Control-plane update: the specialization basis moved — resume
        sampling at the configured cadence and restart the stability
        count.  Idempotent; cheap enough to call on every update."""
        with self._mu:
            if not self.armed:
                self.rearms += 1
                self.armed = True
            self.stable_cycles = 0
            self.sample_every = max(self.min_every,
                                    min(self._initial, self.max_every))

    def pin(self, every: int) -> None:
        """Freeze the cadence at ``every`` and never disarm — for
        benchmarks that need identical instrumentation per phase."""
        with self._mu:
            self.min_every = self.max_every = self.sample_every = every
            self._initial = every
            self.disarm_after = None
            self.armed = True
            self.stable_cycles = 0

    def state(self) -> Dict[str, Any]:
        """Introspection snapshot (controller ``stats()``)."""
        return {"armed": self.armed, "sample_every": self.sample_every,
                "duty_cycle": self.duty_cycle(),
                "stable_cycles": self.stable_cycles,
                "cycles": self.cycles, "disarms": self.disarms,
                "rearms": self.rearms}
