"""The port's fault-tolerance primitives (``repro_torch.distributed.fault``)
against the reference's: the injector's one-shot ``arm_next`` queue,
seeded probabilistic failures (the same seed fails the same steps in
either package), the straggler monitor's warmup / suspect-decay / window
semantics, and the exception hierarchy the runtime's fault boundary
dispatches on.  ``elastic_reshard`` is not ported (it needs the
checkpoint module and a mesh)."""
import pytest

from repro.distributed import fault as J
from repro_torch.distributed.fault import (FailureInjector,
                                           LostStepError,
                                           SimulatedCompileFailure,
                                           SimulatedDeviceLoss,
                                           SimulatedFailure,
                                           StragglerMonitor)


# ---------------------------------------------------------------------------
# FailureInjector
# ---------------------------------------------------------------------------

def test_exception_hierarchy_dispatches_device_loss():
    assert issubclass(SimulatedDeviceLoss, SimulatedFailure)
    assert issubclass(SimulatedCompileFailure, SimulatedFailure)
    assert issubclass(SimulatedFailure, RuntimeError)
    assert issubclass(LostStepError, RuntimeError)
    assert not issubclass(LostStepError, SimulatedFailure)


def test_arm_next_fires_once_in_fifo_order():
    inj = FailureInjector()
    inj.check(0)                         # nothing armed: quiet
    inj.arm_next(SimulatedDeviceLoss("first"))
    inj.arm_next()                       # default SimulatedFailure
    with pytest.raises(SimulatedDeviceLoss, match="first"):
        inj.check(1)
    with pytest.raises(SimulatedFailure, match="armed failure"):
        inj.check(1)                     # same step: queue, not step no.
    inj.check(2)                         # drained: quiet again


def test_arm_next_takes_precedence_over_step_numbered_fault():
    inj = FailureInjector(fail_at_step=4)
    inj.arm_next(SimulatedCompileFailure("armed"))
    with pytest.raises(SimulatedCompileFailure):
        inj.check(4)                     # armed fault fires first
    with pytest.raises(SimulatedFailure, match="step 4"):
        inj.check(4)                     # then the step-numbered one


def _fail_steps(cls, seed, prob=0.3, n=200):
    inj = cls(fail_prob=prob, seed=seed)
    hit = []
    for s in range(n):
        try:
            inj.check(s)
        except Exception as e:
            hit.append((s, str(e)))
    return hit


def test_probabilistic_failures_are_seed_deterministic():
    a, b = _fail_steps(FailureInjector, 7), _fail_steps(FailureInjector, 7)
    assert a == b and len(a) > 20        # same seed => same trace
    assert _fail_steps(FailureInjector, 8) != a


@pytest.mark.parametrize("seed,prob", [(0, 0.05), (7, 0.3), (123, 0.5)])
def test_probabilistic_failures_equal_the_reference(seed, prob):
    """The same seed fails the same steps, with the same messages, in
    either package (both draw from ``np.random.default_rng(seed)``)."""
    assert _fail_steps(FailureInjector, seed, prob) == \
        _fail_steps(J.FailureInjector, seed, prob)


# ---------------------------------------------------------------------------
# StragglerMonitor
# ---------------------------------------------------------------------------

def test_straggler_needs_warmup_samples():
    mon = StragglerMonitor(threshold=2.0, patience=1)
    for s in range(7):                   # < 8 samples: no median yet
        assert not mon.observe(s, 10.0)
    assert mon.events == []


def test_straggler_patience_and_suspect_decay():
    mon = StragglerMonitor(threshold=2.0, patience=2)
    for s in range(8):
        mon.observe(s, 0.1)
    assert not mon.observe(8, 0.5)       # suspect 1 < patience
    assert not mon.observe(9, 0.1)       # healthy step decays suspicion
    assert not mon.observe(10, 0.5)      # suspect 1 again...
    assert mon.observe(11, 0.5)          # ...suspect 2: mitigation fires
    assert len(mon.events) == 3          # every suspect step recorded
    # the counter reset on firing: the next stall starts a fresh streak
    assert not mon.observe(12, 0.5)


def test_straggler_rolling_window_adapts_median():
    fired = []
    mon = StragglerMonitor(threshold=2.0, patience=1, window=8,
                           on_straggler=lambda s, t: fired.append(s))
    for s in range(8):
        mon.observe(s, 0.1)
    assert mon.observe(8, 0.3)           # 3x the old median: straggler
    assert fired == [8]
    for s in range(9, 18):               # window refills at 0.3
        mon.observe(s, 0.3)
    assert not mon.observe(18, 0.5)      # < 2x the NEW median: normal


def test_straggler_monitor_equals_the_reference_on_a_trace():
    """A noisy latency trace with stalls: both monitors fire on the same
    steps and record the same suspect events."""
    import numpy as np
    rng = np.random.default_rng(5)
    trace = 0.01 + 0.002 * rng.standard_normal(300)
    trace[rng.choice(300, 40, replace=False)] *= rng.uniform(1.5, 6, 40)
    runs = []
    for cls in (StragglerMonitor, J.StragglerMonitor):
        fired = []
        mon = cls(threshold=2.0, patience=2, window=16,
                  on_straggler=lambda s, t: fired.append(s))
        ret = [mon.observe(i, float(t)) for i, t in enumerate(trace)]
        runs.append((ret, fired, mon.events))
    assert runs[0] == runs[1]
    assert runs[0][1], "the trace never fired a mitigation"
