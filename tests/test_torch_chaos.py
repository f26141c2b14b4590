"""The port's chaos harness on the CPU: fault-injected degraded-mode
serving held to the generic oracle bit for bit, with every fault
followed by the health-gated recovery.

The chaos cells carry the reference test's assertions
(``tests/test_conformance.py::test_chaos_cell``); the llama3-8b plain
report's schedule-fixed fields and the whole mamba2-1.3b plain report
equal the reference's for the same seed; chaos schedules equal the
reference's event for event, and plain schedules hold no chaos move.
The frontend cell against the reference lives in
``test_torch_chaos_frontend.py`` (the reference's run alone takes about
a minute here)."""
import numpy as np
import pytest

from repro.testing import build_plane as j_build_plane, \
    generate_schedule as j_generate_schedule, run_chaos as j_run_chaos
from repro.testing.churn import churn_moves as j_churn_moves
from repro_torch.testing import CHAOS_MODES, FAULT_KINDS, build_plane, \
    generate_schedule, run_chaos
from repro_torch.testing.churn import churn_moves

# the fields a chaos run's schedule fixes, whatever the weights
SCHEDULE_FIELDS = ("events", "faults", "recovery_arcs", "retried_steps",
                   "rejected_degraded", "requests_failed", "final_state")


def _payload_equal(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _payload_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _payload_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _has_chaos_teeth(report, mode):
    """The reference chaos cell's assertions."""
    assert set(report["faults"]) == set(FAULT_KINDS)
    assert report["recovery_arcs"] >= len(FAULT_KINDS)
    assert report["final_state"] == "healthy"
    assert report["compares"] >= 10
    if mode == "plain":
        assert report["retried_steps"] >= 1
    else:
        assert report["rejected_degraded"] >= 1
    specialized = [(t, i) for t, i in report["impls_seen"]
                   if i != "gather"]
    assert specialized, report["impls_seen"]


@pytest.mark.parametrize("mode", CHAOS_MODES)
def test_chaos_cell(mode):
    report = run_chaos("llama3-8b", mode, seed=0, n_events=70,
                       device="cpu")
    _has_chaos_teeth(report, mode)


def test_llama3_plain_chaos_report_equals_the_reference():
    report = run_chaos("llama3-8b", "plain", seed=0, device="cpu")
    ref = j_run_chaos("llama3-8b", "plain", seed=0)
    assert {k: report[k] for k in SCHEDULE_FIELDS} == \
        {k: ref[k] for k in SCHEDULE_FIELDS}
    assert report["retried_steps"] >= 1


def test_mamba2_plain_chaos_report_equals_the_reference():
    report = run_chaos("mamba2-1.3b", "plain", seed=0, device="cpu")
    _has_chaos_teeth(report, "plain")
    assert ("ssm_state", "ssd_fastpath") in report["impls_seen"]
    assert report == j_run_chaos("mamba2-1.3b", "plain", seed=0)


def test_chaos_moves_are_fenced_out_of_plain_schedules():
    """Chaos moves do not perturb plain schedules; with chaos=True every
    fault kind fires as a contiguous fault->steps->recovery episode."""
    plane = build_plane("llama3-8b")
    plain_kinds = {e.kind for e in generate_schedule(plane, seed=3)}
    assert "chaos_fault" not in plain_kinds
    assert "schedule_recovery" not in plain_kinds
    assert not [m for m in churn_moves(plane) if m.startswith("chaos")]

    s1 = generate_schedule(plane, seed=3, chaos=True)
    s2 = generate_schedule(plane, seed=3, chaos=True)
    assert [e.kind for e in s1] == [e.kind for e in s2]
    kinds = [e.kind for e in s1]
    faults = [e.payload["fault"] for e in s1 if e.kind == "chaos_fault"]
    assert set(faults) >= set(FAULT_KINDS)
    assert kinds.count("schedule_recovery") == kinds.count("chaos_fault")
    for i, k in enumerate(kinds):
        if k == "chaos_fault":
            j = i + 1
            while kinds[j] == "step":
                j += 1
            assert kinds[j] == "schedule_recovery", (i, kinds[i:j + 1])


@pytest.mark.parametrize("arch,seed,n_events", [
    ("llama3-8b", 0, 70), ("mamba2-1.3b", 0, 70),
    ("jamba-v0.1-52b", 3, 60), ("seamless-m4t-medium", 5, 70)])
def test_chaos_schedule_equals_the_reference(arch, seed, n_events):
    plane, jplane = build_plane(arch), j_build_plane(arch)
    assert churn_moves(plane, chaos=True) == j_churn_moves(jplane,
                                                           chaos=True)
    sched = generate_schedule(plane, seed=seed, n_events=n_events,
                              chaos=True)
    jsched = j_generate_schedule(jplane, seed=seed, n_events=n_events,
                                 chaos=True)
    assert [e.kind for e in sched] == [e.kind for e in jsched]
    for e, j in zip(sched, jsched):
        _payload_equal(e.payload, j.payload)


def test_unported_chaos_parts_raise():
    """A mode the chaos driver does not have raises (the training
    device-loss cell, which once raised here, runs in
    ``tests/test_torch_train_chaos.py``)."""
    with pytest.raises(ValueError):
        run_chaos("llama3-8b", "fused", device="cpu")
