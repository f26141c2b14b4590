"""The port's conformance harness on the CPU: seeded churn schedules equal
the reference's event for event and byte for byte; the plain-mode
differential run (specialized runtime against its generic oracle,
outputs and tables bitwise equal at every step) passes for mamba2-1.3b
and jamba-v0.1-52b; and mamba2's report — steps, recompiles, deopts,
the implementations its plans chose and the final plan's fingerprint —
equals the reference's for the same seed (its plans depend on the
traffic and the tables, not on the weights)."""
import numpy as np
import pytest

from repro.testing import build_plane as j_build_plane, \
    generate_schedule as j_generate_schedule, \
    run_conformance as j_run_conformance
from repro.testing.churn import churn_moves as j_churn_moves
from repro_torch.testing import build_plane, generate_schedule, \
    run_conformance
from repro_torch.testing.churn import churn_moves
from repro_torch.testing.conformance import MODES

REPORT_KEYS = ("events", "steps", "compares", "recompiles", "mispredicts",
               "deopt_steps", "impls_seen", "signature")


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


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b",
                                  "seamless-m4t-medium"])
def test_schedule_equals_the_reference(arch):
    plane, jplane = build_plane(arch), j_build_plane(arch)
    assert churn_moves(plane) == j_churn_moves(jplane)
    sched = generate_schedule(plane, seed=3, n_events=60)
    jsched = j_generate_schedule(jplane, seed=3, n_events=60)
    assert [e.kind for e in sched] == [e.kind for e in jsched]
    for e, j in zip(sched, jsched):
        _payload_equal(e.payload, j.payload)


@pytest.fixture(scope="module")
def mamba2_reference_report():
    return j_run_conformance("mamba2-1.3b", "plain", seed=0)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_plain_conformance_passes(arch, mamba2_reference_report):
    report = run_conformance(arch, "plain", seed=0, device="cpu")
    # run_conformance raised on any divergence, coverage gap or
    # un-deopted mispredict; the report shows the run had teeth
    assert report["events"] >= 50 and report["steps"] >= 30
    assert report["recompiles"] >= 3 and report["mispredicts"] >= 2
    assert report["deopt_steps"] >= report["mispredicts"]
    assert ("ssm_state", "ssd_fastpath") in report["impls_seen"]
    if arch == "mamba2-1.3b":
        ref = mamba2_reference_report
        assert {k: report[k] for k in REPORT_KEYS} == \
            {k: ref[k] for k in REPORT_KEYS}
    else:
        assert ("router", "moe_fastpath") in report["impls_seen"]


def test_unported_modes_and_chaos_schedules_raise():
    assert MODES == ("plain", "fused", "frontend")
    for mode in ("fused", "frontend"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run_conformance("mamba2-1.3b", mode, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        generate_schedule(build_plane("mamba2-1.3b"), chaos=True)
    with pytest.raises(ValueError):
        run_conformance("mamba2-1.3b", "bogus", device="cpu")
