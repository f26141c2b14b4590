"""mamba2-1.3b's conformance report in the ``fused`` mode
(``step_many`` windows) and the ``frontend`` mode (the request
frontend's windows replayed on the oracle) equals the reference's for
the same seed: steps, recompiles, deopts, the implementations its plans
chose and the final plan's fingerprint.  These two cases were
``test_torch_conformance.py``'s slowest (each runs the reference's own
conformance run too); they live in a file of their own so that, under
``--dist loadfile``, a second worker takes them."""
import pytest

from repro.testing import run_conformance as j_run_conformance
from repro_torch.testing import run_conformance

REPORT_KEYS = ("events", "steps", "compares", "recompiles", "mispredicts",
               "deopt_steps", "impls_seen", "signature")


def _has_teeth(report):
    assert report["events"] >= 50 and report["steps"] >= 30
    assert report["recompiles"] >= 3 and report["mispredicts"] >= 2
    assert report["deopt_steps"] >= report["mispredicts"]


@pytest.mark.parametrize("mode", ["fused", "frontend"])
def test_mamba2_report_equals_the_reference_in_mode(mode):
    report = run_conformance("mamba2-1.3b", mode, seed=0, device="cpu")
    _has_teeth(report)
    assert ("ssm_state", "ssd_fastpath") in report["impls_seen"]
    if mode == "fused":    # a window serves several steps
        assert report["compares"] < report["steps"]
    ref = j_run_conformance("mamba2-1.3b", mode, seed=0)
    assert {k: report[k] for k in REPORT_KEYS} == \
        {k: ref[k] for k in REPORT_KEYS}
