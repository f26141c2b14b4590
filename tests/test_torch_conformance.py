"""The port's conformance harness on the CPU: seeded churn schedules equal
the reference's event for event and byte for byte; the plain-mode
differential run (specialized runtime against its generic oracle,
outputs and tables bitwise equal at every step) passes for mamba2-1.3b
and jamba-v0.1-52b; and mamba2's report — steps, recompiles, deopts,
the implementations its plans chose and the final plan's fingerprint —
equals the reference's for the same seed (its plans depend on the
traffic and the tables, not on the weights).  The same holds in the
``fused`` mode (``step_many`` windows) and the ``frontend`` mode (the
request frontend's windows replayed on the oracle), and the reference's
own quick cells of those modes, phi3.5-MoE fused and seamless frontend,
pass (mamba2's ``fused`` and ``frontend`` reports are held in
``test_torch_conformance_modes.py``, a file of their own so that a
second worker takes them).

The cross-process fingerprint CLI: ``python -m
repro_torch.testing.fingerprint`` under another ``PYTHONHASHSEED``
prints the map ``run_fingerprints`` gives in process, and that map is
the reference's for llama3-8b and mamba2-1.3b, whose plans read no
weight.  A MoE plane's plan reads its router's expert choices, so it
depends on the weights, which each package draws from its own
generator: phi3.5-MoE (and deepseek-v2, jamba) plan differently from the
reference on their own weights and equally on the reference's, carried
across.  Without ``--device cpu`` and without a card the CLI exits
non-zero."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.testing import build_plane as j_build_plane, \
    generate_schedule as j_generate_schedule, \
    run_conformance as j_run_conformance
from repro.testing import archzoo as j_archzoo
from repro.testing.churn import churn_moves as j_churn_moves
from repro.testing.fingerprint import run_fingerprints as j_run_fingerprints
from repro_torch.testing import build_plane, generate_schedule, \
    run_conformance, run_fingerprints
from repro_torch.testing import conformance as conformance_mod
from repro_torch.testing.archzoo import params_from_numpy
from repro_torch.testing.churn import churn_moves
from repro_torch.testing.conformance import MODES

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
FP_ARCHS = ("llama3-8b", "mamba2-1.3b")
MOE_ARCH = "phi3.5-moe-42b-a6.6b"

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


def _has_teeth(report):
    assert report["events"] >= 50 and report["steps"] >= 30
    assert report["recompiles"] >= 3 and report["mispredicts"] >= 2
    assert report["deopt_steps"] >= report["mispredicts"]


@pytest.mark.parametrize("arch,mode,impl", [
    ("phi3.5-moe-42b-a6.6b", "fused", ("router", "moe_fastpath")),
    ("seamless-m4t-medium", "frontend", ("__frontend__", "batch_shape"))])
def test_reference_quick_cells_pass(arch, mode, impl):
    report = run_conformance(arch, mode, seed=0, device="cpu")
    _has_teeth(report)
    assert impl in report["impls_seen"]


def test_unported_modes_raise():
    assert MODES == ("plain", "fused", "frontend")
    with pytest.raises(ValueError):
        run_conformance("mamba2-1.3b", "bogus", device="cpu")


# ---------------------------------------------------------------------------
# the cross-process fingerprint CLI
# ---------------------------------------------------------------------------

def _cli(*args):
    env = dict(os.environ, PYTHONHASHSEED="271828", PYTHONPATH=SRC)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.testing.fingerprint", *args],
        capture_output=True, text=True, env=env, timeout=300)


@pytest.fixture(scope="module")
def reference_fingerprints():
    return j_run_fingerprints(FP_ARCHS + (MOE_ARCH,), seed=0)


def test_plan_fingerprints_match_across_processes():
    """The twin of the reference's cross-process check: two processes
    with different hash salts plan the same signatures."""
    here = run_fingerprints(["llama3-8b"], seed=0, device="cpu")
    res = _cli("--device", "cpu", "llama3-8b")
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == here
    assert res.stdout.endswith("}\n")


def test_fingerprint_map_equals_the_reference(reference_fingerprints):
    fps = run_fingerprints(FP_ARCHS, seed=0, device="cpu")
    assert fps == {a: reference_fingerprints[a] for a in FP_ARCHS}


def test_moe_fingerprint_equals_the_reference_on_its_weights(
        reference_fingerprints, monkeypatch):
    """The MoE plane's plan follows the router, so on the port's own
    weights it differs; on the reference's weights it is the same."""
    own = run_fingerprints([MOE_ARCH], seed=0, device="cpu")[MOE_ARCH]
    assert own != reference_fingerprints[MOE_ARCH]

    def carried(plane, seed, device):
        jplane = j_archzoo.build_plane(plane.arch_id)
        return params_from_numpy(jax.tree.map(
            np.asarray, j_archzoo.build_params(jplane, seed)), device)

    monkeypatch.setattr(conformance_mod, "build_params", carried)
    assert run_fingerprints([MOE_ARCH], seed=0, device="cpu") == \
        {MOE_ARCH: reference_fingerprints[MOE_ARCH]}


def test_the_fingerprint_cli_needs_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    res = _cli("llama3-8b")
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert res.stdout == ""
