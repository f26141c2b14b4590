"""The port's training-plane chaos cells, the twins of
``tests/test_train_chaos.py`` on the CPU, with that test's assertions:

  crash_resume  bit-exact replay of the never-crashed trajectory after a
                crash + resume, with zero training-thread builds at
                resume;
  step_fault    deopt + same-batch retry, the optimizer step counter
                advances exactly once per batch, terminal re-specialized;
  device_loss   snapshot -> mesh shrink -> verified elastic reshard ->
                degraded generic -> background re-specialization;
  compile       bounded-backoff absorption of short bursts, signature
                quarantine past max_retries, training survives both.

The reference's ``train-chaos-compile`` cell has failed since the
reference was written (its harness ends the run one step after a second
decision re-staged a plan, so health reads ``recovering``, not
``quarantined``; ROADMAP Queue 3).  The port's twin fails the same way,
with the same stats, so it is marked ``xfail(strict=False)``."""
import pytest
import torch

from repro_torch.testing import TRAIN_SCENARIOS, run_train_chaos


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-scale ops gain nothing from torch's intra-op threads, and the
    suite's parallel workers oversubscribe the cores with them (the chaos
    cells take 17 s with one thread, several times that with the default
    beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CELLS = [pytest.param(s, id=f"train-chaos-{s}", marks=(
    [pytest.mark.xfail(strict=False, reason=(
        "shares the reference's train-chaos-compile failure "
        "(ROADMAP Queue 3)"))] if s == "compile" else []))
    for s in TRAIN_SCENARIOS]


@pytest.mark.parametrize("scenario", CELLS)
def test_train_chaos_cell(scenario):
    report = run_train_chaos(scenario, seed=0, device="cpu")
    assert report["scenario"] == scenario
    if scenario == "crash_resume":
        assert report["bit_exact"] is True
        assert report["resume_stats"]["sync_compiles"] == 1
        assert report["resume_stats"]["bg_compiles"] >= 1
    elif scenario == "step_fault":
        assert report["stats"]["step_faults"] == 1
        assert report["stats"]["respecialize_recoveries"] >= 1
    elif scenario == "device_loss":
        assert report["stats"]["device_losses"] == 1
        assert report["stats"]["reshard_verified"] == 1
        assert report["stats"]["mesh_epoch"] == 1
    elif scenario == "compile":
        assert report["absorbed_stats"]["quarantines"] == 0
        assert report["quarantine_stats"]["quarantines"] == 1
