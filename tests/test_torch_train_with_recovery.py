"""``examples/train_with_recovery_torch.py`` on the CPU, cut to 12 steps:
the first run dies at step 9 as injected, the second resumes from the
checkpoint of step 8 and finishes."""
import os
import subprocess
import sys

ENV = {**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"}


def test_train_with_recovery_example_crashes_and_resumes(tmp_path):
    r = subprocess.run(
        [sys.executable, "examples/train_with_recovery_torch.py",
         "--device", "cpu", "--steps", "12", "--fail-at-step", "9",
         "--ckpt-every", "4", "--ckpt-dir", str(tmp_path / "ckpt")],
        capture_output=True, text=True, env=ENV, cwd=os.getcwd(),
        timeout=300)
    assert r.returncode == 0, r.stderr[-1500:]
    assert "injected failure at step 9" in r.stderr
    assert "[train] resumed from step 8" in r.stdout
    assert "[train] done at step 12" in r.stdout
    assert "recovered and finished" in r.stdout
