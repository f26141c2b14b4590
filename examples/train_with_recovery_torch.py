"""End-to-end training driver on the PyTorch port: a reduced assigned
architecture trained with checkpointing, an injected mid-run failure,
and automatic resume.  The twin of ``examples/train_with_recovery.py``,
with the same configuration and prints.

    PYTHONPATH=src python examples/train_with_recovery_torch.py            # card
    PYTHONPATH=src python examples/train_with_recovery_torch.py --device cpu
"""
import argparse
import os
import shutil
import subprocess
import sys
import tempfile


def main(device: str = "cuda", steps: int = 60, fail_at: int = 45,
         ckpt_every: int = 20, ckpt_dir: str = "") -> None:
    ckpt = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                    "repro_torch_example_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    common = [sys.executable, "-m", "repro_torch.launch.train",
              "--arch", "phi3.5-moe-42b-a6.6b", "--smoke",
              "--steps", str(steps), "--batch", "4", "--seq", "32",
              "--ckpt-every", str(ckpt_every), "--ckpt-dir", ckpt,
              "--log-every", "10", "--device", device]

    print(f"=== run 1: dies at step {fail_at} (injected) ===", flush=True)
    r = subprocess.run(common + ["--fail-at-step", str(fail_at)])
    assert r.returncode != 0, "expected the injected failure"

    print("\n=== run 2: resumes from the last atomic checkpoint ===",
          flush=True)
    r = subprocess.run(common + ["--resume"])
    assert r.returncode == 0
    print("\nrecovered and finished: the data pipeline resumed its exact "
          "stream position, optimizer state intact.", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--fail-at-step", type=int, default=45)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    a = ap.parse_args()
    main(a.device, a.steps, a.fail_at_step, a.ckpt_every, a.ckpt_dir)
