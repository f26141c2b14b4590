"""Trace any assigned architecture x shape cell on the production mesh
(``meta`` tensors, nothing allocated) and print its roofline terms on an
H100: the port's twin of ``examples/multiarch_dryrun.py``.

    PYTHONPATH=src python examples/multiarch_dryrun_torch.py \
        --arch llama3-8b --shape decode_32k [--multi-pod]

The record goes to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", args.arch, "--shape", args.shape]
    if args.multi_pod:
        cmd.append("--multi-pod")
    src = str(Path(__file__).resolve().parents[1] / "src")
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ,
           "PYTHONPATH": src if not path else f"{src}{os.pathsep}{path}"}
    sys.exit(subprocess.call(cmd, env=env))
