"""Registers, spills and time of flash_attention_bwd's CUDA-core path at
gemma2-9b's local layer, in one or more source trees, on one CUDA card.

    python tools/bwd_cuda_cores_probe.py TREE [TREE ...] [--drop-part TREE]

Each TREE is a checkout that holds ``src/repro_torch`` (for example one
unpacked by ``git archive`` into ``build/``).  For each, in a process of
its own and in the order given (repeat a tree to alternate them), the
probe builds that tree's ``csrc/flash_attention_bwd.cu`` with the
package's own flags, prints ``-Xptxas -v``'s registers and spills of the
bf16 D 256 kernels ``bwd_dkdv`` and ``bwd_dq``, and times the bf16
backward at gemma2-9b's local layer (B 1, S 6144, 16 / 8 heads x 256,
causal, window 4096, softcap 50) through the tree's own wrapper: CUDA
events around each of 5 calls after one warm-up, the median.

``--drop-part TREE`` adds a variant of TREE whose backward ``Params``
struct lacks the ``part`` pointer (its tensor-core kernels then write
through ``delta``; the CUDA-core path timed here never reads either), to
hold one struct against the other.  The variant is written under
``build/probe/`` of this checkout.  Prints one JSON line per run.
"""
from __future__ import annotations

import inspect
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(B=1, S=6144, H=16, Hkv=8, D=256)
OPTS = dict(causal=True, window=4096, logit_softcap=50.0)
ENTRY = r"bwd_(dkdv|dq)I13__nv_bfloat16Li256E"


def _ptxas(log: str) -> dict:
    """{kernel: [registers, spill stores, spill loads]} for ENTRY."""
    out, entry, spills = {}, None, [0, 0]
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spills = m.group(1), [0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and re.search(ENTRY, entry):
            name = re.search(ENTRY, entry).group(0)
            out[name] = [int(m.group(1))] + spills
    return out


def run_tree(tree: Path) -> dict:
    """In this process: build ``tree``'s backward, read ptxas, time it."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    assert Path(build.__file__).resolve().is_relative_to(tree.resolve())
    build.build("flash_attention")
    build.build("flash_attention_bwd")
    usage = _ptxas(build.build_info["flash_attention_bwd"][1])
    gen = torch.Generator().manual_seed(0)
    B, S, H, Hkv, D = (SHAPE[k] for k in ("B", "S", "H", "Hkv", "D"))
    f = lambda *s: torch.randn(*s, generator=gen).to("cuda", torch.bfloat16)
    q, k, v, do = f(B, S, H, D), f(B, S, Hkv, D), f(B, S, Hkv, D), \
        f(B, S, H, D)
    takes_lse = "lse" in inspect.signature(fa.flash_attention_bwd_cuda
                                           ).parameters
    if takes_lse:
        o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **OPTS)
        call = lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                   **OPTS)
    else:
        o = fa.flash_attention_cuda(q, k, v, **OPTS)
        call = lambda: fa.flash_attention_bwd_cuda(q, k, v, o, do, **OPTS)
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return {"tree": str(tree), "path": fa.last_bwd_path, "ptxas": usage,
            "ms": statistics.median(times), "ms_all": times,
            "device": torch.cuda.get_device_name(0)}


def drop_part(tree: Path) -> Path:
    """A copy of ``tree``'s package whose backward Params lacks ``part``."""
    dst = ROOT / "build" / "probe" / f"{tree.name}-no-part"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(tree / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
    src = cu.read_text()
    field = re.search(r"\n\s*float\* part;[^\n]*", src)
    if field is None:
        raise SystemExit(f"{tree}: no `float* part;` field in {cu.name}")
    src = src.replace(field.group(0), "")
    src = re.sub(r"\n\s*p\.part = static_cast<float\*>\(part\);", "", src)
    cu.write_text(src.replace("p.part", "p.delta"))
    return dst


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--child":
        print(json.dumps(run_tree(Path(argv[2]))), flush=True)
        return 0
    trees, i = [], 1
    while i < len(argv):
        if argv[i] == "--drop-part":
            trees.append(drop_part(Path(argv[i + 1]).resolve()))
            i += 2
        else:
            trees.append(Path(argv[i]).resolve())
            i += 1
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[probe] {smi}")
    rc = 0
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--child",
                               str(tree)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"[probe] {tree} failed:\n{proc.stdout}{proc.stderr}")
            rc = 1
            continue
        print(f"[probe] {proc.stdout.strip().splitlines()[-1]}")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
