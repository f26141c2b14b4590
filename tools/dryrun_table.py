#!/usr/bin/env python
"""The dry run's records as one markdown table, a row per arch x shape
with both production meshes side by side (16 x 16 / 2 x 16 x 16).

Reads ``experiments/dryrun_torch/*.json``, which
``python -m repro_torch.launch.dryrun --all-meshes`` writes, and prints
per cell: the status, the layout (``tensor_parallel`` or ``home``), the
trace seconds, the most loaded coordinate's FLOPs and HBM bytes, its
collective bytes, its peak live bytes (against one card's 80 GB), its
FLOPs and HBM bytes over their means over the coordinates
(``load_balance``), and the roofline's dominant term with its seconds.
Skipped cells are listed once, with the reference's reason.

    PYTHONPATH=src python tools/dryrun_table.py [RECORD_DIR]
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("pod16x16", "pod2x16x16")


def _g(x: float, unit: float) -> str:
    return f"{x / unit:.4g}"


def _pair(recs, fn) -> str:
    vals = [fn(r) for r in recs]
    return vals[0] if len(set(vals)) == 1 else " / ".join(vals)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out_dir = Path(argv[0]) if argv else ROOT / "experiments" / "dryrun_torch"
    recs = {}
    for f in sorted(out_dir.glob("*.json")):
        r = json.loads(f.read_text())
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    cells = sorted({(a, s) for a, s, _ in recs})
    print("| Arch | Shape | Status | Layout | Trace s | TFLOP | HBM TB | "
          "Collective GB | Peak live GB of 80 | Load balance (FLOPs, "
          "bytes) | Dominant, s |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    skipped = {}
    for arch, shape in cells:
        rs = [recs[(arch, shape, m)] for m in MESHES
              if (arch, shape, m) in recs]
        status = _pair(rs, lambda r: r["status"])
        if status == "skipped":
            skipped.setdefault(rs[0]["reason"], []).append(arch)
            continue
        if status != "ok":
            print(f"| {arch} | {shape} | {status} | | | | | | | | "
                  f"{rs[0].get('error', '')[:80]} |")
            continue
        rf = lambda r: r["roofline"]
        lb = lambda r: r.get("load_balance", {})
        print(f"| {arch} | {shape} | ok | "
              + _pair(rs, lambda r: r.get("layout", "home")) + " | "
              + _pair(rs, lambda r: f"{r['trace_s']:.1f}") + " | "
              + _pair(rs, lambda r: _g(r["hlo"]["flops"], 1e12)) + " | "
              + _pair(rs, lambda r: _g(r["hlo"]["hbm_bytes"], 1e12)) + " | "
              + _pair(rs, lambda r: _g(r["hlo"]["collective_bytes"], 1e9))
              + " | "
              + _pair(rs, lambda r: _g(r["memory"]["peak_live_bytes"], 1e9))
              + " | "
              + _pair(rs, lambda r: f"{lb(r).get('flops', 1):.3f}, "
                      f"{lb(r).get('hbm_bytes', 1):.3f}") + " | "
              + _pair(rs, lambda r: f"{rf(r)['dominant']} "
                      + _g(max(rf(r)["t_compute"], rf(r)["t_memory"],
                               rf(r)["t_collective"]), 1)) + " |")
    for reason, archs in skipped.items():
        print(f"\nSkipped (long_500k, both meshes): {', '.join(archs)}: "
              f"\"{reason}\"")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
