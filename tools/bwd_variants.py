"""Time design variants of flash_attention_bwd against the source as it is,
in turns, on one CUDA card.

    python tools/bwd_variants.py [VARIANT ...]     (default: all, twice)

Each variant is a copy of ``src/repro_torch`` under ``build/variants/``
with a few named text substitutions in ``csrc/flash_attention_bwd.cu`` or
``kernels/flash_attention.py`` (every substitution must match, so a
variant that no longer applies fails loudly).  Each run, in a process of
its own and in the order given, builds the copy (the forward's library
is shared between runs) and times the bf16 backward at three layers:
starcoder2-3b's (B 4, S 2048, 24 / 2 heads x 128, causal: the wgmma
path), seamless-m4t-medium's encoder (B 4, S 1024, 16 x 64, not causal:
wgmma) and gemma2-9b's local layer (B 1, S 6144, 16 / 8 x 256, window
4096, softcap 50: the CUDA cores).  Times are CUDA-graph replays (the
median of 5 replays of 10 calls; 2 x 2 at gemma2's layer), and at
starcoder2-3b's layer the device time by kernel (torch.profiler over 5
eager calls, each kernel's launch count beside it).  Prints the card,
then one JSON line per run.  The variants:

- ``as_is``: the source unchanged;
- ``branchy``: the element-wise step with a branch per element (the
  softcap's and the mask's), as first written;
- ``no_pingpong``: the two consumer warpgroups not ordered by the named
  barriers;
- ``stages3``: a three-stage ring in place of two;
- ``groups6`` / ``groups12``: more head groups than ``bwd_head_groups``
  chooses (it asks for 2 blocks an SM; these for 4 and 8);
- ``core_grid_constant``: the CUDA-core kernels taking their struct as
  ``__grid_constant__`` rather than by value.
"""
from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = "kernels/csrc/flash_attention_bwd.cu"
PY = "kernels/flash_attention.py"

_BRANCHY_DKDV = """        const bool cut = pairs_cut(p, i0, i0 + kTile - 1, kw_lo, kw_hi);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = 8 * (i >> 2) + 2 * t + (i & 1);
          float dcap = 1.f, x;
          if (p.cap > 0.f) {
            x = logit2<true>(p, st[i], dcap);
          } else {
            x = logit2<false>(p, st[i], dcap);
          }
          float P = 0.f, dS = 0.f;
          if (!cut || visible(p, i0 + col, key0 + 8 * ((i >> 1) & 1))) {
            P = ex2(x - rs[col]);
            dS = P * (dpt[i] - rs[kTile + col]) * dcap;
          }
          st[i] = P;
          dpt[i] = dS;
        }
"""
_BRANCHY_DQ = """        const bool cut = pairs_cut(p, wq_lo, wq_hi, k0, k0 + kTile - 1);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const int col = 8 * (i >> 2) + 2 * t + (i & 1);
          float dcap = 1.f, x;
          if (p.cap > 0.f) {
            x = logit2<true>(p, sc[i], dcap);
          } else {
            x = logit2<false>(p, sc[i], dcap);
          }
          float dS = 0.f;
          if (!cut || visible(p, rows[r], k0 + col)) {
            dS = ex2(x - lse[r]) * (dp[i] - dl[r]) * dcap;
          }
          sc[i] = dS;
        }
"""


def _dispatch(call: str, cut: str) -> str:
    """The source's four-way dispatch of the element-wise step."""
    return (f"""        if (pairs_cut({cut})) {{
          if (p.cap > 0.f) {{
            {call.format("true, true")}
          }} else {{
            {call.format("false, true")}
          }}
        }} else if (p.cap > 0.f) {{
          {call.format("true, false")}
        }} else {{
          {call.format("false, false")}
        }}
""")


_GROUPS = "if G % d == 0 and blocks * d >= 2 * SMS:"
VARIANTS = {
    "as_is": [],
    "branchy": [
        (CU, _dispatch("grads_t<{}>(p, st, dpt, rs, i0, key0, t);",
                       "p, i0, i0 + kTile - 1, kw_lo, kw_hi"),
         _BRANCHY_DKDV),
        (CU, _dispatch("grads<{}>(p, sc, dp, lse, dl, rows, k0, t);",
                       "p, wq_lo, wq_hi, k0, k0 + kTile - 1"),
         _BRANCHY_DQ)],
    "no_pingpong": [
        (CU, '  asm volatile("bar.sync %0, %1;\\n" ::"r"(1 + c), '
             '"n"(kConsumers)\n               : "memory");', "  (void)c;"),
        (CU, '  asm volatile("bar.arrive %0, %1;\\n" ::"r"(2 - c), '
             '"n"(kConsumers)\n               : "memory");', "  (void)c;")],
    "stages3": [(CU, "constexpr int kStages = 2;",
                 "constexpr int kStages = 3;")],
    "groups6": [(PY, _GROUPS, _GROUPS.replace("2 * SMS", "4 * SMS"))],
    "groups12": [(PY, _GROUPS, _GROUPS.replace("2 * SMS", "8 * SMS"))],
    "core_grid_constant": [
        (CU, f"    {k}(CoreParams p) {{",
         f"    {k}(const __grid_constant__ CoreParams p) {{")
        for k in ("bwd_delta", "bwd_dkdv", "bwd_dq")],
}
LAYERS = {  # label: (B, S, H, Hkv, D), options, (calls, replays)
    "starcoder2-3b": ((4, 2048, 24, 2, 128), {}, (10, 5)),
    "seamless-encoder": ((4, 1024, 16, 16, 64), dict(causal=False), (10, 5)),
    "gemma2-9b-local": ((1, 6144, 16, 8, 256),
                        dict(window=4096, logit_softcap=50.0), (2, 2)),
}


def make(name: str) -> Path:
    """``build/variants/<name>``: a copy of the package, substituted."""
    dst = ROOT / "build" / "variants" / name
    if dst.exists():
        shutil.rmtree(dst)
    pkg = dst / "src" / "repro_torch"
    shutil.copytree(ROOT / "src" / "repro_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in VARIANTS[name]:
        f = pkg / rel
        text = f.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old[:60]!r} is in {rel} "
                             f"{text.count(old)} times, not once")
        f.write_text(text.replace(old, new))
    return dst


def device_ms(torch, fn, calls: int, replays: int) -> float:
    """The median replay of ``calls`` calls captured in a CUDA graph, over
    ``calls`` (chip_smoke.py's timing)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def by_kernel(torch, fn, calls: int = 5) -> dict:
    """{kernel: [ms a launch, launches]} over ``calls`` eager calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {re.search(r"bwd_\w+(<[^>]*>)?", e.key).group(0):
            [e.self_device_time_total / e.count / 1e3, e.count]
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0
            and re.search(r"bwd_\w+", e.key)}


def run(tree: Path) -> dict:
    """In this process: build ``tree``'s kernels and time the layers."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    build.BUILD_DIR = ROOT / "build" / "variants" / "lib"
    build.build("flash_attention")
    build.build("flash_attention_bwd")
    gen = torch.Generator().manual_seed(5)
    out = {"variant": tree.name}
    for label, ((B, S, H, Hkv, D), kw, timing) in LAYERS.items():
        f = lambda *s: torch.randn(*s, generator=gen).to("cuda",
                                                         torch.bfloat16)
        q, k, v, do = f(B, S, H, D), f(B, S, Hkv, D), f(B, S, Hkv, D), \
            f(B, S, H, D)
        o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        out[label] = device_ms(
            torch, lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                       **kw), *timing)
        out[label + " path"] = fa.last_bwd_path
        if label == "starcoder2-3b":
            out[label + " by kernel"] = by_kernel(
                torch, lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse,
                                                           do, **kw))
        del q, k, v, do, o, lse
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--child":
        print(json.dumps(run(Path(argv[2]))), flush=True)
        return 0
    names = argv[1:] or list(VARIANTS) * 2
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"unknown variants {unknown}; known: {list(VARIANTS)}",
              file=sys.stderr)
        return 2
    trees = {n: make(n) for n in dict.fromkeys(names)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[variants] {smi}", flush=True)
    rc = 0
    for n in names:
        proc = subprocess.run([sys.executable, __file__, "--child",
                               str(trees[n])], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(f"[variants] {n} failed:\n{proc.stdout[-4000:]}"
                  f"{proc.stderr[-8000:]}", flush=True)
            rc = 1
            continue
        print(f"[variants] {proc.stdout.strip().splitlines()[-1]}",
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
