#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the build of every CUDA kernel from ``csrc/`` (one nvcc
   per source, all started together).
2. Kernel phase: each kernel against its plain PyTorch version and
   ``index_select`` on the reference's test shapes and the serving
   path's shape, bit for bit.
3. Serving phase at full width (the widths of
   ``src/repro/configs/phi3p5_moe.py``; 2 layers instead of 32, because
   f32 params at 32 layers do not fit one card): generic steps, a
   blocking recompile, specialized steps.  The plan must hold
   ``hot_cache`` at ``vocab_embed#0`` and ``moe_fastpath`` on ``router``,
   the kernels must have been launched by the specialized steps, the
   specialized output must equal the generic oracle bit for bit, a
   control update must deopt, and a second recompile must restore the
   plan.  Launch counts are zeroed just before this phase and read just
   after it.
   Both phases print ms/step (host clock, synchronized) and a
   torch.profiler breakdown of device time by kernel.
4. Each kernel timed on the inputs the serving path gave it (device
   time: calls captured in a CUDA graph, replays timed with CUDA events),
   beside its plain version, ``index_select`` and its byte bound.

The last three lines are the kernels JSON, the nvidia-smi line and the
device JSON.  Any failure raises (exit code != 0) and prints no result;
without CUDA, or without the repository's ``src/`` beside this file, the
script exits with 2.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
KERNELS = {                     # name -> (source, TPU kernel it replaces)
    "hot_gather": ("src/repro_torch/kernels/csrc/hot_gather.cu",
                   "src/repro/kernels/hot_gather.py:42"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA
    graph, the graph replayed ``replays`` times between two events; the
    median replay over ``calls``.  Host-side launch overhead is out of
    the measurement (eager calls of a small kernel are host-bound)."""
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


def eager_ms(torch, fn, iters: int = 50) -> float:
    """Median time of one eager call, host enqueue included (CUDA events
    around each call)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def kernel_phase(torch, hot_gather_cuda, hot_gather_ref) -> float:
    """Every shape of the reference's hot_gather tests plus the serving
    path's, f32 and bf16; returns the largest |kernel - plain|."""
    gen = torch.Generator().manual_seed(0)
    cases = []
    for V, D, Hn, T in [(64, 16, 4, 32), (512, 64, 8, 100),
                        (128, 32, 1, 7), (32064, 4096, 32, 512)]:
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.randn(V, D, generator=gen).to(dtype)
            hot_ids = torch.randperm(V, generator=gen)[:Hn].int()
            idx = torch.randint(0, V, (T,), generator=gen).int()
            cases.append((f"V{V}_D{D}_H{Hn}_T{T}_{dtype}", table,
                          hot_ids, idx))
    table = torch.randn(32, 8, generator=gen)
    hot_ids = torch.tensor([1, 2, 3], dtype=torch.int32)
    cases.append(("all_hot", table, hot_ids,
                  torch.tensor([1, 2, 3, 1, 2], dtype=torch.int32)))
    cases.append(("all_cold", table, hot_ids,
                  torch.tensor([9, 10, 11], dtype=torch.int32)))
    worst = 0.0
    for name, table, hot_ids, idx in cases:
        table, hot_ids, idx = (t.cuda() for t in (table, hot_ids, idx))
        hot_rows = table.index_select(0, hot_ids)
        out = hot_gather_cuda(table, hot_rows, hot_ids, idx)
        plain = hot_gather_ref(table, hot_rows, hot_ids, idx)
        lib = table.index_select(0, idx)
        torch.cuda.synchronize()
        check(torch.equal(out, plain), f"hot_gather != plain on {name}")
        check(torch.equal(out, lib), f"hot_gather != index_select on {name}")
        worst = max(worst, (out.float() - plain.float()).abs().max().item())
        print(f"[kernel] hot_gather {name}: equal to plain and index_select")
    return worst


def serving_phase(torch, ops):
    from repro_torch.core import EngineConfig, MorpheusRuntime, SketchConfig
    from repro_torch.serving import ServeConfig, build_params, \
        build_tables, make_serve_step, make_synthetic_batch

    cfg = ServeConfig(d_model=4096, n_experts=16, top_k=2, d_ff=6400,
                      vocab=32064, n_layers=2, seq=64, n_classes=64,
                      n_slots=256)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    t0 = time.perf_counter()
    params = build_params(cfg, seed=0, device="cuda")
    for lp in params["layers"]:            # a domain-skewed router
        with torch.no_grad():
            lp["moe"]["b_router"][:3] = 6.0
    rt = MorpheusRuntime(
        make_serve_step(cfg), build_tables(cfg), params,
        make_synthetic_batch(cfg, seed=0),
        cfg=EngineConfig(
            sketch=SketchConfig(sample_every=4, max_hot=32,
                                hot_coverage=0.8),
            features={"vision_enabled": False, "track_sessions": True},
            moe_router_table="router"))
    torch.cuda.synchronize()
    print(f"[serve] setup {time.perf_counter() - t0:.1f} s, params "
          f"{sum(p.numel() for p in params.parameters()) * 4 / 2**30:.2f} "
          f"GiB f32, analysis {rt.analysis['mutability']}")
    try:
        def run(seed0: int, n: int = 16) -> float:
            ts = []
            for i in range(n):
                b = make_synthetic_batch(cfg, seed=seed0 + i, locality="high")
                t = time.perf_counter()
                out = rt.step(b)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t)
            check(out.shape == (8, cfg.seq, cfg.vocab)
                  and bool(torch.isfinite(out).all()),
                  f"bad step output {tuple(out.shape)}")
            return statistics.median(ts) * 1e3

        def profile(label: str, seed0: int, n: int = 3) -> None:
            """Device time by kernel over ``n`` steps (torch.profiler),
            and the share of the window's wall time the device was busy
            (the profiler's own overhead included)."""
            from torch.profiler import ProfilerActivity, profile as prof_
            batches = [make_synthetic_batch(cfg, seed=seed0 + i)
                       for i in range(n)]
            torch.cuda.synchronize()
            with prof_(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                for b in batches:
                    rt.step(b)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t) * 1e6
            dev = lambda e: getattr(e, "self_device_time_total", 0)
            # the kernels themselves (the ops that launched them carry
            # the same device time again)
            events = [e for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA") and dev(e) > 0]
            busy = sum(dev(e) for e in events)
            if not events:
                print(f"[profile] {label}: no device time in the trace "
                      f"(not measured)")
                return
            print(f"[profile] {label}: {n} steps, wall {wall_us:.0f} us, "
                  f"device busy {busy:.0f} us ({busy / wall_us:.1%})")
            for e in sorted(events, key=dev, reverse=True)[:12]:
                print(f"[profile]   {dev(e) / n:9.1f} us/step "
                      f"{e.count / n:6.1f} calls/step  {e.key[:90]}")

        def assert_plan(when: str):
            sites = dict(rt.plan.sites)
            vocab = sites.get("vocab_embed#0")
            check(vocab is not None and vocab.impl == "hot_cache",
                  f"{when}: vocab_embed#0 planned {vocab}")
            check(rt.hot_experts() is not None,
                  f"{when}: no moe_fastpath on router: {rt.plan.sites}")
            return {sid: s.impl for sid, s in rt.plan.sites}

        ms_generic = run(1000)
        profile("generic", 1500)
        info = rt.recompile(block=True)
        plan = assert_plan("first recompile")
        print(f"[serve] plan {plan} hot_experts={rt.hot_experts()} "
              f"passes={info['pass_stats']}")
        before = ops.launches().get("hot_gather", 0)
        ms_spec = run(2000)
        check(ops.launches().get("hot_gather", 0) > before,
              "specialized steps did not launch hot_gather")
        profile("specialized", 2500)

        b = make_synthetic_batch(cfg, seed=4242, locality="high")
        out_g = rt.run_generic(b)
        out_s = rt.step(b)
        check(torch.equal(out_s, out_g),
              "specialized output != generic output")
        print("[serve] specialized == generic bit for bit")

        d0 = rt.stats.deopt_steps
        temps = torch.linspace(0.5, 1.5, cfg.n_classes).numpy()
        rt.control_update("req_class", {"temperature": temps})
        out_d = rt.step(b)
        check(rt.stats.deopt_steps == d0 + 1, "control update did not deopt")
        check(torch.equal(out_d, rt.run_generic(b)),
              "deopted output != generic output")
        rt.recompile(block=True)
        assert_plan("second recompile")
        out_r = rt.step(b)
        check(torch.equal(out_r, rt.run_generic(b)),
              "re-specialized output != generic output")
        print(f"[serve] generic {ms_generic:.3f} ms/step, specialized "
              f"{ms_spec:.3f} ms/step (batch 8 x seq {cfg.seq}, median of "
              f"16), deopt_steps={rt.stats.deopt_steps}")
        snap = rt.stats.snapshot()
        print(f"[serve] counters "
              f"{ {k: v for k, v in snap.items() if isinstance(v, int)} }")
        print(f"[serve] recompile cycles (s): t1 {snap['t1_history']} "
              f"t2 {snap['t2_history']} swap {snap['swap_history']}")
        # the main path's own hot_gather inputs, for timing
        table = rt.state.tables["vocab_embed"]["vec"]
        hot_ids = torch.tensor(dict(rt.plan.sites)["vocab_embed#0"].hot_keys,
                               dtype=torch.int32, device="cuda")
        idx = b["tokens"].reshape(-1).contiguous()
        return table, hot_ids, idx
    finally:
        rt.close()


def time_hot_gather(torch, hot_gather_cuda, hot_gather_ref, table, hot_ids,
                    idx):
    hot_rows = table.index_select(0, hot_ids)
    T, (V, D) = idx.shape[0], table.shape
    row = D * table.element_size()
    cold = idx[~torch.isin(idx, hot_ids)]
    n_cold_rows = int(torch.unique(cold).numel())
    # each input read once (only the rows this run needs), output written
    nbytes = (idx.numel() * 4 + hot_ids.numel() * 4 + hot_rows.numel()
              * table.element_size() + n_cold_rows * row + T * row)
    from repro_torch.kernels import ops
    kern = lambda: hot_gather_cuda(table, hot_rows, hot_ids, idx)
    plain = lambda: hot_gather_ref(table, hot_rows, hot_ids, idx)
    lib = lambda: table.index_select(0, idx)
    check(torch.equal(kern(), plain()) and torch.equal(kern(), lib()),
          "hot_gather differs on the serving path's own inputs")
    n0 = ops.launches().get("hot_gather", 0)
    res = {
        "ms": device_ms(torch, kern),
        "plain_ms": device_ms(torch, plain),
        "library_ms": device_ms(torch, lib),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }
    check(ops.launches()["hot_gather"] > n0, "timing did not launch")
    eager = {k: eager_ms(torch, f) for k, f in
             (("kernel", kern), ("plain", plain), ("index_select", lib))}
    print(f"[time] eager calls, host enqueue included (ms): {eager}")
    print(f"[time] hot_gather V={V} D={D} Hn={hot_ids.numel()} T={T} "
          f"{table.dtype}: {n_cold_rows} cold rows, {nbytes} bytes, {res}")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.hot_gather import hot_gather_cuda
    from repro_torch.kernels.ref import hot_gather_ref

    smi = nvidia_smi()
    print(f"[header] {smi}")
    print(f"[header] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for name, _ in zip(KERNELS, pool.map(build.build, KERNELS)):
            secs, log = build.build_info[name]
            print(f"[build] {name}: {secs:.1f} s\n{log.strip()}")
    print(f"[build] all kernels {time.perf_counter() - t0:.1f} s")

    err = kernel_phase(torch, hot_gather_cuda, hot_gather_ref)

    ops.reset_launches()
    table, hot_ids, idx = serving_phase(torch, ops)
    launches = ops.launches()
    print(f"[serve] launches during the serving phase: {launches}")
    for name in KERNELS:
        check(launches.get(name, 0) > 0, f"{name} never launched")

    timing = time_hot_gather(torch, hot_gather_cuda, hot_gather_ref,
                             table, hot_ids, idx)
    src, replaces = KERNELS["hot_gather"]
    kernels = [dict(name="hot_gather", route="cuda", source=src,
                    replaces=replaces, launches=launches["hot_gather"],
                    max_abs_err=err, **timing)]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
