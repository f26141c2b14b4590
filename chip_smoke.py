#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the build of every CUDA kernel from ``csrc/`` (one nvcc
   per source, all started together).
2. Kernel phase: each kernel against its plain PyTorch version.
   ``hot_gather`` against ``index_select`` too, on the reference's test
   shapes and the serving path's shape, bit for bit.  ``ssd_scan`` on
   the reference's four test shapes (f32 and bf16, that test's
   tolerances), a G = 2 case and the mamba2-1.3b serving shape with a
   non-zero initial state (tolerance stated at ``SSD_TOL``), plus equal
   bits for a None and a zero initial state and from call to call.
3. Serving phase at full width (the widths of
   ``src/repro/configs/phi3p5_moe.py``; 2 layers instead of 32, because
   f32 params at 32 layers do not fit one card): generic steps, a
   blocking recompile, specialized steps.  The plan must hold
   ``hot_cache`` at ``vocab_embed#0`` and ``moe_fastpath`` on ``router``,
   the kernels must have been launched by the specialized steps, the
   specialized output must equal the generic oracle bit for bit, a
   control update must deopt, and a second recompile must restore the
   plan.
4. Arch-zoo phase at the full width of mamba2-1.3b
   (``src/repro/configs/mamba2_1p3b.py``; its plane's one distinct block,
   as the plane compresses depth; seq 1024 = 4 chunks, batch 4): generic
   steps, an ``ssm_state`` flush and a blocking recompile that must plan
   ``hot_cache`` at ``vocab_embed#0`` and ``ssd_fastpath`` on
   ``ssm_state``, specialized steps equal to the generic oracle bit for
   bit on a fresh batch (the fast branch) and a warm one (the gather
   branch), a warming control update that must deopt, and a recompile
   that must decline ``ssd_fastpath``.
   Phases 3 and 4 each zero the launch counts just before and read them
   just after, and fail unless every kernel of their path launched; both
   print ms/step (host clock, synchronized), a torch.profiler breakdown
   of device time by kernel, and phase 4 the host syncs per step.
5. Conformance on the card: ``run_conformance(arch, "plain", seed=0)``
   for mamba2-1.3b and jamba-v0.1-52b at smoke scale; mamba2's report
   must equal the same run's on the host.
6. Each kernel timed on the inputs its main path gave it (device time:
   calls captured in a CUDA graph, replays timed with CUDA events),
   beside its plain version, its library call where one exists, and its
   bound.

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
F32_FLOP_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
KERNELS = {                     # name -> (source, TPU kernel it replaces)
    "hot_gather": ("src/repro_torch/kernels/csrc/hot_gather.cu",
                   "src/repro/kernels/hot_gather.py:42"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:73"),
}
# ssd_scan against its plain version.  On the reference kernel test's
# shapes, that test's elementwise tolerances (abs + rel): y 2e-5 in f32,
# 2e-2 in bf16 (y is rounded to 8 bits), the state 1e-3.  At the serving
# shapes (128-term dot products, 256-step chunks, a carried state) y
# sums terms of both signs, so an error relative to each element is the
# wrong yardstick: the two versions sum in other orders, and f32 rounding
# of a K-term sum grows like sqrt(K) * 2^-24 times the terms' magnitude,
# which for K ~ 400 and terms up to ~10x the outputs is ~1e-5 of max|y|
# (worst case ~2e-4).  There y (f32) is held normwise:
# max|y - y_plain| <= 1e-4 * max|y_plain|.
SSD_TOL = {"f32": 2e-5, "bf16": 2e-2, "state": 1e-3, "f32_normwise": 1e-4}


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


def profile_steps(torch, label: str, step, batches) -> None:
    """Device time by kernel over one ``step`` per batch (torch.profiler),
    and the share of the window's wall time the device was busy (the
    profiler's own overhead included)."""
    from torch.profiler import ProfilerActivity, profile as prof_
    n = len(batches)
    torch.cuda.synchronize()
    with prof_(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for b in batches:
            step(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    dev = lambda e: getattr(e, "self_device_time_total", 0)
    # the kernels themselves (the ops that launched them carry the same
    # device time again)
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


def host_syncs(torch, step, batches) -> float:
    """Device-to-host synchronizations per ``step`` call, counted with
    PyTorch's sync debug mode (one warning per synchronizing call)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for b in batches:
                step(b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = sum("synchroniz" in str(w.message) for w in caught)
    return n / len(batches)


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
            profile_steps(torch, label, rt.step,
                          [make_synthetic_batch(cfg, seed=seed0 + i)
                           for i in range(n)])

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


def ssd_inputs(torch, gen, B, S, H, P, N, G, dtype, init: bool):
    """Random SSD scan inputs of the reference test's distributions, on
    the card."""
    f = lambda *shape: torch.randn(*shape, generator=gen)
    x = f(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(f(B, S, H))
    A = -torch.exp(f(H) * 0.5)
    Bm = (f(B, S, G, N) * 0.3).to(dtype)
    Cm = (f(B, S, G, N) * 0.3).to(dtype)
    s0 = f(B, H, P, N) * 0.1 if init else None
    return tuple(None if t is None else t.cuda()
                 for t in (x, dt, A, Bm, Cm, s0))


def ssd_compare(torch, ssd_scan_cuda, ssd_scan_ref, name, args, chunk,
                init, y_tol, normwise=False):
    """Kernel against plain on one input; returns max |y - y_plain| and
    max |state - state_plain|.  y is held elementwise (abs + rel), or
    with ``normwise`` against ``y_tol * max|y_plain|``."""
    y, fin = ssd_scan_cuda(*args, chunk=chunk, init_state=init)
    yr, finr = ssd_scan_ref(*args, chunk, init_state=init)
    torch.cuda.synchronize()
    check(y.dtype == args[0].dtype and fin.dtype == torch.float32,
          f"ssd_scan {name}: output dtypes {y.dtype} {fin.dtype}")
    dy = (y.float() - yr.float()).abs()
    ds = (fin - finr).abs()
    scale = yr.float().abs().max().item()
    if normwise:
        ok = dy.max().item() <= y_tol * scale
    else:
        ok = bool((dy <= y_tol + y_tol * yr.float().abs()).all())
    check(ok, f"ssd_scan {name}: y differs from plain by "
              f"{dy.max().item()} (max|y_plain| {scale})")
    check(bool((ds <= SSD_TOL["state"] + SSD_TOL["state"] * finr.abs())
               .all()),
          f"ssd_scan {name}: state differs from plain by "
          f"{ds.max().item()}")
    print(f"[kernel] ssd_scan {name}: max |y - plain| "
          f"{dy.max().item():.3e} ({dy.max().item() / max(scale, 1e-30):.2e}"
          f" of max|y_plain| {scale:.3e}; tol {y_tol}"
          f"{' x max|y_plain|' if normwise else ' abs + rel'}), max |state "
          f"- plain| {ds.max().item():.3e}")
    return dy.max().item(), ds.max().item()


def ssd_kernel_phase(torch, ssd_scan_cuda, ssd_scan_ref) -> float:
    """The reference test's shapes, a G = 2 case and the serving shape;
    returns the largest f32 |kernel - plain| of y and the state."""
    gen = torch.Generator().manual_seed(1)
    worst = 0.0
    # (B, S, H, P, N, chunk, G): tests/test_kernels.py's four, G = 2,
    # and mamba2-1.3b's serving shape
    shapes = [(1, 32, 4, 8, 16, 8, 1), (2, 48, 8, 16, 32, 16, 1),
              (1, 40, 2, 8, 16, 16, 1), (2, 64, 8, 16, 16, 32, 1),
              (2, 50, 8, 16, 32, 16, 2), (4, 1024, 64, 64, 128, 256, 1)]
    for B, S, H, P, N, Q, G in shapes:
        serving = (B, S, H) == (4, 1024, 64)
        for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            *args, init = ssd_inputs(torch, gen, B, S, H, P, N, G, dtype,
                                     init=serving)
            normwise = serving and key == "f32"
            tol = SSD_TOL["f32_normwise" if normwise else key]
            name = f"B{B}_S{S}_H{H}_P{P}_N{N}_Q{Q}_G{G}_{key}"
            dy, ds = ssd_compare(torch, ssd_scan_cuda, ssd_scan_ref, name,
                                 args, Q, init, tol, normwise)
            if key == "f32":
                worst = max(worst, dy, ds)
    # a None initial state is bitwise a zero one, and calls repeat bits
    *args, _ = ssd_inputs(torch, gen, 4, 1024, 64, 64, 128, 1,
                          torch.float32, init=False)
    y0, f0 = ssd_scan_cuda(*args, chunk=256)
    y1, f1 = ssd_scan_cuda(*args, chunk=256, init_state=torch.zeros_like(f0))
    y2, f2 = ssd_scan_cuda(*args, chunk=256)
    check(torch.equal(y0, y1) and torch.equal(f0, f1),
          "ssd_scan: None and zero initial states differ")
    check(torch.equal(y0, y2) and torch.equal(f0, f2),
          "ssd_scan: two calls differ")
    print("[kernel] ssd_scan: None init == zero init and call == call, "
          "bit for bit")
    return worst


def archzoo_phase(torch, ops):
    """mamba2-1.3b's arch-zoo plane at full width under MorpheusRuntime.
    Returns the (args, kwargs) one specialized step gave ssd_scan."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import MorpheusRuntime
    from repro_torch.testing.archzoo import ArchPlane, _distinct_blocks, \
        build_params, build_tables, conformance_engine_config, \
        make_batch, make_step
    from repro_torch.testing.churn import _mv_ssm_flush, _mv_ssm_warm

    cfg = get_config("mamba2-1.3b")            # unreduced widths
    blocks = _distinct_blocks(cfg)
    check(len(blocks) == 1 and blocks[0].kind == "mamba",
          f"mamba2-1.3b blocks {blocks}")
    plane = ArchPlane(arch_id=cfg.name, cfg=cfg, blocks=blocks, seq=1024,
                      vocab=cfg.padded_vocab, has_ssm=True, has_moe=False,
                      has_cross=False, has_media=False)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    params = build_params(plane, seed=0, device="cuda")
    tables = build_tables(plane, seed=0)
    rt = MorpheusRuntime(make_step(plane), tables, params,
                         make_batch(plane, rng),
                         conformance_engine_config(plane))
    rt.sampler.pin(2)                          # the harness's cadence
    torch.cuda.synchronize()
    table_gib = sum(v.nbytes for t in tables.tables.values()
                    for v in t.fields.values()) / 2**30
    print(f"[archzoo] {cfg.name}: d_model {cfg.d_model}, "
          f"{cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} SSD heads x "
          f"P {cfg.ssm.head_dim}, N {cfg.ssm.d_state}, chunk "
          f"{cfg.ssm.chunk}, vocab {plane.vocab}, batch 4 x seq "
          f"{plane.seq}; setup {time.perf_counter() - t0:.1f} s, params "
          f"{sum(p.numel() for p in params.parameters()) * 4 / 2**30:.2f}"
          f" GiB f32, tables {table_gib:.2f} GiB, analysis "
          f"{rt.analysis['mutability']}")

    def batches(n):
        return [make_batch(plane, rng) for _ in range(n)]

    def on_card(bs):
        return [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
                for b in bs]

    def run(bs) -> float:
        ts = []
        for b in bs:
            t = time.perf_counter()
            out = rt.step(b)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        check(out.shape == (4, plane.seq, plane.vocab)
              and bool(torch.isfinite(out).all()),
              f"bad step output {tuple(out.shape)}")
        return statistics.median(ts) * 1e3

    def counts(b):
        slot = torch.as_tensor(b["slot"]).long().cuda()
        return rt.state.tables["ssm_state"]["count"][slot]

    def same(b, what: str):
        # the oracle first: the step writes the slots' state it reads
        out_g = rt.run_generic(b)
        out_s = rt.step(b)
        check(torch.equal(out_s, out_g), f"{what}: specialized != generic")
        return out_s

    try:
        ms_generic = run(batches(8))
        profile_steps(torch, "archzoo generic", rt.step, batches(3))
        sync_generic = host_syncs(torch, rt.step, on_card(batches(2)))

        rt.control_update("ssm_state",
                          _mv_ssm_flush(plane, rng, None).payload["fields"])
        info = rt.recompile(block=True)
        sites = dict(rt.plan.sites)
        vocab = sites.get("vocab_embed#0")
        check(vocab is not None and vocab.impl == "hot_cache",
              f"archzoo: vocab_embed#0 planned {vocab}")
        check(rt.plan.fastpath_keys("ssm_state", "ssd_fastpath")
              is not None, f"archzoo: no ssd_fastpath: {rt.plan.sites}")
        print(f"[archzoo] plan {({k: v.impl for k, v in sites.items()})} "
              f"passes={info['pass_stats']}")

        fresh = batches(1)[0]
        check(bool((counts(fresh) == 0).all()), "fresh batch is warm")
        same(fresh, "fresh batch (zero-init branch)")
        warm = next(b for b in batches(16) if bool((counts(b) > 0).any()))
        captured = {}
        real = ops.ssd_scan

        def tap(*args, **kw):
            captured["args"], captured["kw"] = args, kw
            return real(*args, **kw)

        ops.ssd_scan = tap            # models.ssd calls ops.ssd_scan
        try:
            same(warm, "warm batch (state-gather branch)")
        finally:
            ops.ssd_scan = real
        check(captured["kw"]["init_state"] is not None
              and bool(captured["kw"]["init_state"].abs().sum() > 0),
              "warm batch gave ssd_scan no saved state")
        print("[archzoo] specialized == generic bit for bit on a fresh "
              "batch (zero init) and a warm one (saved state)")
        ms_spec = run(batches(8))
        profile_steps(torch, "archzoo specialized", rt.step, batches(3))
        sync_spec = host_syncs(torch, rt.step, on_card(batches(2)))

        d0 = rt.stats.deopt_steps
        rt.control_update("ssm_state",
                          _mv_ssm_warm(plane, rng, None).payload["fields"])
        same(batches(1)[0], "the step after ssm_warm")
        check(rt.stats.deopt_steps == d0 + 1, "ssm_warm did not deopt")
        rt.recompile(block=True)
        check(rt.plan.fastpath_keys("ssm_state", "ssd_fastpath") is None,
              f"recompile after ssm_warm kept ssd_fastpath: "
              f"{rt.plan.sites}")
        same(batches(1)[0], "after the declining recompile")
        print(f"[archzoo] ssm_warm deopted; the next recompile declined "
              f"ssd_fastpath: plan "
              f"{({k: v.impl for k, v in rt.plan.sites})}")
        print(f"[archzoo] generic {ms_generic:.3f} ms/step, specialized "
              f"{ms_spec:.3f} ms/step (batch 4 x seq {plane.seq}, median "
              f"of 8); host syncs per step: generic {sync_generic:g}, "
              f"specialized {sync_spec:g}; deopt_steps="
              f"{rt.stats.deopt_steps}")
        return captured["args"], captured["kw"]
    finally:
        rt.close()


def conformance_phase() -> None:
    """The differential harness on the card at smoke scale; mamba2's
    report (weights play no part in its plans) must equal the host's."""
    from repro_torch.testing import run_conformance
    for arch in ("mamba2-1.3b", "jamba-v0.1-52b"):
        t = time.perf_counter()
        rep = run_conformance(arch, "plain", seed=0)
        print(f"[conformance] {arch} plain on the card "
              f"({time.perf_counter() - t:.1f} s): {rep}")
        if arch == "mamba2-1.3b":
            host = run_conformance(arch, "plain", seed=0, device="cpu")
            check(rep == host, f"{arch}: card report != host report {host}")
            print(f"[conformance] {arch}: the card's report equals the "
                  f"host's")


def time_ssd_scan(torch, ssd_scan_cuda, ssd_scan_ref, args, kw):
    x, dt, A, Bm, Cm = args
    chunk, init = kw["chunk"], kw["init_state"]
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    kern = lambda: ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk,
                                 init_state=init)
    plain = lambda: ssd_scan_ref(x, dt, A, Bm, Cm, chunk, init_state=init)
    dy, ds = ssd_compare(torch, ssd_scan_cuda, ssd_scan_ref, "serving path",
                         args, chunk, init, SSD_TOL["f32_normwise"],
                         normwise=True)
    # multiply-adds these inputs need: the lower triangle of C.B per
    # group, of the scores times x per head, C.state and the state update
    tri = sum(L * (L + 1) // 2 for L in
              (min(chunk, S - c0) for c0 in range(0, S, chunk)))
    macs = B * (G * tri * N + H * tri * P + 2 * H * S * P * N)
    elt = x.element_size()
    nbytes = (2 * x.numel() * elt + dt.numel() * 4 + A.numel() * 4
              + (Bm.numel() + Cm.numel()) * elt
              + (2 if init is not None else 1) * B * H * P * N * 4)
    t_ops, t_bytes = 2 * macs / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    from repro_torch.kernels import ops
    n0 = ops.launches().get("ssd_scan", 0)
    res = {
        "ms": device_ms(torch, kern),
        "plain_ms": device_ms(torch, plain),
        "library_ms": None,            # no one PyTorch call computes it
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    check(ops.launches()["ssd_scan"] > n0, "timing did not launch ssd_scan")
    eager = {k: eager_ms(torch, f, iters=10) for k, f in
             (("kernel", kern), ("plain", plain))}
    print(f"[time] ssd_scan eager calls, host enqueue included (ms): "
          f"{eager}")
    print(f"[time] ssd_scan B={B} S={S} H={H} P={P} N={N} G={G} "
          f"chunk={chunk} {x.dtype}: {2 * macs / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB, max |y - plain| {dy:.3e}, max |state - "
          f"plain| {ds:.3e}, {res}")
    return res, max(dy, ds)


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
    from repro_torch.kernels.ref import hot_gather_ref, ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

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

    err = {"hot_gather": kernel_phase(torch, hot_gather_cuda,
                                      hot_gather_ref),
           "ssd_scan": ssd_kernel_phase(torch, ssd_scan_cuda, ssd_scan_ref)}

    # each main path: counts zeroed just before it, read just after it
    launches = {}
    for phase, run, kernels in (
            ("serving", lambda: serving_phase(torch, ops), ("hot_gather",)),
            ("archzoo", lambda: archzoo_phase(torch, ops),
             ("ssd_scan", "hot_gather"))):
        ops.reset_launches()
        t = time.perf_counter()
        out = run()
        counts = ops.launches()
        print(f"[{phase}] launches during the phase: {counts} "
              f"({time.perf_counter() - t:.1f} s)")
        for name in kernels:
            check(counts.get(name, 0) > 0,
                  f"{name} never launched in the {phase} phase")
            launches[name] = launches.get(name, 0) + counts[name]
        if phase == "serving":
            table, hot_ids, idx = out
        else:
            ssd_args, ssd_kw = out

    conformance_phase()

    timing = {"hot_gather": time_hot_gather(torch, hot_gather_cuda,
                                            hot_gather_ref, table, hot_ids,
                                            idx)}
    timing["ssd_scan"], path_err = time_ssd_scan(
        torch, ssd_scan_cuda, ssd_scan_ref, ssd_args, ssd_kw)
    err["ssd_scan"] = max(err["ssd_scan"], path_err)
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches[name],
                            max_abs_err=err[name], **timing[name]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
