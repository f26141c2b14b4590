"""Serving driver — the paper's data plane under the Morpheus runtime.

Ported from ``repro.launch.serve``.

    python -m repro_torch.launch.serve --steps 200 --locality high
    python -m repro_torch.launch.serve --steps 200 --no-morpheus  # baseline
    python -m repro_torch.launch.serve --steps 200 --planes 4     # one
                                     # controller driving 4 data planes
    python -m repro_torch.launch.serve --steps 512 --fuse 8 --inflight 4
                                     # fused windows + pipelined loop
    python -m repro_torch.launch.serve --frontend --rate 2000 --requests 600
                                     # open-loop request arrivals through
                                     # the serving frontend
    python -m repro_torch.launch.serve --steps 60 --device cpu
                                     # on the host instead of the card

The serve loop is **pipelined**: up to ``--inflight`` dispatched units
(steps, or ``--fuse K``-step ``step_many`` windows) stay in flight while
the loop places the next unit's batch.  A unit retires when its own
outputs are ready: on the card, a CUDA event recorded on the stream right
after its dispatch, so the step latencies (and the straggler monitor fed
from them) read service time, not host enqueue time.  The defaults
(``--fuse 1 --inflight 1``) reproduce the classic block-per-step loop.

With ``--planes N`` (or ``--controller``) one
:class:`~repro_torch.core.controller.MorpheusController` drives N
runtimes on distinct table sets from one process: shared executable
cache, one bounded recompile worker pool, per-plane sampling duty
cycles.

``--mesh auto`` (the default) spans every visible card with a
``("data",)`` mesh (:func:`~repro_torch.distributed.meshctx.\
data_plane_mesh`): batches and sketches split over the cards, tables
replicated, one process driving them all.  On one card, or on the host,
it resolves to no mesh, as the reference does on a one-device host;
``--mesh none`` forces one device.  The functions also take a prebuilt
:class:`~repro_torch.distributed.meshctx.Mesh` (a repeated-device debug
mesh, for one).  ``stats["n_devices"]`` is the mesh's size.
``--xla-cache-dir`` has no PyTorch meaning and raises, as
``EngineConfig(xla_cache_dir=...)`` does.
"""
from __future__ import annotations

import argparse
import sys
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import ControllerConfig, EngineConfig, MorpheusController, \
    MorpheusRuntime, SketchConfig, StreamingHistogram, plan_batch_shape
from ..distributed.fault import StragglerMonitor
from ..distributed.meshctx import Mesh, data_plane_mesh
from ..serving import ServeConfig, build_fleet, build_params, \
    build_tables, make_request_batch, make_request_rows, \
    make_request_windows, make_serve_step, make_synthetic_batch
from ..serving.frontend import FrontendConfig, OpenLoopDriver, \
    ServingFrontend, bursty_onoff_gaps, poisson_gaps


def _resolve_mesh(mesh, device) -> Optional[Mesh]:
    """``"none"`` -> no mesh; ``"auto"`` -> a ``("data",)`` mesh over
    the visible cards of ``device``'s type, or no mesh when there is one
    (or on the host); a :class:`Mesh` is taken as it is."""
    if isinstance(mesh, Mesh):
        return mesh
    if mesh == "none":
        return None
    if mesh == "auto":
        dev = resolve_device(device)
        return data_plane_mesh(device=dev.type)
    raise TypeError(f"mesh must be 'auto', 'none' or a Mesh, got "
                    f"{mesh!r}")


def _skewed_params(cfg: ServeConfig, seed: int, skew_router: bool,
                   device="cuda"):
    params = build_params(cfg, seed, device=device)
    if skew_router:
        # trained routers are domain-skewed; emulate with an additive
        # per-expert routing bias (DeepSeek-v3-style bias term)
        bias = np.zeros(cfg.n_experts, np.float32)
        bias[:3] = 6.0
        with torch.no_grad():
            for lp in params["layers"]:
                lp["moe"]["b_router"].copy_(torch.from_numpy(bias))
    return params


def _completion(out):
    """A handle on ``out``'s own completion: a CUDA event recorded on its
    stream right after the dispatch (None on the host, where the
    dispatch returned finished outputs)."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(out.device))
        return done
    return None


def _make_drain(pending, lat, on_latency=None):
    """The bounded-in-flight drain shared by both serve loops: wait for
    the oldest dispatched units until at most ``limit`` remain, recording
    each unit's dispatch -> ready latency.  Each pending entry is
    ``(t_dispatch, completion)`` with the completion from
    :func:`_completion`, so a unit waits for its own work, not for units
    dispatched after it.  ``on_latency`` (optional) observes each unit's
    wall seconds as it retires — the straggler monitor's tap."""
    def drain(limit: int) -> None:
        while len(pending) > limit:
            t0, done = pending.popleft()
            if done is not None:
                done.synchronize()
            dt = time.time() - t0
            lat.append(dt)
            if on_latency is not None:
                on_latency(dt)
    return drain


def _drive_pipelined(step_one, make_batch, place, steps, fuse, inflight,
                     on_boundary=None, on_latency=None):
    """The single-plane bounded-in-flight pipelined serve loop: dispatch
    up to ``inflight`` units (steps, or K-step fused windows) before
    waiting on the oldest, placing the next unit's batch while the
    current one computes.  ``step_one(placed)`` dispatches and returns
    the output; ``make_batch(i)`` builds the i-th per-step batch;
    ``place(raw)`` stacks/places one unit's worth of batches;
    ``on_boundary(i, drain)`` fires after every dispatched unit (with the
    drain handle, so a recompile boundary can quiesce the pipeline before
    timing control-plane work).  Returns ``(wall_s, unit_latencies,
    steps_served)``; steps_served rounds ``steps`` up to whole windows,
    and each latency spans dispatch -> ready (at depth > 1 that includes
    queueing behind earlier units)."""
    pending: deque = deque()
    lat = []
    drain = _make_drain(pending, lat, on_latency)

    def prep(i0):
        return place([make_batch(i0 + j) for j in range(fuse)])

    t_start = time.time()
    nxt = prep(0)
    i = 0
    while i < steps:
        unit = nxt
        t0 = time.time()
        out = step_one(unit)
        pending.append((t0, _completion(out)))
        i += fuse
        if i < steps:
            nxt = prep(i)        # the NEXT unit's placement overlaps
        drain(inflight - 1)
        if on_boundary is not None:
            on_boundary(i, drain)
    drain(0)
    return time.time() - t_start, lat, i


def run_serve(steps=200, locality="high", morpheus=True,
              recompile_every=50, batch_size=8, skew_router=True,
              quiet=False, serve_cfg=None, features=None, mesh="auto",
              xla_cache_dir=None, fuse=1, inflight=1, device="cuda"):
    """Drive the serving data plane for ``steps`` batches on ``device``
    and return ``(stats, runtime)``.  ``mesh`` is "auto", "none" or a
    :class:`Mesh` (see the module docstring).  ``fuse=K`` serves K-step
    fused windows through ``runtime.step_many``; ``inflight=N`` keeps
    up to N dispatched units in flight instead of waiting per step."""
    cfg = serve_cfg or ServeConfig()
    mesh = _resolve_mesh(mesh, device)
    if mesh is not None:
        device = mesh.home
    params = _skewed_params(cfg, 0, skew_router, device)
    tables = build_tables(cfg)
    step_fn = make_serve_step(cfg)
    n_dev = mesh.size if mesh is not None else 1
    ecfg = EngineConfig(
        sketch=SketchConfig(sample_every=4, max_hot=4, hot_coverage=0.8),
        features=features or {"vision_enabled": False,
                              "track_sessions": True},
        moe_router_table="router",
        xla_cache_dir=xla_cache_dir,
        device=device, mesh=mesh)
    rt = MorpheusRuntime(step_fn, tables, params,
                         make_synthetic_batch(cfg, 0, batch_size,
                                              device=device),
                         cfg=ecfg, enable=morpheus)

    def make_batch(i):
        return make_synthetic_batch(cfg, i, batch_size, locality=locality,
                                    device=device)

    def place(raw):
        return (rt.place_batch(raw, fused=True) if fuse > 1
                else rt.place_batch(raw[0]))

    def step_one(unit):
        return rt.step_many(unit, k=fuse) if fuse > 1 else rt.step(unit)

    boundary = {"last": 0, "spent": 0.0}

    def on_boundary(i, drain):
        if not morpheus or i // recompile_every <= boundary["last"]:
            return
        boundary["last"] = i // recompile_every
        drain(0)              # quiesce: in-flight windows are serving
        t0 = time.time()      # time, not recompile time
        info = rt.recompile(block=True)
        boundary["spent"] += time.time() - t0
        if not quiet:
            print(f"[serve] recompile@{i}: {info['plan']} "
                  f"t1={info['t1']*1e3:.0f}ms sites={info['n_sites']} "
                  f"hot_experts={rt.hot_experts()}", flush=True)

    # straggler mitigation tap: every retired unit's wall time feeds the
    # monitor; a unit slower than threshold x the rolling median (after
    # `patience` suspects) fires a mitigation event into RuntimeStats
    straggler = StragglerMonitor(
        on_straggler=lambda s, sec: rt.stats.bump(straggler_events=1))
    observed = {"n": 0}

    def on_latency(seconds):
        observed["n"] += 1
        straggler.observe(observed["n"], seconds)

    wall, lat, served = _drive_pipelined(
        step_one, make_batch, place, steps, fuse, inflight, on_boundary,
        on_latency)
    # net serving time: recompile boundaries are not serving work
    serve_wall = max(wall - boundary["spent"], 1e-9)
    rt.stats.observe_many({"step_latency_s": [t / fuse for t in lat]})
    stats = {
        "steps": served,
        "n_devices": n_dev,
        "fuse": fuse,
        "inflight": inflight,
        "req_per_s": served * batch_size / serve_wall,
        "p50_ms": rt.stats.quantile("step_latency_s", 0.50) * 1e3,
        "p99_ms": rt.stats.quantile("step_latency_s", 0.99) * 1e3,
        "wall_s": wall,
        "runtime": rt.stats,
        "hot_experts": rt.hot_experts(),
        "straggler_events": rt.stats.straggler_events,
    }
    if not quiet:
        print(f"[serve] locality={locality} morpheus={morpheus} "
              f"devices={n_dev} fuse={fuse} inflight={inflight} "
              f"{stats['req_per_s']:.1f} req/s p50={stats['p50_ms']:.1f}ms "
              f"p99={stats['p99_ms']:.1f}ms deopt={rt.stats.deopt_steps} "
              f"instr={rt.stats.instr_steps} "
              f"reval={rt.stats.revalidations} "
              f"exec_cache={rt.stats.cache_hits}h/"
              f"{rt.stats.cache_misses}m "
              f"straggler_events={rt.stats.straggler_events}", flush=True)
    return stats, rt


def run_controller_serve(planes=2, steps=200, locality="high",
                         recompile_every=50, batch_size=8,
                         skew_router=True, quiet=False, serve_cfg=None,
                         workers=2, mesh="auto", xla_cache_dir=None,
                         fuse=1, inflight=1, device="cuda"):
    """One :class:`MorpheusController` driving ``planes`` data planes
    (distinct TableSets, per-plane traffic skew) from one process.
    Recompiles go through the controller's bounded worker pool; each
    plane's sampling duty cycle adapts independently.  Returns
    ``(stats, controller, runtimes)``."""
    cfg = serve_cfg or ServeConfig()
    mesh = _resolve_mesh(mesh, device)
    if mesh is not None:
        device = mesh.home
    params = _skewed_params(cfg, 0, skew_router, device)
    controller = MorpheusController(ControllerConfig(workers=workers))
    ecfg_kw = dict(
        sketch=SketchConfig(sample_every=4, max_hot=4, hot_coverage=0.8),
        moe_router_table="router",
        # identical step fn / schemas / shapes across the fleet: every
        # plane shares the controller's cache, so the generic executable
        # is built once, not N times
        cache_ns="serve-fleet",
        xla_cache_dir=xla_cache_dir,
        device=device, mesh=mesh)
    rts = []
    try:
        for p, (step_fn, tables) in enumerate(build_fleet(cfg, planes)):
            ecfg = EngineConfig(features={"vision_enabled": False,
                                          "track_sessions": True},
                                **ecfg_kw)
            rts.append(MorpheusRuntime(
                step_fn, tables, params,
                make_synthetic_batch(cfg, 0, batch_size, device=device),
                cfg=ecfg, controller=controller, plane_id=f"plane-{p}"))
    except BaseException:
        controller.close()
        raise

    t_start = time.time()
    cycle_spent = 0.0
    lat = []
    pending: deque = deque()
    drain = _make_drain(pending, lat)

    i = 0
    prep_s = 0.0
    while i < steps:
        for p, rt in enumerate(rts):
            # each plane sees its own traffic skew (hot_offset): the
            # controller must keep their plans independent
            t0 = time.time()
            raw = make_request_windows(
                cfg, 1000 * p + i, fuse, batch_size, device=device,
                locality=locality, hot_offset=7 * p)
            placed = (rt.place_batch(raw, fused=True) if fuse > 1
                      else rt.place_batch(raw[0]))
            prep_s += time.time() - t0
            t0 = time.time()
            out = (rt.step_many(placed, k=fuse) if fuse > 1
                   else rt.step(placed))
            pending.append((t0, _completion(out)))
            drain(inflight - 1)
        i += fuse
        if (i // recompile_every) > ((i - fuse) // recompile_every):
            drain(0)
            t0 = time.time()
            n = controller.schedule_all()
            controller.drain()
            cycle_spent += time.time() - t0
            if not quiet:
                duty = {pid: f"{s['duty_cycle']:.2f}" for pid, s in
                        controller.stats().sampling.items()}
                print(f"[serve] cycle@{i}: scheduled={n} "
                      f"duty={duty}", flush=True)
    drain(0)
    wall = time.time() - t_start
    served = i
    # net of controller cycles, and of batch generation only when it
    # serializes with serving (inflight == 1) — matching run_serve
    serve_wall = max(wall - cycle_spent
                     - (prep_s if inflight == 1 else 0.0), 1e-9)
    lat_hist = StreamingHistogram()
    lat_hist.observe_all(t / fuse for t in lat)
    cstats = controller.stats()
    stats = {
        "planes": planes,
        "n_devices": mesh.size if mesh is not None else 1,
        "steps": served,
        "fuse": fuse,
        "inflight": inflight,
        "req_per_s": served * planes * batch_size / serve_wall,
        "p50_ms": lat_hist.quantile(0.50) * 1e3,
        "p99_ms": lat_hist.quantile(0.99) * 1e3,
        "wall_s": wall,
        "controller": cstats,
    }
    if not quiet:
        for pid, rt in zip(cstats.planes, rts):
            ps = cstats.planes[pid]
            samp = cstats.sampling[pid]
            print(f"[serve]   {pid}: steps={ps['steps']} "
                  f"recompiles={ps['recompiles']} "
                  f"reval={ps['revalidations']} "
                  f"deopt={ps['deopt_steps']} "
                  f"duty={samp['duty_cycle']:.2f} "
                  f"armed={samp['armed']} "
                  f"hot_experts={rt.hot_experts()}", flush=True)
        sch = cstats.scheduler
        print(f"[serve] controller: planes={planes} "
              f"devices={stats['n_devices']} "
              f"{stats['req_per_s']:.1f} req/s p50={stats['p50_ms']:.1f}ms "
              f"scheduled={sch['scheduled']} "
              f"coalesced={sch['coalesced']} "
              f"completed={sch['completed']} "
              f"cache_hit_rate={cstats.cache_hit_rate:.2f} "
              f"recompiles={cstats.totals.get('recompiles', 0)}",
              flush=True)
    return stats, controller, rts


def _plane_request_stats(rt) -> dict:
    """Per-plane request-level digest: counters + SLO attainment +
    latency quantiles from the shared histogram series."""
    s = rt.stats
    deadlined = s.slo_met + s.slo_missed
    return {
        "completed": s.requests_completed,
        "rejected": s.requests_rejected,
        "shed": s.requests_shed,
        "slo_met": s.slo_met,
        "slo_missed": s.slo_missed,
        "slo_attainment": (s.slo_met / deadlined) if deadlined else None,
        "p50_ms": s.quantile("request_total_s", 0.50) * 1e3,
        "p99_ms": s.quantile("request_total_s", 0.99) * 1e3,
        "queue_p99_ms": s.quantile("request_queue_wait_s", 0.99) * 1e3,
        "batches": s.batches_formed,
        "pad_rows": s.pad_rows,
        "mispredicts": s.shape_mispredicts,
        "deopt_steps": s.deopt_steps,
        "batch_shape": plan_batch_shape(rt.plan),
    }


def run_frontend_serve(planes=1, requests=600, rate=150.0,
                       arrival="poisson", batch_size=8, slo_ms=100.0,
                       max_wait_ms=2.0, queue_cap=512, window_k_max=4,
                       inflight=2, recompile_every_s=0.25,
                       locality="high", skew_router=True, quiet=False,
                       serve_cfg=None, mesh="auto", workers=2,
                       xla_cache_dir=None, seed=0, keep_outputs=False,
                       device="cuda"):
    """Request-level serving: open-loop synthetic arrivals (Poisson or
    bursty ON/OFF at ``rate`` req/s) through one
    :class:`~repro_torch.serving.frontend.ServingFrontend` per plane, all
    planes under ONE controller: arrivals -> admission -> dynamic
    batching -> fused ``step_many`` dispatch -> arrival-profile snapshot
    -> recompile -> BatchShapePass bucket/K selection.

    Returns ``(stats, controller, runtimes, frontends)`` — ``stats``
    carries per-plane AND fleet-level SLO attainment."""
    cfg = serve_cfg or ServeConfig()
    mesh = _resolve_mesh(mesh, device)
    if mesh is not None:
        device = mesh.home
    params = _skewed_params(cfg, seed, skew_router, device)
    controller = MorpheusController(ControllerConfig(workers=workers))
    ecfg_kw = dict(
        sketch=SketchConfig(sample_every=4, max_hot=4, hot_coverage=0.8),
        moe_router_table="router", cache_ns="serve-fleet",
        xla_cache_dir=xla_cache_dir, device=device, mesh=mesh)
    fcfg = FrontendConfig(capacity=queue_cap, max_batch=batch_size,
                          max_wait_s=max_wait_ms * 1e-3,
                          window_k_max=window_k_max, inflight=inflight,
                          default_slo_s=slo_ms * 1e-3)
    rts, frontends = [], []
    try:
        for p, (step_fn, tables) in enumerate(build_fleet(cfg, planes)):
            ecfg = EngineConfig(features={"vision_enabled": False,
                                          "track_sessions": True},
                                **ecfg_kw)
            rt = MorpheusRuntime(step_fn, tables, params,
                                 make_synthetic_batch(cfg, seed,
                                                      batch_size,
                                                      device=device),
                                 cfg=ecfg, controller=controller,
                                 plane_id=f"plane-{p}")
            rts.append(rt)
            frontends.append(ServingFrontend(rt, fcfg,
                                             keep_outputs=keep_outputs))
    except BaseException:
        controller.close()
        raise

    # ---- warm every window shape the batcher can form: each ladder
    # bucket at K=1 plus the primary bucket at K=2..k_max (the active
    # plan, its instrumented twin and the generic deopt target) ----
    ladder = fcfg.ladder_resolved()
    warm_rows = make_request_rows(cfg, seed, ladder[-1], locality=locality)
    for rt in rts:
        for b in ladder:
            batch = make_request_batch(warm_rows[:b], b)
            rt.warm_fused([batch])
        primary = make_request_batch(warm_rows, ladder[-1])
        for k in range(2, fcfg.window_k_max + 1):
            rt.warm_fused([primary] * k)

    # ---- the open-loop arrival trace ----
    gap_fn = {"poisson": poisson_gaps, "onoff": bursty_onoff_gaps}
    gaps = gap_fn[arrival](rate, requests, seed=seed)
    rows = make_request_rows(cfg, seed + 1, requests, locality=locality)
    driver = OpenLoopDriver(frontends, rows, gaps,
                            deadline_s=slo_ms * 1e-3)

    for fe in frontends:
        fe.start()
    t_start = time.time()
    driver.start()
    # recompile ticker: periodic non-blocking schedule_all while the
    # trace replays — the Morpheus control loop running beside serving
    while driver._thread is not None and driver._thread.is_alive():
        time.sleep(recompile_every_s)
        controller.schedule_all()
    driver.join()
    for fe in frontends:
        fe.drain(timeout=120.0)
    wall = max(time.time() - t_start, 1e-9)
    controller.schedule_all()
    controller.drain()
    for fe in frontends:
        fe.stop(drain=True)

    # ---- per-plane + fleet accounting ----
    per_plane = {rt.plane_id: _plane_request_stats(rt) for rt in rts}
    fleet_hist = StreamingHistogram()
    for rt in rts:
        h = rt.stats.hist("request_total_s")
        if h is not None:
            fleet_hist.merge(h)
    met = sum(ps["slo_met"] for ps in per_plane.values())
    missed = sum(ps["slo_missed"] for ps in per_plane.values())
    completed = sum(ps["completed"] for ps in per_plane.values())
    stats = {
        "planes": planes,
        "arrival": arrival,
        "rate_req_s": rate,
        "requests": requests,
        "wall_s": wall,
        "completed": completed,
        "rejected": sum(ps["rejected"] for ps in per_plane.values()),
        "shed": sum(ps["shed"] for ps in per_plane.values()),
        "goodput_req_s": met / wall,
        "slo_attainment": (met / (met + missed)) if met + missed else None,
        "p50_ms": fleet_hist.quantile(0.50) * 1e3,
        "p99_ms": fleet_hist.quantile(0.99) * 1e3,
        "per_plane": per_plane,
    }
    if not quiet:
        for pid, ps in per_plane.items():
            att = (f"{ps['slo_attainment']*100:.1f}%"
                   if ps["slo_attainment"] is not None else "n/a")
            print(f"[serve]   {pid}: completed={ps['completed']} "
                  f"rejected={ps['rejected']} shed={ps['shed']} "
                  f"slo={att} p50={ps['p50_ms']:.1f}ms "
                  f"p99={ps['p99_ms']:.1f}ms "
                  f"queue_p99={ps['queue_p99_ms']:.1f}ms "
                  f"batch_shape={ps['batch_shape']} "
                  f"mispredicts={ps['mispredicts']} "
                  f"deopt={ps['deopt_steps']}", flush=True)
        att = (f"{stats['slo_attainment']*100:.1f}%"
               if stats["slo_attainment"] is not None else "n/a")
        print(f"[serve] fleet: planes={planes} arrival={arrival} "
              f"offered={rate:.0f} req/s completed={completed} "
              f"goodput={stats['goodput_req_s']:.1f} req/s "
              f"slo={att} p50={stats['p50_ms']:.1f}ms "
              f"p99={stats['p99_ms']:.1f}ms", flush=True)
    return stats, controller, rts, frontends


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--locality", default="high",
                    choices=["high", "low", "none"])
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--recompile-every", type=int, default=50)
    ap.add_argument("--no-morpheus", action="store_true")
    ap.add_argument("--mesh", default="auto", choices=["auto", "none"],
                    help="'auto': a data-parallel mesh over every "
                         "visible card (none when one is visible); "
                         "'none': force single-device")
    ap.add_argument("--device", default="cuda",
                    help="device the planes run on (default: the card; "
                         "'cpu' runs on the host)")
    ap.add_argument("--planes", type=int, default=1, metavar="N",
                    help="serve N data planes (distinct table sets) "
                         "under ONE controller; implies --controller")
    ap.add_argument("--controller", action="store_true",
                    help="route recompiles through a MorpheusController "
                         "fleet even for a single plane")
    ap.add_argument("--workers", type=int, default=2,
                    help="controller recompile worker pool size")
    ap.add_argument("--xla-cache-dir", default=None, metavar="DIR",
                    help="the reference's persistent XLA compilation "
                         "cache; it has no PyTorch meaning and raises")
    ap.add_argument("--fuse", type=int, default=1, metavar="K",
                    help="serve K-step fused windows (runtime.step_many) "
                         "— one Python dispatch per K steps")
    ap.add_argument("--inflight", type=int, default=1, metavar="N",
                    help="bounded-in-flight pipelined serve loop: keep "
                         "up to N dispatched steps/windows in flight "
                         "instead of waiting per step")
    fr = ap.add_argument_group(
        "frontend", "request-level serving (open-loop arrivals through "
        "the repro_torch.serving.frontend queue/batcher instead of "
        "pre-formed batches; combines with --planes N)")
    fr.add_argument("--frontend", action="store_true",
                    help="serve synthetic open-loop request arrivals "
                         "through the serving frontend")
    fr.add_argument("--requests", type=int, default=600,
                    help="number of requests in the arrival trace")
    fr.add_argument("--rate", type=float, default=150.0,
                    help="offered load in requests/sec")
    fr.add_argument("--arrival", default="poisson",
                    choices=["poisson", "onoff"],
                    help="arrival process: memoryless Poisson, or "
                         "bursty ON/OFF at the same long-run rate")
    fr.add_argument("--slo-ms", type=float, default=100.0,
                    help="per-request deadline (SLO), milliseconds")
    fr.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="batch-formation wait budget, milliseconds")
    fr.add_argument("--queue-cap", type=int, default=512,
                    help="request queue bound (admission control)")
    args = ap.parse_args(argv)
    if args.fuse < 1 or args.inflight < 1:
        print("[serve] --fuse and --inflight must be >= 1",
              file=sys.stderr)
        return 2
    if args.frontend:
        if args.no_morpheus:
            print("[serve] --no-morpheus does not combine with "
                  "--frontend (use FrontendConfig against a disabled "
                  "runtime in code for that baseline)",
                  file=sys.stderr)
            return 2
        _, controller, rts, _ = run_frontend_serve(
            planes=args.planes, requests=args.requests, rate=args.rate,
            arrival=args.arrival, batch_size=args.batch_size,
            slo_ms=args.slo_ms, max_wait_ms=args.max_wait_ms,
            queue_cap=args.queue_cap, inflight=args.inflight,
            mesh=args.mesh, workers=args.workers,
            xla_cache_dir=args.xla_cache_dir, device=args.device)
        controller.close()
        return 0
    if args.planes > 1 or args.controller:
        if args.no_morpheus:
            print("[serve] --no-morpheus is a single-plane baseline "
                  "mode; it does not combine with --planes/--controller",
                  file=sys.stderr)
            return 2
        _, controller, rts = run_controller_serve(
            planes=args.planes, steps=args.steps,
            locality=args.locality,
            recompile_every=args.recompile_every,
            batch_size=args.batch_size, workers=args.workers,
            mesh=args.mesh, xla_cache_dir=args.xla_cache_dir,
            fuse=args.fuse, inflight=args.inflight, device=args.device)
        controller.close()
        return 0
    _, rt = run_serve(steps=args.steps, locality=args.locality,
                      morpheus=not args.no_morpheus,
                      recompile_every=args.recompile_every,
                      batch_size=args.batch_size, mesh=args.mesh,
                      xla_cache_dir=args.xla_cache_dir,
                      fuse=args.fuse, inflight=args.inflight,
                      device=args.device)
    rt.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
