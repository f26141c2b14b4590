"""End-to-end serving driver under drifting traffic on the PyTorch port
(the paper's Fig 10 scenario): the request mix changes every
``phase_steps`` batches; Morpheus tracks the heavy hitters, recompiles
on a cadence, deopts on a control-plane update, and re-specializes.
The twin of ``examples/serve_specialized.py``, with the same
configuration, phases and prints.

    PYTHONPATH=src python examples/serve_specialized_torch.py         # card
    PYTHONPATH=src python examples/serve_specialized_torch.py --device cpu
    PYTHONPATH=src python examples/serve_specialized_torch.py --mesh auto
                       # every visible card as one ("data",) mesh

``--mesh auto`` spans the visible cards (no mesh with one card, or on
the host); ``--mesh debug4`` runs a 4-entry mesh that repeats the one
device, the shards one after another.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import EngineConfig, MorpheusRuntime, SketchConfig
from repro_torch.distributed.meshctx import Mesh, data_plane_mesh
from repro_torch.serving import ServeConfig, build_params, build_tables, \
    make_serve_step, make_synthetic_batch

PHASES = [("uniform", dict(locality="none")),
          ("hot-set-A", dict(locality="high", hot_offset=0)),
          ("hot-set-B", dict(locality="high", hot_offset=11)),
          ("low-locality", dict(locality="low"))]


def resolve_mesh(mesh: str, device: str):
    if mesh == "none":
        return None
    if mesh == "auto":
        return data_plane_mesh(device=torch.device(device).type)
    if mesh == "debug4":
        return Mesh([device] * 4, ("data",))
    raise ValueError(f"--mesh {mesh!r}: 'none', 'auto' or 'debug4'")


def main(device: str = "cuda", mesh: str = "none",
         phase_steps: int = 30, recompile_every: int = 10) -> dict:
    """Run the scenario; returns the runtime's stats snapshot plus the
    hot experts after each phase (``"phases"``)."""
    cfg = ServeConfig()
    m = resolve_mesh(mesh, device)
    if m is not None:
        device = m.home
    params = build_params(cfg, seed=0, device=device)
    for lp in params["layers"]:                  # a domain-skewed router
        with torch.no_grad():
            lp["moe"]["b_router"][:3] = 6.0
    rt = MorpheusRuntime(
        make_serve_step(cfg), build_tables(cfg), params,
        make_synthetic_batch(cfg, seed=0, device=device),
        cfg=EngineConfig(
            sketch=SketchConfig(sample_every=4, max_hot=4, hot_coverage=0.6),
            features={"vision_enabled": False, "track_sessions": True},
            moe_router_table="router", device=device, mesh=m))
    n_dev = m.size if m is not None else 1
    print(f"serving on {device} ({n_dev} device(s) in the mesh)")
    hot_by_phase = []
    try:
        step = 0
        for phase, kw in PHASES:
            lat = []
            for _ in range(phase_steps):
                b = make_synthetic_batch(cfg, seed=step, batch_size=8,
                                         device=device, **kw)
                t0 = time.time()
                out = rt.step(b)
                if out.is_cuda:
                    torch.cuda.synchronize(out.device)
                lat.append(time.time() - t0)
                step += 1
                if step % recompile_every == 0:
                    rt.recompile(block=True)
            med = float(np.median(lat))
            hot_by_phase.append(rt.hot_experts())
            print(f"{phase:14s} {8 / med:8.1f} req/s   "
                  f"plan={rt.plan.label:14s} hot_experts={rt.hot_experts()}")

        # a control-plane update mid-flight: the guard deopts, a
        # recompile heals
        print("\ncontrol-plane update (temperature push)...")
        rt.control_update("req_class", {
            "temperature": np.full(cfg.n_classes, 1.3, np.float32)})
        rt.step(make_synthetic_batch(cfg, seed=step, batch_size=8,
                                     locality="high", device=device))
        print(f"deopt steps: {rt.stats.deopt_steps} (guard caught the "
              f"update)")
        rt.recompile(block=True)
        print(f"re-specialized: {rt.plan.label}, version "
              f"{rt.plan.version}")
        s = rt.stats.snapshot()
        print(f"\ntotals: {s['steps']} steps, {s['recompiles']} recompiles,"
              f" {s['instr_steps']} instrumented, t1~"
              f"{1e3 * np.median(s['t1_history']):.0f}ms t2~"
              f"{1e3 * np.median(s['t2_history']):.0f}ms")
        return {**s, "phases": hot_by_phase, "n_devices": n_dev,
                "plan_label": rt.plan.label}
    finally:
        rt.close()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the card by default; 'cpu' runs on the host")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "auto", "debug4"])
    ap.add_argument("--phase-steps", type=int, default=30)
    args = ap.parse_args()
    main(args.device, args.mesh, args.phase_steps)
