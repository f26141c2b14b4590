"""Quickstart on the PyTorch port: Morpheus dynamic recompilation of a
serving data plane on one CUDA card.

Build a serving data plane (a small MoE LM with match-action tables),
run skewed traffic through the generic executable, let Morpheus analyze /
instrument / specialize it, and check that the specialized executable
gives the generic one's output bit for bit.  The twin of
``examples/quickstart.py``, with the same configuration, traffic and
prints.

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # host
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import EngineConfig, MorpheusRuntime, SketchConfig
from repro_torch.serving import ServeConfig, build_params, build_tables, \
    make_serve_step, make_synthetic_batch


def main(device: str = "cuda", n: int = 40) -> float:
    """Run the quickstart on ``device`` with ``n`` timed batches per
    plan; returns max |specialized - generic|."""
    cfg = ServeConfig()
    params = build_params(cfg, seed=0, device=device)
    for lp in params["layers"]:                  # a domain-skewed router
        with torch.no_grad():
            lp["moe"]["b_router"][:3] = 6.0

    tables = build_tables(cfg)
    runtime = MorpheusRuntime(
        make_serve_step(cfg), tables, params,
        make_synthetic_batch(cfg, seed=0, device=device),
        cfg=EngineConfig(
            sketch=SketchConfig(sample_every=4, max_hot=4,
                                hot_coverage=0.8),
            features={"vision_enabled": False, "track_sessions": True},
            moe_router_table="router", device=device))
    sync = (torch.cuda.synchronize if runtime.device.type == "cuda"
            else lambda: None)
    try:
        print("static analysis:", runtime.analysis["mutability"])

        def bench():
            ts = []
            for i in range(n):
                b = make_synthetic_batch(cfg, i, 8, "high", device=device)
                t0 = time.time()
                runtime.step(b)
                sync()
                ts.append(time.time() - t0)
            return float(np.median(ts))

        t_generic = bench()
        info = runtime.recompile(block=True)     # the Morpheus cycle
        t_specialized = bench()

        print(f"plan: {info['plan']}  passes: {info['pass_stats']}")
        print(f"hot experts: {runtime.hot_experts()}")
        print(f"generic     {1e3*t_generic:7.2f} ms/batch")
        print(f"specialized {1e3*t_specialized:7.2f} ms/batch "
              f"({t_generic/t_specialized:.2f}x)")

        # semantics: specialized == generic (run_generic replays the
        # generic executable against the live PlaneState, unchanged)
        b = make_synthetic_batch(cfg, 999, 8, "high", device=device)
        out_g = runtime.run_generic(b)
        out_s = runtime.step(b)
        diff = float((out_s - out_g).abs().max())
        print("max |specialized - generic| =", diff)
        return diff
    finally:
        runtime.close()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=40,
                    help="timed batches per plan")
    args = ap.parse_args()
    main(args.device, args.n)
