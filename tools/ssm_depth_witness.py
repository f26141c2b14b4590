#!/usr/bin/env python
"""How mamba2-1.3b from random weights amplifies a difference in the last
bits with depth, in the JAX reference and in the PyTorch port, on the CPU.

The first ``--layers`` layers of ``mamba2-1.3b`` at every published
width (d_model 2048, 64 SSD heads x P 64, N 128, conv 4, chunk 256), in
``--dtype`` (f32, or bf16 with the model's f32 leaves ``A_log``, ``D``,
``dt_bias`` and ``norm_scale``), each layer drawn by the reference's
``init_layer`` from ``--seed`` and carried to the port by
``tree_from_numpy``.  The input is ``--batch`` x ``--seq`` hidden states
with the embedding's scale (N(0, 1) / sqrt(d_model)) in that dtype, and
the same input moved by one ulp of that dtype in every element.
Both go through each framework's ``layer_forward`` (a prefill from the
zero state, no cache), one layer at a time, so only one layer's weights
are held at once.

Prints, per layer and per framework, how far the layer's outputs for the
two inputs lie apart (max |difference| over max |output|), and how far
the port's output lies from the reference's on the same input.  The last
line is one JSON object with those numbers.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/ssm_depth_witness.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/ssm_depth_witness.py --dtype bf16

About 2 GB of host memory and a minute (f32) or a few (bf16) on 8 cores.
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import params as JP
from repro.models import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import transformer as TT
from repro_torch.models.params import tree_from_numpy

ARCH = "mamba2-1.3b"


def rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    args = ap.parse_args()
    jdt = jnp.float32 if args.dtype == "f32" else jnp.bfloat16

    jcfg = j_get_config(ARCH).replace(n_layers=args.layers)
    tcfg = t_get_config(ARCH).replace(n_layers=args.layers)
    spec = jcfg.pattern[0]
    B, S, D = args.batch, args.seq, jcfg.d_model
    rng = np.random.default_rng(args.seed)
    x0 = jnp.asarray(rng.standard_normal((B, S, D)) / np.sqrt(D), jdt)
    x1 = jnp.nextafter(x0, jnp.asarray(np.inf, jdt))    # one ulp up
    f32 = lambda t: np.asarray(t, np.float32)
    s = jcfg.ssm
    print(f"[witness] {ARCH}: first {args.layers} of "
          f"{j_get_config(ARCH).n_layers} layers, d_model {D}, "
          f"{s.expand * D // s.head_dim} SSD heads x P {s.head_dim}, N "
          f"{s.d_state}, conv {s.conv_width}, chunk {s.chunk}, "
          f"{args.dtype}; input {B} x {S} tokens, perturbed by one ulp in "
          f"every element (max |x1 - x0| / max |x0| "
          f"{rel(f32(x1), f32(x0)):.2e})")

    positions = jnp.arange(S, dtype=jnp.int32)
    jlayer = jax.jit(lambda p, x: JT.layer_forward(p, jcfg, spec, x,
                                                   positions)[0])
    key = jax.random.PRNGKey(args.seed)
    jx = [x0, x1]
    tdt = torch.float32 if args.dtype == "f32" else torch.bfloat16
    tx = [torch.from_numpy(f32(x)).to(tdt) for x in jx]
    rows = []
    for layer in range(args.layers):
        t0 = time.perf_counter()
        ini = JP.Initializer(jax.random.fold_in(key, layer), dtype=jdt)
        jp = JP.unzip(JT.init_layer(ini, jcfg, spec))[0]
        jx = [jlayer(jp, x) for x in jx]
        tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        with torch.no_grad():
            tx = [TT.layer_forward(tp, tcfg, spec, x)[0] for x in tx]
        jo = [f32(x) for x in jx]
        to = [x.float().numpy() for x in tx]
        row = {"layer": layer, "reference": rel(jo[1], jo[0]),
               "port": rel(to[1], to[0]), "port_vs_reference": rel(to[0],
                                                                    jo[0])}
        rows.append(row)
        print(f"[witness] layer {layer}: outputs of x1 vs x0, reference "
              f"{row['reference']:.3e} port {row['port']:.3e} of max|out|; "
              f"port vs reference on x0 {row['port_vs_reference']:.3e} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"arch": ARCH, "dtype": args.dtype, "batch": B,
                      "seq": S, "seed": args.seed, "layers": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
