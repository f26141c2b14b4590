#!/usr/bin/env python
"""How phi3.5-MoE from random weights amplifies a difference in the last
bits with depth, in the JAX reference and in the PyTorch port, on the CPU.

The first ``--layers`` layers of ``phi3.5-moe-42b-a6.6b`` at every
published width (d_model 4096, 32 / 8 heads x 128, 16 experts top-2,
expert d_ff 6400), f32, each layer drawn by the reference's
``init_layer`` from ``--seed`` and carried to the port by
``tree_from_numpy``.  The input is ``--batch`` x ``--seq`` hidden states
with the embedding's scale (N(0, 1) / sqrt(d_model)) and the same input
moved by one ulp in every element.  Both go through each framework's
``layer_forward`` (a causal prefill, no cache), one layer at a time, so
only one layer's weights (~5 GB in f32) are held at once.

Prints, per layer and per framework, how far the router logits of the
two inputs lie apart (max |difference| over max |logits|), how many
tokens the router sends to another top-2 set, and how far the layer's
outputs lie apart (normwise); and how far the port's router logits lie
from the reference's on the same input.  The last line is one JSON
object with those numbers.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/moe_depth_witness.py

About 10 GB of host memory at the peak and a few minutes on 8 cores.
"""
from __future__ import annotations

import argparse
import gc
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import moe as JMOE
from repro.models import params as JP
from repro.models import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.models.params import tree_from_numpy

ARCH = "phi3.5-moe-42b-a6.6b"


def tapped(mod, sink):
    """Wraps ``mod.route`` so that every call appends its router logits
    to ``sink``; returns the original, to put back."""
    real = mod.route

    def tap(*a, **kw):
        out = real(*a, **kw)
        sink.append(out[2])
        return out
    mod.route = tap
    return real


def rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def flips(a: np.ndarray, b: np.ndarray, k: int) -> int:
    """Tokens whose top-k expert sets differ between logits a and b."""
    top = lambda t: np.sort(np.argsort(-t, axis=-1, kind="stable")[:, :k], -1)
    return int((top(a) != top(b)).any(-1).sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    jcfg = j_get_config(ARCH).replace(n_layers=args.layers)
    tcfg = t_get_config(ARCH).replace(n_layers=args.layers)
    K = jcfg.moe.top_k
    B, S, D = args.batch, args.seq, jcfg.d_model
    rng = np.random.default_rng(args.seed)
    x0 = (rng.standard_normal((B, S, D)) / np.sqrt(D)).astype(np.float32)
    x1 = np.nextafter(x0, np.float32(np.inf))           # one ulp up
    print(f"[witness] {ARCH}: first {args.layers} of "
          f"{j_get_config(ARCH).n_layers} layers, d_model {D}, "
          f"{jcfg.n_heads}/{jcfg.n_kv_heads} heads x {jcfg.head_dim_}, "
          f"{jcfg.moe.num_experts} experts top-{K} x d_ff "
          f"{jcfg.moe.expert_d_ff}, f32; input {B} x {S} tokens, perturbed "
          f"by one ulp in every element (max |x1 - x0| / max |x0| "
          f"{rel(x1, x0):.2e})")

    positions = jnp.arange(S, dtype=jnp.int32)
    key = jax.random.PRNGKey(args.seed)
    jx = [jnp.asarray(x0), jnp.asarray(x1)]
    tx = [torch.from_numpy(x0.copy()), torch.from_numpy(x1.copy())]
    rows = []
    for layer in range(args.layers):
        t0 = time.perf_counter()
        spec = jcfg.pattern[layer % len(jcfg.pattern)]
        ini = JP.Initializer(jax.random.fold_in(key, layer),
                             dtype=jnp.float32)
        jp = JP.unzip(JT.init_layer(ini, jcfg, spec))[0]
        # the reference
        jlog = []
        real = tapped(JMOE, jlog)
        try:
            jx = [JT.layer_forward(jp, jcfg, spec, x, positions)[0]
                  for x in jx]
        finally:
            JMOE.route = real
        jlog = [np.asarray(t) for t in jlog]
        # the port, on the same weights
        tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        del jp
        gc.collect()
        tlog = []
        real = tapped(TMOE, tlog)
        try:
            with torch.no_grad():
                tx = [TT.layer_forward(tp, tcfg, spec, x)[0] for x in tx]
        finally:
            TMOE.route = real
        tlog = [t.numpy() for t in tlog]
        del tp
        gc.collect()
        jo = [np.asarray(x) for x in jx]
        to = [x.numpy() for x in tx]
        row = {
            "layer": layer,
            "reference": {"router_logits": rel(jlog[1], jlog[0]),
                          "flips": flips(jlog[1], jlog[0], K),
                          "output": rel(jo[1], jo[0])},
            "port": {"router_logits": rel(tlog[1], tlog[0]),
                     "flips": flips(tlog[1], tlog[0], K),
                     "output": rel(to[1], to[0])},
            "port_vs_reference": {"router_logits": rel(tlog[0], jlog[0]),
                                  "flips": flips(tlog[0], jlog[0], K)},
        }
        rows.append(row)
        r, p, c = row["reference"], row["port"], row["port_vs_reference"]
        print(f"[witness] layer {layer}: router logits of x1 vs x0 "
              f"reference {r['router_logits']:.3e} port "
              f"{p['router_logits']:.3e} of max|logits|, flips reference "
              f"{r['flips']} port {p['flips']} of {B * S} tokens; outputs "
              f"reference {r['output']:.3e} port {p['output']:.3e}; port vs "
              f"reference on x0: logits {c['router_logits']:.3e}, flips "
              f"{c['flips']} ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"arch": ARCH, "batch": B, "seq": S,
                      "seed": args.seed, "layers": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
