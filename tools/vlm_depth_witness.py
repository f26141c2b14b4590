#!/usr/bin/env python
"""How pixtral-12b from random weights amplifies a difference in the last
bits with depth, in the JAX reference and in the PyTorch port, on the
CPU.

pixtral-12b's decoder at every published width (d_model 5120, 32 / 8
heads x 128, d_ff 14336 gated SiLU, RoPE theta 1e6, no softcap),
``--layers`` layers in ``--dtype``, each drawn by the reference's
``init_layer`` from ``--seed`` and carried to the port by
``tree_from_numpy``.  The input is ``--batch`` sequences of ``--media``
media embeddings drawn from N(0, 1), as ``chip_smoke.py`` draws them,
followed by ``--seq`` text rows with the embedding's scale (N(0, 1) /
sqrt(d_model)); it also goes through moved by one ulp of the dtype in
every element.  Both go through each framework's ``layer_forward``
(causal, no cache), one layer at a time.

First it prints what makes the model sensitive: the attention logits
of layer 0 (the reference's ``wq`` and ``wk`` are drawn with ``fan_in =
shape[-2]``, the head count, so q and k are ~sqrt(d_model / H) = 12.6
and q.k / sqrt(128) has a std of ~300, with no softcap), their std and
the mean largest softmax weight of a row (near 1: attention close to an
argmax, where a near-tie moves a row's output by a whole value vector).
Then, per layer and per framework, how far the layer's outputs for the
two inputs lie apart (max |difference| over max |output|), and how far
the port's output lies from the reference's on the same input.  The
last line is one JSON object with those numbers.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/vlm_depth_witness.py --dtype bf16

About 4 GB of host memory and under a minute on 8 cores at the defaults.
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
from repro.models import layers as JL
from repro.models import params as JP
from repro.models import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import transformer as TT
from repro_torch.models.params import tree_from_numpy

ARCH = "pixtral-12b"


def rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--media", type=int, default=64)
    ap.add_argument("--seq", type=int, default=192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="bf16")
    args = ap.parse_args()
    jdt = jnp.float32 if args.dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if args.dtype == "f32" else torch.bfloat16

    jcfg = j_get_config(ARCH)
    tcfg = t_get_config(ARCH)
    spec = jcfg.pattern[0]
    B, D, S = args.batch, jcfg.d_model, args.media + args.seq
    f32 = lambda t: np.asarray(t, np.float32)
    rng = np.random.default_rng(args.seed)
    key = jax.random.PRNGKey(args.seed)

    def draw(layer):
        ini = JP.Initializer(jax.random.fold_in(key, layer), dtype=jdt)
        jp = JP.unzip(JT.init_layer(ini, jcfg, spec))[0]
        return jp, tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

    x = np.concatenate([rng.standard_normal((B, args.media, D)),
                        rng.standard_normal((B, args.seq, D)) / np.sqrt(D)],
                       axis=1)
    x = jnp.asarray(x, jdt)
    jx = [x, jnp.nextafter(x, jnp.asarray(np.inf, jdt))]
    # what makes the model sensitive: layer 0's attention logits
    jp0, _ = draw(0)
    h = f32(JL.rmsnorm(jp0["attn_norm"], x, jcfg.rms_eps))
    q = np.einsum("bsd,dhk->bshk", h, f32(jp0["attn"]["wq"]))
    k = np.einsum("bsd,dhk->bshk", h, f32(jp0["attn"]["wk"]))
    G = jcfg.n_heads // jcfg.n_kv_heads
    k = np.repeat(k, G, axis=2)
    logits = np.einsum("bshk,bthk->bhst", q, k) / np.sqrt(jcfg.head_dim_)
    logits = np.where(np.tril(np.ones((S, S), bool)), logits, -np.inf)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    top = float((w.max(-1) / w.sum(-1)).mean())
    std = float(logits[np.isfinite(logits)].std())
    print(f"[witness] {ARCH}: {args.layers} layers at every published "
          f"width, {args.dtype}; layer 0: q std {q.std():.2f}, causal "
          f"attention logits (q.k / sqrt({jcfg.head_dim_}), before RoPE) "
          f"std {std:.2f}, mean largest softmax weight of a row {top:.4f}")
    print(f"[witness] input {B} x ({args.media} media + {args.seq} text), "
          f"perturbed by one ulp in every element (max |x1 - x0| / max |x0| "
          f"{rel(f32(jx[1]), f32(jx[0])):.2e})")

    positions = jnp.arange(S, dtype=jnp.int32)
    jlayer = jax.jit(lambda p, x: JT.layer_forward(p, jcfg, spec, x,
                                                   positions)[0])
    tx = [torch.from_numpy(np.array(f32(x))).to(tdt) for x in jx]
    rows = []
    for layer in range(args.layers):
        t0 = time.perf_counter()
        jp, tp = draw(layer)
        jx = [jlayer(jp, x) for x in jx]
        with torch.no_grad():
            tx = [TT.layer_forward(tp, tcfg, spec, x, 0)[0] for x in tx]
        jo = [f32(x) for x in jx]
        to = [x.float().numpy() for x in tx]
        row = {"layer": layer, "reference": rel(jo[1], jo[0]),
               "port": rel(to[1], to[0]),
               "port_vs_reference": rel(to[0], jo[0])}
        rows.append(row)
        print(f"[witness] layer {layer}: outputs of x1 vs x0, reference "
              f"{row['reference']:.3e} port {row['port']:.3e} of max|out|; "
              f"port vs reference on x0 {row['port_vs_reference']:.3e} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"arch": ARCH, "dtype": args.dtype, "batch": B,
                      "media": args.media, "seq": args.seq,
                      "seed": args.seed, "logit_std": std,
                      "top_weight": top, "layers": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
