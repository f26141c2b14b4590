#!/usr/bin/env python
"""How the gradient of a starcoder2-shaped model from random weights grows
with depth, in the JAX reference and in the PyTorch port, on the CPU.

starcoder2-3b's layer kind (GQA, ungated GELU MLP, tied embeddings, RoPE
theta 1e5) at a reduced width (``--d-model``, ``--heads`` / ``--kv-heads``
x ``--head-dim``, ``--d-ff``, ``--vocab``), ``--layers`` layers deep (a
comma-separated list), bf16 params drawn by the reference's ``init`` from
``--seed`` (cast to f32 with ``--dtype f32``) and carried to the port by
``params_from_numpy``.  One batch of
``--batch`` x ``--seq`` tokens from ``--seed`` goes through each
framework's ``Model.loss``: the reference's under ``jax.value_and_grad``,
the port's under ``backward``.

For each depth it prints both losses, both gradient norms (the
reference's f32 sum of squares, the port's f64 one), the leaf with the
largest entry, and how far each package's gradient lies from the port's
own gradient in f64 (the same weights as f64; normwise, the largest
max |g - g64| / max |g64| over the leaves): the backward of this model
is chaotic in depth: in f32 that distance is ~1e-3 at 2 layers and O(1)
from 8 on, in the reference as in the port (in bf16 it is O(1) at every
depth, the leaves with the smallest gradients leading).  The reference draws ``wq`` (d, H, hd) and ``wk``
(d, Hkv, hd) with ``fan_in = shape[-2]``, the head count, so they are
sqrt(d / H) and sqrt(d / Hkv) times a 1/sqrt(d) draw: the norm grows
by a roughly constant factor a layer, in both packages, and at
starcoder2-3b's full width and 30 layers an entry's square passes f32's
range (the reason ``optim/adamw.py::global_norm`` sums in f64).  The
last line is one JSON object with those numbers.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/train_depth_witness.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/train_depth_witness.py --dtype f32

About 40 s and 2 GB of host memory at the defaults.
"""
from __future__ import annotations

import argparse
import json

import jax
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models.model import Model as JModel
from repro.models.params import unzip
from repro.optim import global_norm as j_global_norm
from repro_torch.configs import get_config
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.models.params import flat_tree, trainable
from repro_torch.optim import global_norm


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", default="2,8,16,30")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--d-ff", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    args = ap.parse_args()
    shape = dict(d_model=args.d_model, n_heads=args.heads,
                 n_kv_heads=args.kv_heads, head_dim=args.head_dim,
                 d_ff=args.d_ff, vocab=args.vocab)
    rng = np.random.default_rng(args.seed)
    toks = rng.integers(0, args.vocab, (args.batch, args.seq + 1)).astype(
        np.int32)
    nb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = []
    for L in (int(x) for x in args.layers.split(",")):
        jm = JModel(j_get_config("starcoder2-3b").replace(n_layers=L,
                                                          **shape))
        jp = unzip(jm.init(jax.random.PRNGKey(args.seed)))[0]
        if args.dtype == "f32":
            jp = jax.tree.map(lambda a: a.astype(np.float32), jp)
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, {k: jax.numpy.asarray(v)
                                  for k, v in nb.items()}),
            has_aux=True))(jp)
        jflat = {"/".join(str(getattr(k, "key", k)) for k in path):
                 np.asarray(v, np.float32) for path, v in
                 jax.tree_util.tree_flatten_with_path(jg)[0]}
        tm = Model(get_config("starcoder2-3b").replace(n_layers=L, **shape))
        tp = trainable(params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu"))
        tl, _ = tm.loss(tp, {k: torch.from_numpy(v) for k, v in nb.items()})
        tl.backward()
        tg = {k: p.grad for k, p in flat_tree(tp).items()}
        tp64 = trainable(params_from_numpy(jax.tree.map(
            lambda a: np.asarray(a, np.float64), jp), device="cpu"))
        tl64, _ = tm.loss(tp64, {k: torch.from_numpy(v)
                                 for k, v in nb.items()})
        tl64.backward()
        g64 = {k: p.grad.numpy() for k, p in flat_tree(tp64).items()}

        def dist(g):
            return max(float(np.abs(np.asarray(g[k], np.float64)
                                    - g64[k]).max()
                             / max(np.abs(g64[k]).max(), 1e-300))
                       for k in g64)
        jmax = max(jflat, key=lambda k: np.abs(jflat[k]).max())
        tmax = max(tg, key=lambda k: float(tg[k].float().abs().max()))
        row = {"layers": L,
               "loss": [float(jl), tl.item()],
               "grad_norm": [float(j_global_norm(jg)),
                             float(global_norm(tg))],
               "largest": [[jmax, float(np.abs(jflat[jmax]).max())],
                           [tmax, float(tg[tmax].float().abs().max())]],
               "from_f64": [dist(jflat), dist({k: v.float().numpy()
                                               for k, v in tg.items()})]}
        print(f"{L:3d} layers: loss reference {row['loss'][0]:.4f} port "
              f"{row['loss'][1]:.4f}; grad norm reference "
              f"{row['grad_norm'][0]:.4e} port {row['grad_norm'][1]:.4e}; "
              f"largest entry reference {row['largest'][0]} port "
              f"{row['largest'][1]}; from the port's f64 gradient: "
              f"reference {row['from_f64'][0]:.2e} port "
              f"{row['from_f64'][1]:.2e}", flush=True)
        out.append(row)
    print(json.dumps({"witness": "train_depth", "dtype": args.dtype,
                      "shape": shape, "rows": out}))


if __name__ == "__main__":
    main()
