#!/usr/bin/env python
"""How seamless-m4t-medium from random weights amplifies a difference in
the last bits with depth, in the JAX reference and in the PyTorch port,
on the CPU.

seamless-m4t-medium at every published width (d_model 1024, 16 / 16
heads x 64, d_ff 4096 gated SiLU), ``--enc-layers`` encoder and
``--dec-layers`` decoder layers, in ``--dtype``, each layer drawn by the
reference's ``init_layer`` from ``--seed`` and carried to the port by
``tree_from_numpy``.  The encoder's input is ``--batch`` x ``--frames``
frames drawn from N(0, 1), as ``chip_smoke.py`` draws them; the
decoder's is ``--batch`` x ``--seq`` hidden states with the embedding's
scale (N(0, 1) / sqrt(d_model)), each layer cross-attending to the
reference's encoder output for the unperturbed frames.  Each input also
goes through moved by one ulp of the dtype in every element.  Both go
through each framework's ``layer_forward`` (bidirectional in the
encoder, causal with cross-attention in the decoder; no cache), one
layer at a time.

First it prints what makes the model sensitive: the attention logits
of encoder layer 0 (the reference's ``wq`` and ``wk`` are drawn with
``fan_in = shape[-2]``, the head count, so q and k are ~sqrt(d_model /
H) = 8 and q.k / sqrt(64) has a std of ~64, with no softcap), their
std and the mean largest softmax weight of a row (near 1: attention
close to an argmax, where a near-tie moves a row's output by a whole
value vector).  Then, per layer and per framework, how far the layer's
outputs for the two inputs lie apart (max |difference| over max
|output|), and how far the port's output lies from the reference's on
the same input.  The last line is one JSON object with those numbers.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/encdec_depth_witness.py --dtype bf16

About 2 GB of host memory and a minute on 8 cores.
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
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import params as JP
from repro.models import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import transformer as TT
from repro_torch.models.params import tree_from_numpy

ARCH = "seamless-m4t-medium"


def rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--enc-layers", type=int, default=12)
    ap.add_argument("--dec-layers", type=int, default=12)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="bf16")
    args = ap.parse_args()
    jdt = jnp.float32 if args.dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if args.dtype == "f32" else torch.bfloat16

    jcfg = j_get_config(ARCH)
    tcfg = t_get_config(ARCH)
    dec_spec = jcfg.pattern[0]
    B, D = args.batch, jcfg.d_model
    f32 = lambda t: np.asarray(t, np.float32)
    rng = np.random.default_rng(args.seed)
    one_ulp = lambda x: [x, jnp.nextafter(x, jnp.asarray(np.inf, jdt))]
    key = jax.random.PRNGKey(args.seed)

    def draw(layer, spec):
        ini = JP.Initializer(jax.random.fold_in(key, layer), dtype=jdt)
        jp = JP.unzip(JT.init_layer(ini, jcfg, spec))[0]
        return jp, tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

    frames = jnp.asarray(rng.standard_normal((B, args.frames, D)), jdt)
    # what makes the model sensitive: encoder layer 0's attention logits
    jp0, _ = draw(0, JE.ENC_SPEC)
    h = f32(JL.rmsnorm(jp0["attn_norm"], frames, jcfg.rms_eps))
    q = np.einsum("bsd,dhk->bshk", h, f32(jp0["attn"]["wq"]))
    k = np.einsum("bsd,dhk->bshk", h, f32(jp0["attn"]["wk"]))
    logits = np.einsum("bshk,bthk->bhst", q, k) / np.sqrt(jcfg.head_dim_)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    top = float((w.max(-1) / w.sum(-1)).mean())
    print(f"[witness] {ARCH}: {args.enc_layers} encoder + {args.dec_layers} "
          f"decoder layers at every published width, {args.dtype}; encoder "
          f"layer 0: q std {q.std():.2f}, attention logits (q.k / sqrt("
          f"{jcfg.head_dim_}), before RoPE) std {logits.std():.2f}, mean "
          f"largest softmax weight of a row {top:.4f}")

    results = {"encoder": [], "decoder": []}
    jx, enc_out = one_ulp(frames), None
    for part, n, spec, S in (("encoder", args.enc_layers, JE.ENC_SPEC,
                              args.frames),
                             ("decoder", args.dec_layers, dec_spec,
                              args.seq)):
        positions = jnp.arange(S, dtype=jnp.int32)
        causal = part == "decoder"
        jlayer = jax.jit(lambda p, x, e, spec=spec, causal=causal,
                         positions=positions: JT.layer_forward(
                             p, jcfg, spec, x, positions, enc_out=e,
                             causal=causal)[0])
        if part == "decoder":
            jx = one_ulp(jnp.asarray(
                rng.standard_normal((B, S, D)) / np.sqrt(D), jdt))
        tx = [torch.from_numpy(np.array(f32(x))).to(tdt) for x in jx]
        t_enc = (None if enc_out is None
                 else torch.from_numpy(np.array(f32(enc_out))).to(tdt))
        print(f"[witness] {part}: input {B} x {S}, perturbed by one ulp in "
              f"every element (max |x1 - x0| / max |x0| "
              f"{rel(f32(jx[1]), f32(jx[0])):.2e})")
        for layer in range(n):
            t0 = time.perf_counter()
            # decoder layers from keys of their own
            jp, tp = draw(layer + (1000 if causal else 0), spec)
            jx = [jlayer(jp, x, enc_out) for x in jx]
            with torch.no_grad():
                tx = [TT.layer_forward(tp, tcfg, spec, x, 0, enc_out=t_enc,
                                       causal=causal)[0] for x in tx]
            jo = [f32(x) for x in jx]
            to = [x.float().numpy() for x in tx]
            row = {"layer": layer, "reference": rel(jo[1], jo[0]),
                   "port": rel(to[1], to[0]),
                   "port_vs_reference": rel(to[0], jo[0])}
            results[part].append(row)
            print(f"[witness] {part} layer {layer}: outputs of x1 vs x0, "
                  f"reference {row['reference']:.3e} port {row['port']:.3e} "
                  f"of max|out|; port vs reference on x0 "
                  f"{row['port_vs_reference']:.3e} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if part == "encoder":
            # the encoder's final RMSNorm, whose scale init_encdec draws
            # as ones
            enc_out = JL.rmsnorm({"scale": jnp.ones((D,), jnp.float32)},
                                 jx[0], jcfg.rms_eps)
    print(json.dumps({"arch": ARCH, "dtype": args.dtype, "batch": B,
                      "frames": args.frames, "seq": args.seq,
                      "seed": args.seed, "logit_std": float(logits.std()),
                      "top_weight": top, **results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
