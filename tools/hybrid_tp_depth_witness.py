#!/usr/bin/env python
"""How far random-weight jamba amplifies a last-bit difference with
depth, on the CPU at smoke scale: the witness behind the depth of
``tests/test_torch_ssm_tp.py``'s jamba cases.

For jamba's smoke stack cut to 8 layers (its first period) and whole
(16 layers), f32, B 1 x 21 prompt tokens and 3 decode steps on a
(data 2, model 2) CPU debug mesh, it prints per call (the prefill, then
each step), normwise (max |a - b| / max |b|):

* ``one-ulp``: the home layout's logits against the home layout's own
  with the embedding table scaled by 1 + 2^-23 (a one-ulp change);
* ``tensor_parallel``: the partitioned decode, from the home prefill's
  cache placed, against the home layout's (the prefill itself is the
  home layout's, so its entry is 0).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/hybrid_tp_depth_witness.py

(~10 s.)
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import compat
from repro_torch.distributed.meshctx import MeshPolicy, use_policy
from repro_torch.distributed.sharding import make_rules, place_cache, \
    place_params
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.model import Model
from repro_torch.models.params import flat_tree, unflat_tree

P, N = 21, 3


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    return fn(t) if isinstance(t, torch.Tensor) else t


def _f32(t):
    return _tree(t, lambda x: x.float() if x.dtype == torch.bfloat16 else x)


def _serve(model, params, cache, tokens, fed, pol, prefill=True):
    outs = []
    with use_policy(pol):
        if prefill:
            outs.append(model.prefill(params, cache, {"tokens": tokens})[0])
        for j, tok in enumerate(fed):
            outs.append(model.decode_step(params, cache, tok, P + j)[0])
    return [o.gather("cpu") if isinstance(o, compat.Sharded) else o
            for o in outs]


def _dist(a, b):
    return [float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b)]


def main():
    for layers in (8, 16):
        cfg = get_config("jamba-v0.1-52b").smoke()
        cfg = cfg.replace(n_layers=layers, moe=dataclasses.replace(
            cfg.moe, capacity_factor=4.0))
        model = Model(cfg)
        params = {k: v.float() for k, v in flat_tree(model.init(0, "cpu"))
                  .items()}
        rng = np.random.default_rng(11)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, P))
                                  .astype(np.int32))
        fed = [torch.from_numpy(rng.integers(0, cfg.vocab, (1, 1))
                                .astype(np.int32)) for _ in range(N)]
        mesh = make_debug_mesh(2, 2, device="cpu")
        home = MeshPolicy(mesh=mesh)
        tp = MeshPolicy(mesh=mesh, rules=make_rules(False, fsdp=False))
        whole = lambda scale=1.0: unflat_tree({
            k: v * scale if k == "embed/table" else v.clone()
            for k, v in params.items()})
        ref_cache = _f32(model.init_cache(1, 24, "cpu"))
        ref = _serve(model, whole(), ref_cache, tokens, [], home)
        placed_cache = place_cache(_tree(ref_cache, torch.clone), mesh,
                                   tp.rules)
        ref += _serve(model, whole(), ref_cache, tokens, fed, home,
                      prefill=False)
        bumped = _serve(model, whole(1 + 2.0 ** -23),
                        _f32(model.init_cache(1, 24, "cpu")), tokens, fed,
                        home)
        got = ref[:1] + _serve(model, place_params(whole(), mesh, tp.rules),
                               placed_cache, tokens, fed, tp, prefill=False)
        print(f"jamba smoke, {layers} layers, B 1: one-ulp "
              f"{_dist(bumped, ref)}; tensor_parallel {_dist(got, ref)}")


if __name__ == "__main__":
    main()
