"""The serving data plane — Morpheus' Katran analogue, on PyTorch.

Ported from ``repro.serving.dataplane``: a batched LM serving step
written against :class:`DataPlaneCtx`, with the paper's table cast mapped
into the ML domain:

  req_class    (RO)  vip_map:      request class -> adapter id, sampling
                                   temperature, feature bits
  vocab_embed  (RO)  backend_pool: the embedding table (large; hot-token
                                   fast-path cache applies)
  adapters     (RO)  —             LoRA adapter bank (empty => table
                                   elimination removes the whole branch)
  router       (RO)  vip_map #2:   MoE expert stats (instrumented; hot
                                   experts get the grouped fast path)
  sessions     (RW)  conn_table:   per-slot session state, written by the
                                   data plane itself => site guard

Feature flags (control plane): ``vision_enabled`` (the QUIC-branch
analogue) and ``track_sessions``.

Weights: :func:`build_params` draws the port's own from a seeded
``torch.Generator``; :func:`params_from_numpy` carries the reference's
across (its params tree as numpy arrays).  :func:`build_tables` draws
from ``np.random.default_rng(0)`` as the reference does, so both
packages' tables are byte-identical.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from .. import resolve_device
from ..core import Table, TableSet
from ..core.passes.branch_inject import moe_ffn_hotpath
from ..models.config import ModelConfig, MoEConfig
from ..models.layers import rmsnorm
from ..models.moe import moe_ffn_local, route
from ..models.params import Initializer, ParamTree, tree_from_numpy


@dataclass(frozen=True)
class ServeConfig:
    d_model: int = 64
    n_layers: int = 2
    n_heads: int = 4
    vocab: int = 2048
    n_experts: int = 16
    top_k: int = 2
    d_ff: int = 128
    n_classes: int = 64
    n_adapters: int = 0          # 0 => adapters table is empty (eliminated)
    adapter_rank: int = 4
    n_slots: int = 256
    seq: int = 16


def build_params(cfg: ServeConfig, seed: int = 0,
                 device="cuda") -> ParamTree:
    """Random f32 weights of the reference's shapes and scales."""
    ini = Initializer(seed, resolve_device(device))
    d, f = cfg.d_model, cfg.d_ff
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "norm1": {"scale": ini.ones((d,))},
            "wq": ini.normal((d, d)),
            "wk": ini.normal((d, d)),
            "wv": ini.normal((d, d)),
            "wo": ini.normal((d, d)),
            "norm2": {"scale": ini.ones((d,))},
            "moe": {
                "w_router": ini.normal((d, cfg.n_experts)),
                "b_router": ini.zeros((cfg.n_experts,)),
                "w1": ini.normal((cfg.n_experts, d, f)),
                "w3": ini.normal((cfg.n_experts, d, f)),
                "w2": ini.normal((cfg.n_experts, f, d), fan_in=f),
            },
        })
    return ParamTree({
        "layers": layers,
        "final_norm": {"scale": ini.ones((d,))},
        "unembed": ini.normal((d, cfg.vocab)),
    })


def params_from_numpy(tree, device="cuda") -> ParamTree:
    """The reference's params tree (nested dicts/lists of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``) as the port's."""
    return ParamTree(tree_from_numpy(tree, resolve_device(device)))


def build_tables(cfg: ServeConfig, *, uniform_temperature=True,
                 single_adapter=True,
                 instrument_sessions: bool = False) -> TableSet:
    rng = np.random.default_rng(0)
    embed = rng.standard_normal((cfg.vocab, cfg.d_model)).astype(
        np.float32) * 0.02
    temps = (np.ones(cfg.n_classes, np.float32) if uniform_temperature
             else rng.uniform(0.5, 1.5, cfg.n_classes).astype(np.float32))
    adapter_ids = (np.zeros(cfg.n_classes, np.int32) if single_adapter
                   else rng.integers(0, max(cfg.n_adapters, 1),
                                     cfg.n_classes).astype(np.int32))
    tables = [
        Table("req_class",
              {"adapter_id": adapter_ids,
               "temperature": temps,
               "flags": np.zeros(cfg.n_classes, np.int32)},
              n_valid=cfg.n_classes, max_inline=8),
        Table("vocab_embed", {"vec": embed}, n_valid=cfg.vocab,
              max_inline=0),
        Table("adapters",
              {"down": np.zeros((max(cfg.n_adapters, 1), cfg.d_model,
                                 cfg.adapter_rank), np.float32),
               "up": np.zeros((max(cfg.n_adapters, 1), cfg.adapter_rank,
                               cfg.d_model), np.float32)},
              n_valid=cfg.n_adapters,
              default={"down": 0.0, "up": 0.0}),
        # pseudo-table: identity over expert ids — exists to give the MoE
        # router an instrumented lookup site (the paper's per-map sketch)
        Table("router", {"idx": np.arange(cfg.n_experts, dtype=np.int32)},
              n_valid=cfg.n_experts, max_inline=0),
        # instrument=False is the paper's operator opt-out (§6.5)
        Table("sessions",
              {"count": np.zeros(cfg.n_slots, np.int32),
               "last_token": np.zeros(cfg.n_slots, np.int32)},
              n_valid=cfg.n_slots, mutability="rw",
              instrument=instrument_sessions),
    ]
    return TableSet(tables)


def make_serve_step(cfg: ServeConfig):
    """Returns user_step(params, ctx, batch) -> logits."""
    moe_cfg = MoEConfig(num_experts=cfg.n_experts, top_k=cfg.top_k,
                        expert_d_ff=cfg.d_ff)
    model_cfg = ModelConfig(d_model=cfg.d_model, moe=moe_cfg)

    def attention(lp, x):
        B, S, D = x.shape
        H = 4                      # fixed, as in the reference
        hd = D // H
        q = (x @ lp["wq"]).reshape(B, S, H, hd)
        k = (x @ lp["wk"]).reshape(B, S, H, hd)
        v = (x @ lp["wv"]).reshape(B, S, H, hd)
        logits = torch.einsum("bshd,bthd->bhst", q, k) / float(np.sqrt(hd))
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
        p = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhst,bthd->bshd", p, v).reshape(B, S, D)
        return o @ lp["wo"]

    def serve_step(params, ctx, batch):
        tokens = batch["tokens"]                       # (B, S)
        B, S = tokens.shape

        cls = ctx.lookup("req_class", batch["class_id"],
                         fields=("adapter_id", "temperature"))

        x = ctx.lookup("vocab_embed", tokens, fields=("vec",))["vec"]

        hot = ctx.hot_experts("router")
        for lp in params["layers"]:
            x = x + attention(lp, rmsnorm(lp["norm1"], x))
            h = rmsnorm(lp["norm2"], x)
            h2d = h.reshape(B * S, -1)
            # instrumented router site: record expert choices
            _, ids, _ = route(lp["moe"]["w_router"], h2d, cfg.top_k,
                              lp["moe"].get("b_router"))
            ctx.lookup("router", ids.reshape(-1), fields=("idx",))
            if hot:
                y, _ = moe_ffn_hotpath(lp["moe"], h2d, model_cfg, hot)
            else:
                y, _ = moe_ffn_local(lp["moe"], h2d, moe_cfg)
            x = x + y.reshape(B, S, -1)

        # adapter branch: fully eliminated when the adapter bank is empty
        ad = ctx.lookup_or_none("adapters", cls["adapter_id"],
                                fields=("down", "up"))
        if ad is not None:
            x = x + torch.einsum("bsd,bdr,brk->bsk", x, ad["down"],
                                 ad["up"])

        if ctx.flag("vision_enabled", default=True):
            # stub vision tower (the QUIC branch): pure overhead unless a
            # class needs it — dead-code elimination drops it when the
            # flag is pinned off
            v = x
            for _ in range(2):
                v = torch.tanh(v @ params["unembed"][:, : v.shape[-1]])
            x = x + 0.0 * v

        x = rmsnorm(params["final_norm"], x)
        logits = x @ params["unembed"]
        logits = logits / cls["temperature"][:, None, None]

        if ctx.flag("track_sessions", default=True):
            next_tok = logits[:, -1, :].argmax(dim=-1).to(torch.int32)
            old = ctx.lookup("sessions", batch["slot"], fields=("count",))
            ctx.update("sessions", batch["slot"],
                       {"count": old["count"] + 1, "last_token": next_tok})
        return logits

    return serve_step


def make_synthetic_batch(cfg: ServeConfig, seed: int = 0, batch_size=8,
                         locality: str = "high", hot_classes=4,
                         hot_offset: int = 0, hot_slots: int = 0,
                         slot_offset: int = 0,
                         device="cuda") -> Dict[str, torch.Tensor]:
    """Synthetic request stream with controllable class/token locality —
    the paper's high/low/no-locality traces, drawn from a seeded
    ``torch.Generator``.  ``hot_offset`` shifts the hot set (traffic
    drift); ``hot_slots`` concentrates session slots."""
    gen = torch.Generator().manual_seed(seed)
    if locality == "high":
        n_hot_cls, n_hot_tok = hot_classes, 32
    elif locality == "low":
        n_hot_cls, n_hot_tok = max(cfg.n_classes // 2, 1), cfg.vocab // 4
    else:
        n_hot_cls, n_hot_tok = cfg.n_classes, cfg.vocab
    tokens = (torch.randint(0, n_hot_tok, (batch_size, cfg.seq),
                            generator=gen) + hot_offset * 7) % cfg.vocab
    class_id = (torch.randint(0, n_hot_cls, (batch_size,), generator=gen)
                + hot_offset) % cfg.n_classes
    n_slots = hot_slots if hot_slots else cfg.n_slots
    slot = (torch.randint(0, n_slots, (batch_size,), generator=gen)
            + slot_offset) % cfg.n_slots
    dev = resolve_device(device)
    return {"tokens": tokens.to(torch.int32).to(dev),
            "class_id": class_id.to(torch.int32).to(dev),
            "slot": slot.to(torch.int32).to(dev)}
