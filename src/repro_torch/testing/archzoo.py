"""Per-architecture conformance planes over the whole config zoo.

Ported from ``repro.testing.archzoo``.  One :class:`ArchPlane` per
``repro_torch.configs.ARCH_IDS`` entry, built from the config's
``smoke()`` reduction.  Instead of replaying the full model-zoo forward
(whose layer stacks repeat), a plane compresses the architecture's
``block_pattern`` to its *distinct* layer shapes — one layer per distinct
``(kind, ffn, cross_attn)`` triple, in first-seen order — and wires each
distinguishing block through the Morpheus table cast:

  req_class     (RO)  per-class temperature + bias row (small =>
                      inline-JIT territory)
  vocab_embed   (RO)  token embeddings (hot-token fast path, the
                      ``hot_gather`` kernel on the card)
  sessions      (RW)  per-slot activation history + write counter
  router        (RO)  MoE expert pseudo-table — MoE archs
  ssm_state     (RW)  per-slot SSD recurrent state + write counter (the
                      SSD-scan fast path specializes the state restore
                      away for fresh batches) — mamba2 / jamba
  cross_src     (RO)  encoder memory by source id — seamless
  media_patches (RO)  patch embeddings by media id — pixtral

Feature flags ``aux_bias`` / ``out_norm`` gate real output terms so the
dead-code pass (and flag-flip churn) is semantically observable.

The numpy generators (:func:`build_tables`, :func:`make_batch`,
:func:`make_rows`) are the reference's, so the same seed gives the same
arrays bit for bit.  :func:`build_params` draws the port's own weights
from a seeded ``torch.Generator``; :func:`params_from_numpy` carries the
reference's across.  Batch generators keep table indices inside
``n_valid`` and slot ids distinct within a batch, as the reference's
do (a repeated slot's scatter would make the last write win, which the
port reproduces, but the plane never needs it).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..configs import ARCH_IDS, get_config
from ..core import EngineConfig, SketchConfig, Table, TableSet
from ..core.passes.branch_inject import moe_ffn_hotpath
from ..core.passes.ssd_fastpath import ssd_init_state_hotpath
from ..models.config import LayerSpec, ModelConfig
from ..models.moe import moe_ffn_local, route
from ..models.params import Initializer, ParamTree, tree_from_numpy
from ..models.ssd import _dims, init_mamba, mamba_forward_with_state

# plane-wide scale knobs: small enough that a full arch x churn matrix
# stays CPU-cheap, big enough that every pass has room to fire
N_CLASSES = 8
N_SLOTS = 128
N_SRC = 16            # cross_src rows (seamless)
N_MEDIA = 16          # media_patches rows (pixtral)
N_FRAMES = 4          # encoder memory frames / prepended media tokens
BATCH = 4
HOT_TOKENS = 8        # hot-token working set (vocab_embed fast path)
HOT_SLOTS = 8         # hot-slot working set (sessions / ssm_state)
HOT_SRC = 4           # hot source/media ids (cross tables)


@dataclass(frozen=True)
class ArchPlane:
    """Everything the conformance harness needs to serve one arch."""
    arch_id: str
    cfg: ModelConfig                       # smoke-scale model config
    blocks: Tuple[LayerSpec, ...]          # distinct layer shapes
    seq: int
    vocab: int
    has_ssm: bool
    has_moe: bool
    has_cross: bool
    has_media: bool
    features: Dict[str, bool] = field(
        default_factory=lambda: {"aux_bias": True, "out_norm": True})

    @property
    def batch_fields(self) -> Tuple[str, ...]:
        f = ["tokens", "class_id", "slot"]
        if self.has_cross:
            f.append("src_id")
        if self.has_media:
            f.append("media_id")
        return tuple(f)


def _distinct_blocks(cfg: ModelConfig) -> Tuple[LayerSpec, ...]:
    """Compress the (possibly long) layer pattern to one layer per
    distinct (kind, ffn, cross_attn) shape, preserving first-seen order
    — plan/pass behavior depends on table call sites, not on how many
    times a block repeats."""
    seen, out = set(), []
    for spec in cfg.pattern:
        key = (spec.kind, spec.ffn, spec.cross_attn)
        if key not in seen:
            seen.add(key)
            out.append(spec)
    return tuple(out)


def build_plane(arch_id: str) -> ArchPlane:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r} (have {ARCH_IDS})")
    cfg = get_config(arch_id).smoke()
    blocks = _distinct_blocks(cfg)
    has_ssm = any(b.kind == "mamba" for b in blocks)
    has_moe = any(b.ffn == "moe" for b in blocks)
    has_cross = any(b.cross_attn for b in blocks) or cfg.encdec
    has_media = cfg.num_media_tokens > 0
    # SSD scans want a whole chunk of sequence; attention-only planes
    # stay shorter so the matrix runs fast
    seq = cfg.ssm.chunk if (has_ssm and cfg.ssm is not None) else 8
    return ArchPlane(arch_id=arch_id, cfg=cfg, blocks=blocks, seq=seq,
                     vocab=cfg.padded_vocab, has_ssm=has_ssm,
                     has_moe=has_moe, has_cross=has_cross,
                     has_media=has_media)


# ---- tables / params ----------------------------------------------------

def _ssm_state_width(cfg: ModelConfig) -> int:
    s, _, H, _ = _dims(cfg)
    return H * s.head_dim * s.d_state


def build_tables(plane: ArchPlane, seed: int = 0) -> TableSet:
    """A fresh TableSet for one runtime.  Deterministic in ``seed`` —
    the harness builds two identical sets (specialized side + oracle)
    by calling this twice."""
    rng = np.random.default_rng(seed + 0xA11C)
    cfg = plane.cfg
    d = cfg.d_model
    tables = [
        Table("req_class",
              {"temperature": rng.uniform(0.5, 1.5, N_CLASSES)
                  .astype(np.float32),
               "bias": (rng.standard_normal((N_CLASSES, d)) * 0.02)
                  .astype(np.float32)},
              n_valid=N_CLASSES, max_inline=16),
        Table("vocab_embed",
              {"vec": (rng.standard_normal((plane.vocab, d)) * 0.02)
                  .astype(np.float32)},
              n_valid=plane.vocab, max_inline=0),
        Table("sessions",
              {"hist": np.zeros((N_SLOTS, d), np.float32),
               "count": np.zeros(N_SLOTS, np.int32)},
              n_valid=N_SLOTS, mutability="rw", max_inline=8),
    ]
    if plane.has_moe:
        e = cfg.moe.num_experts
        tables.append(Table(
            "router", {"idx": np.arange(e, dtype=np.int32)},
            n_valid=e, max_inline=0))
    if plane.has_ssm:
        tables.append(Table(
            "ssm_state",
            {"state": np.zeros((N_SLOTS, _ssm_state_width(cfg)),
                               np.float32),
             "count": np.zeros(N_SLOTS, np.int32)},
            n_valid=N_SLOTS, mutability="rw", max_inline=8))
    if plane.has_cross:
        tables.append(Table(
            "cross_src",
            {"mem": (rng.standard_normal((N_SRC, N_FRAMES * d)) * 0.1)
                .astype(np.float32)},
            n_valid=N_SRC, max_inline=4))
    if plane.has_media:
        tables.append(Table(
            "media_patches",
            {"patch": (rng.standard_normal((N_MEDIA, N_FRAMES * d))
                       * 0.1).astype(np.float32)},
            n_valid=N_MEDIA, max_inline=4))
    return TableSet(tables)


def build_params(plane: ArchPlane, seed: int = 0,
                 device="cuda") -> ParamTree:
    """Random f32 weights of the reference's shapes and scales, drawn
    from a ``torch.Generator`` seeded with ``seed``."""
    cfg = plane.cfg
    d = cfg.d_model
    ff = max(cfg.d_ff, 4 * d) // 2
    ini = Initializer(seed + 7, resolve_device(device), dtype=torch.float32)
    blocks: List[Dict] = []
    for b in plane.blocks:
        lp: Dict = {"norm1": ini.ones((d,))}
        if b.kind == "mamba":
            lp["mamba"] = init_mamba(ini, cfg)
        else:
            for w in ("wq", "wk", "wv", "wo"):
                lp[w] = ini.normal((d, d))
            if b.cross_attn:
                for w in ("cq", "ck", "cv", "co"):
                    lp[w] = ini.normal((d, d))
        if b.ffn == "moe":
            m = cfg.moe
            e_ff = m.expert_d_ff or ff
            lp["moe"] = {
                "w_router": ini.normal((d, m.num_experts)),
                "b_router": ini.zeros((m.num_experts,)),
                "w1": ini.normal((m.num_experts, d, e_ff)),
                "w3": ini.normal((m.num_experts, d, e_ff)),
                "w2": ini.normal((m.num_experts, e_ff, d), fan_in=e_ff),
            }
        elif b.ffn == "dense":
            lp["w_in"] = ini.normal((d, ff))
            lp["w_out"] = ini.normal((ff, d), fan_in=ff)
        if b.ffn != "none" or b.kind == "mamba":
            lp["norm2"] = ini.ones((d,))
        blocks.append(lp)
    return ParamTree({
        "blocks": blocks,
        "final_norm": ini.ones((d,)),
        "unembed": ini.normal((d, plane.vocab)),
    })


def params_from_numpy(tree, device="cuda") -> ParamTree:
    """The reference's plane params (``jax.tree.map(np.asarray,
    build_params(plane, seed))``: nested dicts/lists of numpy arrays) as
    the port's tree."""
    return ParamTree(tree_from_numpy(tree, resolve_device(device)))


# ---- the step function --------------------------------------------------

def _rms(scale, x, eps=1e-6):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _attention(lp, x, *, causal: bool, n_heads: int,
               mem: Optional[torch.Tensor] = None,
               prefix: str = "") -> torch.Tensor:
    """Tiny MHA; with ``mem`` it is cross-attention (q from x, k/v from
    the encoder memory, no mask)."""
    B, S, D = x.shape
    kv = x if mem is None else mem
    T = kv.shape[1]
    hd = D // n_heads
    q = x @ lp[prefix + "q" if prefix else "wq"]
    k = kv @ lp[prefix + "k" if prefix else "wk"]
    v = kv @ lp[prefix + "v" if prefix else "wv"]
    q = q.reshape(B, S, n_heads, hd)
    k = k.reshape(B, T, n_heads, hd)
    v = v.reshape(B, T, n_heads, hd)
    logits = torch.einsum("bshd,bthd->bhst", q, k) / float(np.sqrt(hd))
    if causal and mem is None:
        mask = torch.ones((S, T), dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhst,bthd->bshd", p, v).reshape(B, S, D)
    return o @ lp[prefix + "o" if prefix else "wo"]


def _ssm_block(lp, ctx, cfg: ModelConfig, x, slot):
    """The SSD block with per-slot recurrent state in the ``ssm_state``
    RW table.  The cheap ``count`` lookup is the unconditional,
    instrumented site; when the plan carries an ``ssd_fastpath`` claim
    the wide state gather moves behind the injected freshness predicate
    (:func:`~repro_torch.core.passes.ssd_fastpath.ssd_init_state_hotpath`)."""
    B = x.shape[0]
    s, _, H, _ = _dims(cfg)
    shape = (B, H, s.head_dim, s.d_state)
    cnt = ctx.lookup("ssm_state", slot, fields=("count",))["count"]
    if ctx.fastpath_keys("ssm_state", "ssd_fastpath") is not None:
        raw = ctx.table_array("ssm_state", "state")
        init = ssd_init_state_hotpath(
            cnt, lambda: raw.index_select(0, slot), shape)
    else:
        st = ctx.lookup("ssm_state", slot, fields=("state",))["state"]
        init = st.to(torch.float32).reshape(shape)
    out, fin = mamba_forward_with_state(lp["mamba"], cfg, x,
                                        init_state=init)
    ctx.update("ssm_state", slot,
               {"state": fin.reshape(B, -1), "count": cnt + 1})
    return out


def _moe_block(lp, ctx, cfg: ModelConfig, h2d):
    m = cfg.moe
    # instrumented router site: record expert choices (the sketch the
    # hot-expert pass plans from)
    _, ids, _ = route(lp["moe"]["w_router"], h2d, m.top_k,
                      lp["moe"].get("b_router"))
    ctx.lookup("router", ids.reshape(-1), fields=("idx",))
    hot = ctx.hot_experts("router")
    if hot:
        y, _ = moe_ffn_hotpath(lp["moe"], h2d, cfg, hot)
    else:
        y, _ = moe_ffn_local(lp["moe"], h2d, m)
    return y


def make_step(plane: ArchPlane):
    """Returns ``user_step(params, ctx, batch) -> logits`` for this
    arch's plane."""
    cfg = plane.cfg
    n_heads = max(cfg.d_model // (cfg.head_dim or 16), 1)

    def step(params, ctx, batch):
        tokens = batch["tokens"]                       # (B, S)
        B, S = tokens.shape
        cls = ctx.lookup("req_class", batch["class_id"],
                         fields=("temperature", "bias"))
        x = ctx.lookup("vocab_embed", tokens, fields=("vec",))["vec"]

        if plane.has_media:
            pm = ctx.lookup("media_patches", batch["media_id"],
                            fields=("patch",))["patch"]
            media = pm.reshape(B, N_FRAMES, cfg.d_model)
            x = torch.cat([media.to(x.dtype), x], dim=1)

        mem = None
        if plane.has_cross:
            mm = ctx.lookup("cross_src", batch["src_id"],
                            fields=("mem",))["mem"]
            mem = mm.reshape(B, N_FRAMES, cfg.d_model).to(x.dtype)

        for i, b in enumerate(plane.blocks):
            lp = params["blocks"][i]
            h = _rms(lp["norm1"], x)
            if b.kind == "mamba":
                x = x + _ssm_block(lp, ctx, cfg, h, batch["slot"])
            else:
                x = x + _attention(lp, h, causal=True, n_heads=n_heads)
                if b.cross_attn and mem is not None:
                    x = x + _attention(lp, _rms(lp["norm1"], x),
                                       causal=False, n_heads=n_heads,
                                       mem=mem, prefix="c")
            if b.ffn == "moe":
                h2 = _rms(lp["norm2"], x)
                y = _moe_block(lp, ctx, cfg, h2.reshape(B * x.shape[1],
                                                        -1))
                x = x + y.reshape(x.shape)
            elif b.ffn == "dense":
                h2 = _rms(lp["norm2"], x)
                x = x + F.silu(h2 @ lp["w_in"]) @ lp["w_out"]

        if plane.has_media:
            x = x[:, N_FRAMES:, :]                     # strip patches

        if ctx.flag("aux_bias", default=True):
            x = x + cls["bias"][:, None, :]
        if ctx.flag("out_norm", default=True):
            x = _rms(params["final_norm"], x)

        logits = x @ params["unembed"]
        logits = logits / cls["temperature"][:, None, None]

        # sessions: the conn_table write — history mix + counter bump,
        # which invalidates the RW guard the same step
        pooled = x.to(torch.float32).mean(dim=1)
        old = ctx.lookup("sessions", batch["slot"],
                         fields=("hist", "count"))
        ctx.update("sessions", batch["slot"],
                   {"hist": old["hist"] * 0.5 + pooled,
                    "count": old["count"] + 1})
        return logits

    return step


# ---- traffic ------------------------------------------------------------

@dataclass
class TrafficState:
    """Mutable locality offsets the churn schedule rotates (hot-set
    drift).  Part of schedule *generation* — batches are materialized
    with the offsets in effect at their point in the schedule."""
    token_off: int = 0
    slot_off: int = 0
    src_off: int = 0


def make_batch(plane: ArchPlane, rng: np.random.Generator,
               traffic: Optional[TrafficState] = None,
               batch: int = BATCH) -> Dict[str, np.ndarray]:
    """One high-locality numpy batch.  ~90% of tokens come from a
    HOT_TOKENS-wide rotating window (fast-path coverage), slots are
    distinct-in-batch draws from a HOT_SLOTS window, class/src ids
    concentrate on a few hot rows.  Deterministic in (rng state,
    traffic offsets)."""
    t = traffic or TrafficState()
    hot = (t.token_off + rng.integers(0, HOT_TOKENS,
                                      (batch, plane.seq))) % plane.vocab
    cold = rng.integers(0, plane.vocab, (batch, plane.seq))
    take_hot = rng.random((batch, plane.seq)) < 0.9
    tokens = np.where(take_hot, hot, cold).astype(np.int32)

    slot_window = (t.slot_off + np.arange(HOT_SLOTS)) % N_SLOTS
    slots = rng.choice(slot_window, size=batch,
                       replace=False).astype(np.int32)

    out = {"tokens": tokens,
           "class_id": rng.integers(0, N_CLASSES,
                                    batch).astype(np.int32),
           "slot": slots}
    if plane.has_cross:
        out["src_id"] = ((t.src_off + rng.integers(0, HOT_SRC, batch))
                         % N_SRC).astype(np.int32)
    if plane.has_media:
        out["media_id"] = ((t.src_off + rng.integers(0, HOT_SRC, batch))
                           % N_MEDIA).astype(np.int32)
    return out


def make_rows(plane: ArchPlane, rng: np.random.Generator,
              n: int, traffic: Optional[TrafficState] = None
              ) -> List[Dict[str, np.ndarray]]:
    """N single-request payload rows for the serving frontend.  Slots
    are consecutive within the draw, so any group the batcher forms
    from adjacent requests has distinct slots."""
    t = traffic or TrafficState()
    b = make_batch(plane, rng, t, batch=n)
    base = int(rng.integers(0, N_SLOTS))
    b["slot"] = ((t.slot_off + base + np.arange(n))
                 % N_SLOTS).astype(np.int32)
    return [{f: v[i] for f, v in b.items()} for i in range(n)]


def conformance_engine_config(plane: ArchPlane,
                              **overrides) -> EngineConfig:
    """The specialized side's EngineConfig: fast-filling sketches, a
    permissive hot-coverage threshold (schedules are short), and the
    arch's branch-injection tables wired up.  ``device=`` goes in
    ``overrides`` (default: the card)."""
    kw = dict(
        sketch=SketchConfig(rows=4, width=256, candidates=64,
                            sample_every=2, hot_coverage=0.6,
                            max_hot=8),
        features=dict(plane.features),
        moe_router_table="router" if plane.has_moe else None,
        ssd_state_table="ssm_state" if plane.has_ssm else None,
    )
    kw.update(overrides)
    return EngineConfig(**kw)
