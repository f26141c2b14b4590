"""Common layers: RMSNorm, embeddings, RoPE, gated FFN, logit head.

Ported from ``repro.models.layers``.  Parameters are dicts of tensors
drawn by :class:`~repro_torch.models.params.Initializer` in the
reference's shapes and layouts (``wq`` is (d, heads, head_dim), ``w_up``
(d, d_ff)), so the reference's weights carry across one to one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import Initializer


def dot_f32(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """einsum with f32 accumulation, as the reference computes it off the
    TPU: the operands are upcast to f32 first (the same products; the
    TPU's bf16-in / f32-accumulate contraction is what the CUDA attention
    kernel does instead)."""
    return torch.einsum(eq, *(o.float() for o in ops))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(ini: Initializer, d: int):
    return {"scale": ini.ones((d,), dtype=torch.float32)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(ini: Initializer, vocab: int, d: int):
    return {"table": ini.normal((vocab, d), fan_in=d)}


class _EmbedRows(torch.autograd.Function):
    """``table.index_select(0, ids)`` whose gradient is a one-hot product,
    ``onehot(ids)^T @ grad``: deterministic, where ``index_select``'s own
    backward (``index_add_``) adds a repeated id's rows with float atomics
    on the card, in an order that changes from run to run, which would
    break the trainer's bit-exact crash/resume.  The product sums in f32
    and costs ``2 V T D`` flops (~2.5 TFLOP at starcoder2-3b's 8192
    tokens, a few ms on the card)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.vocab = table.shape[0]
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        onehot = torch.zeros((ids.shape[0], ctx.vocab), dtype=grad.dtype,
                             device=grad.device)
        onehot.scatter_(1, ids.long()[:, None], 1.0)
        return onehot.t() @ grad, None


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    table = params["table"]
    ids = tokens.reshape(-1)
    if torch.is_grad_enabled() and table.requires_grad:
        rows = _EmbedRows.apply(table, ids)
    else:
        rows = table.index_select(0, ids)
    return rows.reshape(*tokens.shape, table.shape[1])


def embed_tp(run, sh, tables: dict, tokens: dict, vocab: int) -> dict:
    """The vocab-parallel lookup of the partitioned layout
    (``distributed/tensor_parallel.py``): ``tables[c]`` is coordinate
    c's block of the (``vocab``, D) table, ``sh`` its sharding, and
    ``tokens[c]`` c's rows' ids.  Where the spec splits the vocab over
    the model axis, each coordinate looks up the ids in its range, zeros
    the rest, and the model group sums the blocks: one term of each sum
    is the row and the others zeros, so the result is the single-device
    lookup bit for bit.  A replicated table is read whole."""
    if not sh.spec:
        return run.each(lambda c: embed({"table": tables[c]}, tokens[c]))

    def local(c):
        lo, hi = sh.range_at(c, 0, vocab)
        ids = tokens[c].long() - lo
        mine = (ids >= 0) & (ids < hi - lo)
        rows = embed({"table": tables[c]}, ids.clamp(0, hi - lo - 1))
        return torch.where(mine[..., None], rows, 0.0)
    return run.all_reduce(run.each(local))


def init_unembed(ini: Initializer, d: int, vocab: int):
    return {"w": ini.normal((d, vocab))}


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(x / cap)`` computed in f32 and cast back.  In place on
    one f32 copy: at gemma2-9b's prefill the logits are (2, 6144, 256000),
    and each further f32 temporary would be 12.6 GB.  Out of place when
    autograd records it."""
    if not cap:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        # autograd keeps tanh's output, which the in-place mul would change
        return (torch.tanh(x.float() / cap) * cap).to(x.dtype)
    y = x.float() if x.dtype != torch.float32 else x.clone()
    return y.div_(cap).tanh_().mul_(cap).to(x.dtype)


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    logits = x @ params["w"]
    return softcap(logits, cfg.final_logit_softcap)


def unembed_tp(run, w: dict, x: dict, cfg: ModelConfig,
               tied: bool) -> dict:
    """Each coordinate's logits over its block of the vocab: ``w[c]`` is
    its block of ``unembed``'s (D, V) or, ``tied``, of the embedding's
    (V, D) table; the final softcap is elementwise, so it stays local.
    No collective: the logits stay split over the vocab, as the
    reference's ``constrain(logits, ("batch", None, "vocab"))``."""
    def local(c):
        return softcap(x[c] @ (w[c].t() if tied else w[c]),
                       cfg.final_logit_softcap)
    return run.each(local)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers.
    Rotates the two halves of the head dim (not interleaved pairs), with
    angles ``positions * freqs`` in f32, as the reference does."""
    dim = x.shape[-1]
    freqs = rope_freqs(dim, theta, x.device)                     # (dim/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (.., S, d/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated FFN (SwiGLU / GeGLU) or a plain two-matrix MLP
# ---------------------------------------------------------------------------

def init_ffn(ini: Initializer, d: int, d_ff: int, gated: bool = True):
    p = {"w_up": ini.normal((d, d_ff)),
         "w_down": ini.normal((d_ff, d), fan_in=d_ff)}
    if gated:
        p["w_gate"] = ini.normal((d, d_ff))
    return p


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")


def ffn(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    up = x @ params["w_up"]
    if "w_gate" in params:
        h = _act(x @ params["w_gate"], act) * up
    else:
        h = _act(up, act)
    return h @ params["w_down"]


def ffn_tp(run, params: dict, down_sh, x: dict, act: str = "silu") -> dict:
    """:func:`ffn` of the partitioned layout: ``params[c]`` holds
    coordinate c's columns of ``w_up`` / ``w_gate`` and rows of
    ``w_down`` (the ``mlp`` split over the model axis), so each computes
    a partial output over its columns, and the model group sums the
    partials (one all-reduce).  Unsplit weights give each coordinate the
    whole output, with no sum."""
    out = run.each(lambda c: ffn(params[c], x[c], act))
    return run.all_reduce(out) if down_sh.spec else out
