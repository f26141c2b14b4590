"""Mixture-of-Experts FFN.

``moe_ffn_local`` is the reference's dropless MoE (``repro.models.moe``):
sort tokens by expert, run each expert's gated FFN on its contiguous row
group, unsort, combine.  The reference's ``jax.lax.ragged_dot`` has no
PyTorch twin; here a group is one ``torch.matmul`` per expert weight on
a view of that expert's slice (``w1[e]``).  Slicing needs the group
sizes on the host — one device-to-host read per MoE layer, and no other
(the counts are a ``scatter_add_``: ``torch.bincount`` on the card reads
its input's min and max on the host first).

:func:`moe_ffn_sharded` is the reference's expert-parallel path over a
mesh (a :class:`~repro_torch.distributed.meshctx.MeshPolicy`), driven
by this one process: the model axis owns the experts in contiguous
slices, and either

* (prefill-sized) tokens split over batch x model, each shard routes
  its own tokens, packs them per owning shard up to a capacity (GShard:
  what is past it is dropped and counted), the packs go through an
  ``all_to_all`` along the model axis, each shard runs its own experts
  (with a per-expert capacity when it owns more than one), and a second
  ``all_to_all`` brings the rows back to be combined; or
* (decode-sized) the tokens are whole on every model shard, each shard
  computes only the entries routed to its own experts (with the same
  per-expert capacity when it owns more than one), and the partial
  outputs are summed over the model axis.  What that capacity drops is
  counted here too; the reference's body drops the same entries and
  reports 0.

The collectives are ``distributed.compat``'s, in fixed shard order; the
expert products stay ``torch.matmul`` per expert, as on the local path.

:func:`moe_ffn_tp` is the same two bodies in the partitioned layout
(``distributed/tensor_parallel.py``, a policy with rules): each
coordinate holds its E / n_model whole experts as placed blocks, the
all-to-all body cuts each data shard's own rows into its model group's
token slices, and the psum body gathers the whole batch's rows over the
batch axes first, as the reference replicates them; the capacities are
the ones above, computed from the global token count, so both layouts
drop the same entries and report the same metrics.

:func:`moe_ffn` is the home layout's entry: the sharded path when given
a policy with a mesh whose model axis divides the experts, else the
local path or its hot-expert branch: the trainer passes the hot set down
explicitly (``make_train_step(hot_experts=)``), where the reference
installs it in a process-global around its trace.

Routing ties: ``jax.lax.top_k`` returns the lower expert id first among
equal logits.  :func:`route` takes the first k of a stable descending
sort, which keeps that order (``torch.topk`` promises none).

The Morpheus hot-expert fast path
(``core/passes/branch_inject.py::moe_ffn_hotpath``) goes through the same
:func:`_dispatch` with the hot experts' groups, so for a batch whose
tokens all route to hot experts both paths issue the same GEMM on the
same rows per expert and agree bit for bit.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..distributed import compat
from .config import MoEConfig, ModelConfig
from .layers import _act, ffn, ffn_tp, init_ffn
from .params import Initializer


def init_moe(ini: Initializer, cfg: ModelConfig):
    """The reference's tree: an f32 router (also in a bf16 model), expert
    stacks ``w1`` / ``w3`` (E, D, F) and ``w2`` (E, F, D), and ``shared``
    (a gated FFN of ``num_shared`` experts' width) when it is set."""
    moe: MoEConfig = cfg.moe
    d = cfg.d_model
    f = moe.expert_d_ff or cfg.d_ff
    E = moe.num_experts
    p = {
        "w_router": ini.normal((d, E), dtype=torch.float32),
        "b_router": ini.zeros((E,), dtype=torch.float32),
        "w1": ini.normal((E, d, f)),
        "w3": ini.normal((E, d, f)),
        "w2": ini.normal((E, f, d), fan_in=f),
    }
    if moe.num_shared:
        p["shared"] = init_ffn(ini, d, moe.num_shared *
                               (moe.shared_d_ff or f))
    return p


def route(w_router, x2d: torch.Tensor, top_k: int, bias=None):
    """x2d: (T,D) -> gates (T,K) fp32, ids (T,K) int32, logits (T,E) fp32.
    ``bias``: additive per-expert routing bias."""
    logits = x2d.float() @ w_router.float()
    if bias is not None:
        logits = logits + bias.float()
    gates, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :top_k], ids[:, :top_k]
    gates = torch.softmax(gates, dim=-1)
    return gates, ids.to(torch.int32), logits


def load_balance_loss(logits: torch.Tensor, ids: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss (per-shard; caller averages).  The
    reference sums a one-hot of the ids; the counts here are the same
    integers (exact in f32), by a scatter that does the same work on
    every device (``F.one_hot`` checks its ids' range on the host first,
    on the CPU)."""
    probs = torch.softmax(logits, dim=-1)                    # (T,E)
    density_proxy = probs.mean(dim=0)                        # (E,)
    density = (_counts(ids.reshape(-1).long(), n_experts).float()
               / ids.numel())                                # (E,)
    return n_experts * (density * density_proxy).sum()


def host_sizes(counts: torch.Tensor, total: int) -> List[int]:
    """The per-expert row counts ``counts`` (n,) read to the host: the one
    device-to-host read of a MoE layer.  A ``meta`` tensor (a dry run's
    trace) has no values: there the ``total`` routed rows are split
    evenly over the n groups, the first ``total % n`` one row larger (a
    balanced router; the expert products' FLOPs do not depend on the
    split, and every expert's weights are touched)."""
    if counts.device.type != "meta":
        return counts.tolist()
    n = counts.numel()
    q, r = divmod(int(total), n)
    return [q + 1 if i < r else q for i in range(n)]


def _expert_compute(xs: torch.Tensor, group_sizes: Sequence[int],
                    w1, w3, w2, act: str = "silu",
                    experts: Optional[Sequence[int]] = None
                    ) -> torch.Tensor:
    """xs: (N,D) sorted by group; ``group_sizes`` (host ints) give the
    row count of each group; group g runs expert ``experts[g]`` (default:
    group g is expert g) of the stacked weights.  Returns (N,D)."""
    experts = range(len(group_sizes)) if experts is None else experts
    # one unbind a stack: under autograd each stack's gradient is built
    # once, not a zero-filled stack per expert
    w1, w3, w2 = w1.unbind(0), w3.unbind(0), w2.unbind(0)
    out = []
    start = 0
    for e, g in zip(experts, group_sizes):
        if g == 0:
            continue
        rows = xs[start:start + g]
        h = _act(rows @ w1[e], act) * (rows @ w3[e])
        out.append(h @ w2[e])
        start += g
    if not out:
        return xs.new_zeros(xs.shape)
    return torch.cat(out)


def _dispatch(params, x2d: torch.Tensor, gates: torch.Tensor,
              keys: torch.Tensor, group_sizes: Sequence[int],
              experts: Sequence[int], top_k: int, act: str) -> torch.Tensor:
    """Sort the T*K (token, choice) pairs by ``keys`` (a stable sort, as
    ``jnp.argsort``), run the groups, unsort and combine with the gates."""
    T, D = x2d.shape
    order = torch.argsort(keys, stable=True)
    xs = x2d[order // top_k]
    ys = _expert_compute(xs, group_sizes, params["w1"], params["w3"],
                         params["w2"], act, experts)
    y = torch.empty_like(ys)
    y[order] = ys                                            # unsort
    y = (y.reshape(T, top_k, D) * gates[..., None].to(y.dtype)).sum(dim=1)
    return y.to(x2d.dtype)


def moe_ffn_local(params, x2d: torch.Tensor, moe: MoEConfig,
                  act: str = "silu", aux_loss: bool = True):
    """(y, metrics); ``aux_loss=False`` skips the load-balance loss (its
    metric is then a host 0.0), for callers that discard it."""
    E, K = moe.num_experts, moe.top_k
    gates, ids, logits = route(params["w_router"], x2d, K,
                               params.get("b_router"))
    flat_ids = ids.reshape(-1).long()                        # (T*K,)
    group_sizes = torch.zeros(E, dtype=torch.long, device=x2d.device
                              ).scatter_add_(0, flat_ids,
                                             torch.ones_like(flat_ids))
    y = _dispatch(params, x2d, gates, flat_ids,
                  host_sizes(group_sizes, flat_ids.numel()), range(E), K,
                  act)
    aux = load_balance_loss(logits, ids, E) if aux_loss else 0.0
    return y, {"aux_loss": aux, "dropped": 0.0,
               "expert_counts": group_sizes.to(torch.int32)}


# ---------------------------------------------------------------------------
# Sharded expert-parallel path (a mesh, one controlling process)
# ---------------------------------------------------------------------------

def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(ids, length=n)`` as a scatter (no host read)."""
    return torch.zeros(n, dtype=torch.long, device=ids.device
                       ).scatter_add_(0, ids, torch.ones_like(ids))


def _expert_groups(xs: torch.Tensor, group_sizes: Sequence[int], w1, w3,
                   w2, act: str, cap_e: Optional[int] = None):
    """Rows of ``xs`` sorted into contiguous expert groups (rows past
    ``sum(group_sizes)`` belong to none and come back zero).  With
    ``cap_e`` an expert takes at most its first ``cap_e`` rows and the
    rest come back zero and are counted (the reference's capacity-blocked
    grouped matmul).  Returns ((N, D), dropped)."""
    out = xs.new_zeros(xs.shape)
    if cap_e is None:
        n = sum(group_sizes)
        if n:
            out[:n] = _expert_compute(xs[:n], group_sizes, w1, w3, w2, act)
        return out, 0
    kept = [min(g, cap_e) for g in group_sizes]
    starts = np.cumsum([0] + list(group_sizes[:-1]))
    sel = [torch.arange(int(a), int(a) + k) for a, k in zip(starts, kept)
           if k]
    if sel:
        sel = torch.cat(sel).to(xs.device)
        out[sel] = _expert_compute(xs[sel], kept, w1, w3, w2, act)
    return out, sum(g - k for g, k in zip(group_sizes, kept))


def _shard_route(x, wr, br, moe: MoEConfig, n_model: int, cap: int):
    """Stage 1 of the all-to-all body, one token shard: route, sort the
    (token, choice) entries by expert, rank them within their owning
    shard, and pack the first ``cap`` for each owner into its block of
    ``send_x`` / ``send_id`` (local expert id, -1 for an empty slot)."""
    T, D = x.shape
    E, K = moe.num_experts, moe.top_k
    E_l = E // n_model
    gates, ids, logits = route(wr, x, K, br)
    flat = ids.reshape(-1).long()
    N = flat.shape[0]
    order = torch.argsort(flat, stable=True)
    s_ids = flat[order]
    s_dest = s_ids // E_l
    cnt = _counts(s_dest, n_model)
    starts = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(N, device=x.device) - starts[s_dest]
    keep = rank < cap
    slot = s_dest * cap + torch.where(keep, rank, 0)
    send_x = x.new_zeros((n_model * cap, D))
    send_id = torch.full((n_model * cap,), -1, dtype=torch.long,
                         device=x.device)
    send_x[slot[keep]] = x[(order // K)[keep]]
    send_id[slot[keep]] = (s_ids % E_l)[keep]
    dropped = N - sum(min(c, cap) for c in host_sizes(cnt, N))
    return dict(gates=gates, ids=ids, logits=logits, order=order,
                slot=slot, keep=keep, send_x=send_x, send_id=send_id,
                dropped=dropped)


def _shard_experts(rx, rid, w1, w3, w2, act: str, cap_e: Optional[int],
                   n_rows: int):
    """Stage 2, one expert shard: run its experts on the rows it received
    (``rid`` the local expert id, -1 for an empty slot; ``n_rows`` the
    rows a balanced router sends it, for a trace on ``meta``); returns
    the rows in received order (empty slots zero) and the rows
    dropped."""
    E_l = w1.shape[0]
    valid = rid >= 0
    cid = torch.where(valid, rid, E_l)
    lorder = torch.argsort(cid, stable=True)
    gs = host_sizes(_counts(cid, E_l + 1)[:E_l], n_rows)
    ly, dropped = _expert_groups(rx[lorder], gs, w1, w3, w2, act, cap_e)
    ry = torch.empty_like(ly)
    ry[lorder] = ly
    return ry * valid[:, None].to(ry.dtype), dropped


def _expert_slice(params, mi: int, E_l: int, dev):
    return tuple(params[w][mi * E_l:(mi + 1) * E_l].to(dev)
                 for w in ("w1", "w3", "w2"))


def _all_to_all_caps(T_l: int, moe: MoEConfig, n_model: int):
    """The all-to-all body's capacities for token shards of ``T_l``
    tokens: ``cap``, a sender's slots for each expert shard (GShard),
    ``cap_e``, an expert's rows when a shard owns more than one (else
    None), and ``n_rows``, the rows a balanced router sends one expert
    shard (what a trace on ``meta`` runs: each of its n_model senders'
    share, up to ``cap``)."""
    K, E_l = moe.top_k, moe.num_experts // n_model
    cap = _ceil8(int(max(8, round(T_l * K / n_model
                                  * moe.capacity_factor))))
    cap_e = (_ceil8(int(-(-(n_model * cap) // E_l) * 1.25)) if E_l > 1
             else None)
    return cap, cap_e, n_model * min(cap, -(-T_l * K // n_model))


def _combine(by, s: dict, T_l: int, K: int, dtype) -> torch.Tensor:
    """Stage 3 of the all-to-all body, one token shard: the rows its
    packs came back with (``by``, in slot order) to its tokens: slot ->
    sorted entry -> (token, choice), weighted by the gates and summed
    over the choices; an entry past its capacity adds zero."""
    yk = by[s["slot"]] * s["keep"][:, None].to(by.dtype)
    y = torch.empty_like(yk)
    y[s["order"]] = yk
    return (y.reshape(T_l, K, -1) * s["gates"][..., None].to(y.dtype)
            ).sum(dim=1).to(dtype)


def _moe_all_to_all(params, x2d, moe: MoEConfig, act: str, pol):
    """Token-sharded expert parallelism (module docstring, first path);
    returns (y, aux, dropped, counts) on x2d's device."""
    mesh, mdl = pol.mesh, pol.model_axis
    batch, n_model = tuple(pol.batch_axes), pol.n_model
    E, K = moe.num_experts, moe.top_k
    E_l = E // n_model
    axes = batch + (mdl,)
    n_tok = mesh.axes_size(axes)
    T, home = x2d.shape[0], x2d.device
    T_l = T // n_tok
    cap, cap_e, n_rows = _all_to_all_caps(T_l, moe, n_model)
    wr, br = params["w_router"], params.get("b_router")
    st = compat.shard_map(
        lambda i, d: dict(_shard_route(
            x2d[i * T_l:(i + 1) * T_l].to(d), wr.to(d),
            None if br is None else br.to(d), moe, n_model, cap), dev=d),
        mesh, axes)
    devs = [s["dev"] for s in st]
    coords = mesh.shard_coords(axes)
    ys, dropped = [None] * n_tok, sum(s["dropped"] for s in st)
    for g in range(n_tok // n_model):        # one batch shard's group
        mine = range(g * n_model, (g + 1) * n_model)
        rx = compat.all_to_all([st[i]["send_x"] for i in mine])
        rid = compat.all_to_all([st[i]["send_id"] for i in mine])
        back = []
        for mi, i in enumerate(mine):
            with compat.at(coords[i]):
                w = _expert_slice(params, mi, E_l, devs[i])
                ry, d = _shard_experts(rx[mi], rid[mi], *w, act, cap_e,
                                       n_rows)
            back.append(ry)
            dropped += d
        by = compat.all_to_all(back)
        for mi, i in enumerate(mine):
            with compat.at(coords[i]):
                ys[i] = _combine(by[mi], st[i], T_l, K, x2d.dtype)
    aux = compat.psum([load_balance_loss(s["logits"], s["ids"], E)
                       for s in st], home) / n_tok
    counts = compat.psum([_counts(s["ids"].reshape(-1).long(), E)
                          for s in st], home).to(torch.int32)
    return (compat.all_gather(ys, 0, home), aux,
            torch.tensor(float(dropped), device=home), counts)


def _psum_cap(T: int, moe: MoEConfig, E_l: int) -> Optional[int]:
    """The psum body's rows an expert takes when a shard owns more than
    one (else None): twice a balanced share of the T * K entries."""
    return _ceil8(-(-(T * moe.top_k) // E_l) * 2) if E_l > 1 else None


def _psum_part(x, wr, br, w1, w3, w2, moe: MoEConfig, act: str, me: int,
               cap_e: Optional[int]):
    """The psum body on one model shard ``me`` owning the experts of
    ``w1`` / ``w3`` / ``w2``: route all T tokens of ``x``, run the
    entries routed to its own experts (at most ``cap_e`` an expert, the
    rest dropped and counted), and combine them with the gates: (its
    partial output (T, D), dropped, ids, router logits)."""
    T = x.shape[0]
    E_l, K = w1.shape[0], moe.top_k
    n_model = moe.num_experts // E_l
    gates, ids, logits = route(wr, x, K, br)
    flat = ids.reshape(-1).long()
    owned = (flat // E_l) == me
    cid = torch.where(owned, flat % E_l, 0)
    order = torch.argsort(cid + torch.where(owned, 0, E_l), stable=True)
    gs = host_sizes(_counts(torch.where(owned, cid, E_l), E_l + 1)[:E_l],
                    T * K // n_model)
    ys, dropped = _expert_groups(x[order // K], gs, w1, w3, w2, act, cap_e)
    y = torch.empty_like(ys)
    y[order] = ys
    part = (y.reshape(T, K, -1) * gates[..., None].to(y.dtype)).sum(dim=1)
    return part, dropped, ids, logits


def _moe_psum(params, x2d, moe: MoEConfig, act: str, pol):
    """Replicated-token expert parallelism (module docstring, second
    path): each model shard computes its own experts' entries, at most
    ``cap_e`` an expert (the rest dropped and counted), and the partial
    outputs and drop counts are summed over the model axis in shard
    order.  The reference repeats this on every batch shard; here it
    runs once."""
    mesh, mdl, n_model = pol.mesh, pol.model_axis, pol.n_model
    E = moe.num_experts
    E_l = E // n_model
    T, home = x2d.shape[0], x2d.device
    cap_e = _psum_cap(T, moe, E_l)
    wr, br = params["w_router"], params.get("b_router")
    parts = compat.shard_map(
        lambda me, dev: _psum_part(
            x2d.to(dev), wr.to(dev), None if br is None else br.to(dev),
            *_expert_slice(params, me, E_l, dev), moe, act, me, cap_e),
        mesh, (mdl,))
    y = compat.psum([p[0] for p in parts], home).to(x2d.dtype)
    dropped = sum(p[1] for p in parts)
    _, _, ids, logits = parts[-1]
    aux = load_balance_loss(logits, ids, E).to(home)
    counts = _counts(ids.reshape(-1).long(), E).to(home, torch.int32)
    return y, aux, torch.tensor(float(dropped), device=home), counts


def moe_ffn_sharded(params, x2d: torch.Tensor, moe: MoEConfig,
                    act: str = "silu", policy=None):
    """The reference's ``moe_ffn_sharded``: (y, metrics) for x2d (T, D)
    over ``policy``'s mesh.  The all-to-all path when T splits evenly
    into batch x model shards of at least 8 tokens, else the
    replicated-token path.  Metrics: ``aux_loss`` averaged over the
    token shards, ``dropped`` (tokens past a capacity) and
    ``expert_counts`` summed."""
    pol = policy
    n_tok = pol.n_batch_shards * pol.n_model
    T = x2d.shape[0]
    if T % n_tok == 0 and T // n_tok >= 8:
        y, aux, dropped, counts = _moe_all_to_all(params, x2d, moe, act,
                                                  pol)
    else:
        y, aux, dropped, counts = _moe_psum(params, x2d, moe, act, pol)
    return y, {"aux_loss": aux, "dropped": dropped,
               "expert_counts": counts}


# ---------------------------------------------------------------------------
# The partitioned layout (distributed/tensor_parallel.py): placed blocks
# ---------------------------------------------------------------------------

def _moe_tp_all_to_all(run, p: dict, h: dict, moe: MoEConfig, act: str,
                       T: int):
    """The all-to-all body on each data shard's own rows: coordinate
    (b, m) routes token slice m of its data shard's B_l * S rows (token
    shard b * n_model + m of the global batch, the reference's
    ``P(batch + (model,))``), the packs go to their expert shards and
    back by two all-to-alls over the model group, each coordinate runs
    its own experts' blocks, and an all-gather over the group gives
    every member its data shard's rows again."""
    if run.row_axes != run.batch_axes:
        raise NotImplementedError(
            f"the partitioned MoE's all-to-all body cuts each data "
            f"shard's rows into its model group's token slices; a batch "
            f"split over {run.row_axes} rather than the policy's batch "
            f"axes {run.batch_axes} is not ported")
    n_model, E, K = run.n_model, moe.num_experts, moe.top_k
    n_tok = run.n_batch * n_model
    T_l = T // n_tok
    cap, cap_e, n_rows = _all_to_all_caps(T_l, moe, n_model)
    shape = next(iter(h.values())).shape

    def route_slice(c):
        j = run.m(c)
        x = h[c].reshape(-1, shape[-1])[j * T_l:(j + 1) * T_l]
        return _shard_route(x, p[c]["w_router"], p[c].get("b_router"), moe,
                            n_model, cap)
    st = run.each(route_slice)

    def to_shards(blocks):
        """Coordinate c receives block m(c) (``cap`` rows) of each
        member's ``blocks[member]``, in model order."""
        return run.exchange(lambda c, g: [
            (s, blocks[s][run.m(c) * cap:(run.m(c) + 1) * cap])
            for s in g], 0)
    rx = to_shards({c: st[c]["send_x"] for c in run.coords})
    rid = to_shards({c: st[c]["send_id"] for c in run.coords})
    done = run.each(lambda c: _shard_experts(
        rx[c], rid[c], p[c]["w1"], p[c]["w3"], p[c]["w2"], act, cap_e,
        n_rows))
    by = to_shards({c: done[c][0] for c in run.coords})
    ys = run.each(lambda c: _combine(by[c], st[c], T_l, K, h[c].dtype))
    y = run.exchange(lambda c, g: [(s, ys[s]) for s in g], 0, "all-gather")
    y = run.each(lambda c: y[c].reshape(shape))
    aux = run.psum_all(run.each(lambda c: load_balance_loss(
        st[c]["logits"], st[c]["ids"], E))) / n_tok
    counts = run.psum_all(run.each(lambda c: _counts(
        st[c]["ids"].reshape(-1).long(), E))).to(torch.int32)
    dropped = sum(st[run.rep[d]]["dropped"] + done[run.rep[d]][1]
                  for d in run.mesh.coords())
    return y, aux, dropped, counts


def _moe_tp_psum(run, p: dict, h: dict, moe: MoEConfig, act: str,
                 T: int):
    """The psum body, as the reference's: every coordinate gathers the
    whole batch's T rows over the batch axes, computes its own experts'
    entries over all T (``cap_e`` from the global T), the model group
    sums the partials of the coordinate's rows in model order (one
    all-reduce), and each keeps its rows.  Every data shard repeats the
    routing, so the metrics are the first model group's: the home
    coordinate's ``aux`` and counts (every coordinate routes the same
    tokens alike), and the drops of its group's expert shards."""
    shape = next(iter(h.values())).shape
    D, E = shape[-1], moe.num_experts
    E_l = E // run.n_model
    cap_e = _psum_cap(T, moe, E_l)
    xs = run.gather_rows(run.each(lambda c: h[c].reshape(-1, D)))
    parts = run.each(lambda c: _psum_part(
        xs[c], p[c]["w_router"], p[c].get("b_router"), p[c]["w1"],
        p[c]["w3"], p[c]["w2"], moe, act, run.m(c), cap_e))
    n = shape[0] * shape[1]
    mine = run.each(lambda c: parts[c][0][
        run.mesh.axis_index(c, run.row_axes) * n:][:n])
    y = run.all_reduce(mine)
    y = run.each(lambda c: y[c].to(h[c].dtype).reshape(shape))
    _, _, ids, logits = parts[run.coords[0]]
    aux = load_balance_loss(logits, ids, E)
    counts = _counts(ids.reshape(-1).long(), E).to(torch.int32)
    dropped = sum(parts[c][1] for c in run.groups[0])
    return y, aux, dropped, counts


def moe_ffn_tp(run, cfg: ModelConfig, p: dict, sh, h: dict):
    """:func:`moe_ffn` of the partitioned layout: ``h[c]`` coordinate
    c's rows (B_l, S, D), ``p[c]`` its blocks of the layer's MoE params
    (``w1`` / ``w3`` / ``w2`` its own E / n_model whole experts, the
    router replicated, a shared FFN's MLP columns), ``sh`` their
    shardings.  The all-to-all body when the global T = B * S splits
    evenly into batch x model token shards of at least 8 tokens, else
    the psum body (the reference's test, with the caps of
    :func:`moe_ffn_sharded`, which drop the same entries).  Returns
    ``({c: (B_l, S, D)}, metrics)``, the metrics on the mesh's home
    device: ``aux_loss`` averaged over the token shards, ``dropped`` and
    ``expert_counts`` summed, as the home layout's."""
    moe = cfg.moe
    T = run.B * next(iter(h.values())).shape[1]
    n_tok = run.n_batch * run.n_model
    body = (_moe_tp_all_to_all if T % n_tok == 0 and T // n_tok >= 8
            else _moe_tp_psum)
    y, aux, dropped, counts = body(run, p, h, moe, cfg.ffn_act, T)
    if moe.num_shared:
        shared = ffn_tp(run, {c: p[c]["shared"] for c in run.coords},
                        sh["shared"]["w_down"], h, cfg.ffn_act)
        y = run.each(lambda c: y[c] + shared[c])
    return y, {"aux_loss": aux, "dropped": torch.tensor(
        float(dropped), device=run.mesh.home), "expert_counts": counts}


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig,
            aux_loss: bool = True,
            hot_experts: Optional[Sequence[int]] = None, policy=None):
    """x: (B,S,D) -> (y, metrics), the reference's ``moe_ffn``:
    :func:`moe_ffn_sharded` under a ``policy`` with a mesh whose model
    axis divides the experts; otherwise ``moe_ffn_local`` over the B*S tokens, or, given a
    hot-expert set smaller than the expert count, the branch-injected
    ``moe_ffn_hotpath`` (the reference reads that set from a
    process-global installed around its trace; the trainer passes it
    here explicitly); plus the shared experts' FFN when ``num_shared``
    is set."""
    moe = cfg.moe
    B, S, D = x.shape
    if (policy is not None and policy.mesh is not None
            and moe.num_experts % policy.n_model == 0):
        y, metrics = moe_ffn_sharded(params, x.reshape(B * S, D), moe,
                                     cfg.ffn_act, policy)
    elif hot_experts and len(hot_experts) < moe.num_experts:
        from ..core.passes.branch_inject import moe_ffn_hotpath
        y, metrics = moe_ffn_hotpath(params, x.reshape(B * S, D), cfg,
                                     tuple(hot_experts), cfg.ffn_act)
    else:
        y, metrics = moe_ffn_local(params, x.reshape(B * S, D), moe,
                                   cfg.ffn_act, aux_loss)
    y = y.reshape(B, S, D)
    if moe.num_shared:
        y = y + ffn(params["shared"], x, cfg.ffn_act)
    return y, metrics
