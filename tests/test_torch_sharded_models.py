"""The port's explicit mesh branches of the models, on a debug mesh of
repeated CPU devices, held against the reference's single-device
functions in process on one JAX device (the reference's own subprocess
tests show its sharded paths equal its single-device ones):

* ``moe_ffn_sharded`` on a (2, 2) mesh, both bodies — the all-to-all
  one at prefill size and the psum one at decode size — against the
  reference's ``moe_ffn_local`` within ``MOE_TOL`` = 1e-5 of max |y| in
  f32, with nothing dropped at the reference test's capacity (the twin
  of ``test_sharding_elastic.py::test_moe_sharded_matches_local``);
* the sequence-parallel GQA decode against the reference's
  single-device decode (``attend_blocked`` over the cache's positions)
  within ``ATTN_TOL`` = 1e-5 (absolute, f32): phi3.5's GQA 4, a window
  with a softcap (gemma2-like), KV shards with no visible slot, batch 1
  (``"data"`` joins the sequence split), and the reference test's (2, 4)
  mesh (the twin of ``test_gqa_seq_parallel_decode_matches_reference``);
  and through ``gqa_forward(policy=)`` against the reference's
  ``gqa_forward`` one decode step on;
* the sequence-parallel MLA decode likewise, through ``mla_forward``;
* ``ops.flash_attention(return_lse=True)``'s plain path against a
  float64 logsumexp (``LSE_TOL`` = 1e-5 absolute, log2 units).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as JA
from repro.models import params as JP
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.moe import moe_ffn_local as j_moe_ffn_local
from repro_torch.configs import get_config
from repro_torch.distributed.meshctx import MeshPolicy
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import attention as TA
from repro_torch.models.config import MoEConfig
from repro_torch.models.moe import moe_ffn, moe_ffn_local, \
    moe_ffn_sharded
from repro_torch.models.params import tree_from_numpy

MOE_TOL, ATTN_TOL, LSE_TOL = 1e-5, 1e-5, 1e-5


def _policy(n_data=2, n_model=2):
    return MeshPolicy(mesh=make_debug_mesh(n_data, n_model, device="cpu"),
                      batch_axes=("data",))


def _moe_params(E, d=16, f=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"w_router": rng.standard_normal((d, E)).astype(np.float32),
            "b_router": np.zeros(E, np.float32),
            "w1": rng.standard_normal((E, d, f)).astype(np.float32) * .25,
            "w3": rng.standard_normal((E, d, f)).astype(np.float32) * .25,
            "w2": rng.standard_normal((E, f, d)).astype(np.float32) * .18}


@pytest.mark.parametrize("E,T", [(4, 64), (4, 6), (8, 64), (8, 5)],
                         ids=["a2a-E4", "psum-E4", "a2a-E8", "psum-E8"])
def test_moe_sharded_matches_reference_local(E, T):
    """64 tokens split 4 ways (16 a shard >= 8) take the all-to-all
    body, 5 or 6 tokens the psum body; E 8 puts two experts on a shard,
    which takes the per-expert capacity blocking."""
    p = _moe_params(E)
    x = np.random.default_rng(1).standard_normal((T, 16)).astype(np.float32)
    kw = dict(num_experts=E, top_k=2, expert_d_ff=32, capacity_factor=4.0)
    jy, jm = j_moe_ffn_local({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), JMoEConfig(**kw))
    pol = _policy()
    ty, tm = moe_ffn_sharded(tree_from_numpy(p, "cpu"), torch.from_numpy(x),
                             MoEConfig(**kw), policy=pol)
    jy = np.asarray(jy)
    assert ty.shape == jy.shape
    err = np.abs(ty.numpy() - jy).max()
    assert err <= MOE_TOL * np.abs(jy).max(), err
    assert float(tm["dropped"]) == 0.0
    np.testing.assert_array_equal(tm["expert_counts"].numpy(),
                                  np.asarray(jm["expert_counts"]))
    # the aux loss is per token shard, averaged (the reference's pmean):
    # the all-to-all body's 4 shards, the psum body's whole batch
    from repro.models.moe import load_balance_loss as j_lbl, route as j_route
    jpar = {k: jnp.asarray(v) for k, v in p.items()}
    shards = np.split(x, 4) if T == 64 else [x]
    want = np.mean([float(j_lbl(lg, ids, E)) for lg, ids in (
        j_route(jpar["w_router"], jnp.asarray(xs), 2, jpar["b_router"])[2:0:-1]
        for xs in shards)])
    np.testing.assert_allclose(float(tm["aux_loss"]), want, rtol=1e-5)


def test_moe_sharded_counts_what_capacity_drops():
    """At capacity factor 0.25 the all-to-all body drops entries and
    counts them; the dropped entries contribute nothing."""
    p = _moe_params(4)
    x = np.random.default_rng(2).standard_normal((64, 16)).astype(np.float32)
    cfg = MoEConfig(num_experts=4, top_k=2, expert_d_ff=32,
                    capacity_factor=0.25)
    y, m = moe_ffn_sharded(tree_from_numpy(p, "cpu"), torch.from_numpy(x),
                           cfg, policy=_policy())
    assert float(m["dropped"]) > 0 and torch.isfinite(y).all()


def test_moe_sharded_psum_body_counts_what_capacity_drops():
    """12 tokens on a (2, 2) mesh take the psum body (3 a token shard,
    under 8); a router bias sends every one to expert 0, top-1, so the
    per-expert capacity (4 experts a shard: ceil8(2 ceil(12 / 4)) = 8)
    keeps the first 8 in token order and drops the last 4: counted,
    and their rows come back zero."""
    p = _moe_params(8)
    p["b_router"][0] = 100.0
    x = np.random.default_rng(4).standard_normal((12, 16)).astype(
        np.float32)
    cfg = MoEConfig(num_experts=8, top_k=1, expert_d_ff=32,
                    capacity_factor=4.0)
    y, m = moe_ffn_sharded(tree_from_numpy(p, "cpu"), torch.from_numpy(x),
                           cfg, policy=_policy())
    assert float(m["dropped"]) == 4.0
    assert m["expert_counts"].tolist() == [12, 0, 0, 0, 0, 0, 0, 0]
    assert (y[8:] == 0).all() and (y[:8].abs().amax(-1) > 0).all()
    y_local, _ = moe_ffn_local(tree_from_numpy(p, "cpu"),
                               torch.from_numpy(x), cfg)
    assert (y[:8] - y_local[:8]).abs().max() <= MOE_TOL * \
        y_local.abs().max()


def test_moe_ffn_takes_the_sharded_branch_under_a_policy():
    from repro_torch.models.config import ModelConfig
    p = tree_from_numpy(_moe_params(4), "cpu")
    cfg = ModelConfig(d_model=16, moe=MoEConfig(
        num_experts=4, top_k=2, expert_d_ff=32, capacity_factor=4.0))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 32, 16)).astype(np.float32))
    y_local, _ = moe_ffn(p, x, cfg)
    y_mesh, m = moe_ffn(p, x, cfg, policy=_policy())
    assert m["dropped"].dim() == 0          # the sharded path's metrics
    assert (y_mesh - y_local).abs().max() <= MOE_TOL * y_local.abs().max()


# ---------------------------------------------------------------------------
# sequence-parallel GQA decode
# ---------------------------------------------------------------------------

GQA_CASES = {
    # name: (B, cap, H, Hkv, D, start, window, softcap, mesh)
    "phi3.5-gqa4": (4, 64, 8, 2, 16, 50, None, 0.0, (2, 2)),
    "window-softcap": (4, 64, 8, 4, 16, 60, 20, 50.0, (2, 2)),
    "empty-shards": (2, 64, 4, 1, 16, 10, None, 0.0, (2, 2)),
    "batch1-data-joins-seq": (1, 64, 8, 2, 16, 47, None, 0.0, (2, 2)),
    "reference-2x4-window": (4, 64, 8, 2, 16, 63, 20, 0.0, (2, 4)),
}


@pytest.mark.parametrize("case", list(GQA_CASES))
def test_gqa_seq_parallel_decode_matches_reference(case):
    B, cap, H, Hkv, D, start, window, softcap, mesh = GQA_CASES[case]
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, cap, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, cap, Hkv, D)).astype(np.float32)
    pos = np.where(np.arange(cap) <= start, np.arange(cap), -1).astype(
        np.int32)
    ref = JA.attend_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            q_pos=jnp.asarray([start], jnp.int32),
                            kv_pos=jnp.asarray(pos), causal=True,
                            window=window, logit_softcap=softcap, block=16)
    pol = _policy(*mesh)
    out = TA._gqa_decode_seq_parallel(
        pol, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        start, window=window, logit_softcap=softcap)
    err = np.abs(out.numpy() - np.asarray(ref)).max()
    assert err < ATTN_TOL, err
    shards = list(TA._seq_shards(pol, B, cap, 0, start + 1, False))
    if case == "empty-shards":
        assert len(shards) < pol.mesh.size          # some were skipped
    if case == "batch1-data-joins-seq":
        assert TA.n_seq_shards(pol, B) == 4 and len(shards) == 3


def test_gqa_forward_decode_branch_matches_reference():
    """One decode step of ``gqa_forward`` through the mesh branch, after
    the same prefill in both packages (phi3.5's smoke widths, f32)."""
    arch = "phi3.5-moe-42b-a6.6b"
    jcfg, tcfg = j_get_config(arch).smoke(), get_config(arch).smoke()
    ini = JP.Initializer(jax.random.PRNGKey(0), dtype=jnp.float32)
    jp = JP.unzip(JA.init_attention(ini, jcfg))[0]
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    B, cap, S = 2, 32, 13
    Hkv, hd = jcfg.n_kv_heads, jcfg.head_dim_
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S + 1, jcfg.d_model)).astype(np.float32)
    jc = {"k": jnp.zeros((B, cap, Hkv, hd)), "v": jnp.zeros((B, cap, Hkv, hd)),
          "pos": jnp.full((cap,), -1, jnp.int32)}
    tc = {"k": torch.zeros((B, cap, Hkv, hd)),
          "v": torch.zeros((B, cap, Hkv, hd)),
          "pos": torch.full((cap,), -1, dtype=torch.int32)}
    _, jc = JA.gqa_forward(jp, jcfg, jnp.asarray(x[:, :S]),
                           jnp.arange(S, dtype=jnp.int32), cache=jc)
    _, tc = TA.gqa_forward(tp, tcfg, torch.from_numpy(x[:, :S]), 0,
                           cache=tc)
    jo, _ = JA.gqa_forward(jp, jcfg, jnp.asarray(x[:, S:]),
                           jnp.asarray([S], jnp.int32), cache=jc)
    to, _ = TA.gqa_forward(tp, tcfg, torch.from_numpy(x[:, S:]), S,
                           cache=tc, policy=_policy())
    jo = np.asarray(jo)
    assert np.abs(to.numpy() - jo).max() <= 1e-4 * np.abs(jo).max()


# ---------------------------------------------------------------------------
# sequence-parallel MLA decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,start,mesh", [(2, 40, (2, 2)), (1, 9, (2, 2)),
                                          (4, 63, (2, 4))],
                         ids=["batch-split", "batch1-empty-shard", "2x4"])
def test_mla_seq_parallel_decode_matches_reference(B, start, mesh):
    """The reference's absorbed decode (single device) and the port's
    ``mla_forward`` through ``_mla_decode_seq_parallel`` over the same
    f32 cache: the port's prefill writes it, and the reference reads a
    copy of those bytes."""
    arch = "deepseek-v2-236b"
    jcfg, tcfg = j_get_config(arch).smoke(), get_config(arch).smoke()
    ini = JP.Initializer(jax.random.PRNGKey(0), dtype=jnp.float32)
    jp = JP.unzip(JA.init_mla_attention(ini, jcfg))[0]
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    m, cap = tcfg.mla, 64
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, start + 1, tcfg.d_model)).astype(np.float32)
    tc = {"ckv": torch.zeros((B, cap, m.kv_lora_rank)),
          "k_rope": torch.zeros((B, cap, m.qk_rope_dim)),
          "pos": torch.full((cap,), -1, dtype=torch.int32)}
    _, tc = TA.mla_forward(tp, tcfg, torch.from_numpy(x[:, :start]), 0,
                           cache=tc)
    jc = {k: jnp.asarray(v.numpy()) for k, v in tc.items()}
    jo, _ = JA.mla_forward(jp, jcfg, jnp.asarray(x[:, start:]),
                           jnp.asarray([start], jnp.int32), cache=jc)
    pol = _policy(*mesh)
    to, _ = TA.mla_forward(tp, tcfg, torch.from_numpy(x[:, start:]), start,
                           cache=tc, policy=pol)
    jo = np.asarray(jo)
    err = np.abs(to.numpy() - jo).max()
    assert err <= ATTN_TOL * max(1.0, np.abs(jo).max()), err


# ---------------------------------------------------------------------------
# ops.flash_attention(return_lse=True) on the host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, 0.0), (False, None, 30.0), (True, 7, 0.0)])
def test_flash_attention_lse_plain_path_matches_float64(causal, window,
                                                        softcap):
    g = torch.Generator().manual_seed(7)
    q = torch.randn(2, 24, 8, 16, generator=g)
    k = torch.randn(2, 40, 2, 16, generator=g)
    v = torch.randn(2, 40, 2, 16, generator=g)
    out, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                   logit_softcap=softcap, block=16,
                                   return_lse=True)
    # the output is the call without return_lse, bit for bit
    assert torch.equal(out, ops.flash_attention(
        q, k, v, causal=causal, window=window, logit_softcap=softcap,
        block=16))
    qd, kd = q.double(), k.double().repeat_interleave(4, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) / 4.0
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qp, kp = torch.arange(24)[:, None], torch.arange(40)[None, :]
    mask = torch.ones(24, 40, dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= qp - kp < window
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), -1) \
        / np.log(2.0)
    assert lse.shape == (2, 8, 24) and lse.dtype == torch.float32
    assert (lse.double() - want).abs().max() < LSE_TOL


def test_flash_attention_lse_row_without_keys_is_neg_inf():
    q = torch.randn(1, 3, 2, 8)
    k = torch.randn(1, 5, 2, 8)
    _, lse = ops.flash_attention(q, k, k, causal=True, window=0,
                                 return_lse=True)
    assert (lse == TA.NEG_INF).all()


def test_shard_map_and_fixed_order_collectives():
    """The port's ``shard_map`` runs its body once per shard of a split,
    on the coordinates ``Mesh.shard_coords`` gives in shard order, and
    ``psum`` / ``all_gather`` / ``all_to_all`` combine per-shard tensors
    in that order (the reference's ``test_hlo_analyzer_counts_collectives``
    body: a psum over ``"data"`` of a (data, None)-split value)."""
    from repro_torch.distributed import compat
    mesh = make_debug_mesh(4, 2, device="cpu")
    assert mesh.shard_coords(("data",)) == ((0, 0), (1, 0), (2, 0), (3, 0))
    assert mesh.shard_coords(("model",)) == ((0, 0), (0, 1))
    assert mesh.shard_coords(("model", "data")) == tuple(
        (d, m) for m in range(2) for d in range(4))
    assert mesh.shard_coords(()) == ((0, 0),)
    x = torch.arange(64.0).reshape(8, 8)
    seen = []
    data_blocks = compat.shard_map(
        lambda i, dev: seen.append((i, dev)) or x[2 * i:2 * i + 2].to(dev),
        mesh, ("data",))
    assert seen == [(i, torch.device("cpu")) for i in range(4)]
    summed = compat.psum(data_blocks)
    assert torch.equal(summed, x.reshape(4, 2, 8).sum(0))
    assert torch.equal(compat.all_gather(data_blocks), x)
    assert len(compat.shard_map(lambda i, dev: i, mesh,
                                ("data", "model"))) == 8
    ex = compat.all_to_all([torch.arange(4) + 10 * i for i in range(4)])
    assert [t.tolist() for t in ex] == [[0, 10, 20, 30], [1, 11, 21, 31],
                                        [2, 12, 22, 32], [3, 13, 23, 33]]
    sh = compat.split(x, ["cpu"] * 4)
    assert sh.shape == x.shape and np.array_equal(np.asarray(sh), x.numpy())
    assert torch.equal(compat.pmax([x, -x, 2 * x]), 2 * x)
