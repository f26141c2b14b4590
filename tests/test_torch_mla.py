"""The port's MLA attention (``models/attention.py``: ``init_mla_attention``,
``mla_forward``) against the reference's, at deepseek-v2's ``smoke()``
widths (d_model 64, 4 heads, kv_lora 32, q.k 16 + 8, v 16), in f32, with
the reference's weights carried across by ``tree_from_numpy`` and the
same numpy inputs; then the step rules of an MLA stack
(``models/transformer.py``).

Prompts of 600 tokens cross the 512-key block of both forms: the naive
form's prefill (S > 1) and the absorbed form's decode steps (S == 1).
The reference attends over the whole padded cache, the port over its
slots ``[:start+S]``; a cache of 1100 slots makes the reference walk a
third block, wholly masked, that the port never reads.

Tolerances, normwise (``max|port - ref| <= tol * max|ref|``): ``F32_TOL``
= 1e-4 in f32, with f32 caches in both frameworks (the sums run in other
orders); ``F32_CACHE_TOL`` = 2e-3 through the reference's bf16 cache, as
in ``test_torch_model.py`` (an f32 value that lands on the other side of
a bf16 rounding boundary is stored one bf16 step apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as JA
from repro.models import params as JP
from repro_torch.configs import get_config
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model
from repro_torch.models.params import Initializer, tree_from_numpy

ARCH = "deepseek-v2-236b"
F32_TOL, F32_CACHE_TOL = 1e-4, 2e-3
S_LONG, N_DECODE = 600, 3


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(out, ref, tol, what=""):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    assert np.isfinite(out).all(), what
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


def _cfgs():
    return j_get_config(ARCH).smoke(), get_config(ARCH).smoke()


def _params(seed=0):
    """The reference's f32 MLA params and the same on the port's side."""
    jcfg, tcfg = _cfgs()
    ini = JP.Initializer(jax.random.PRNGKey(seed), dtype=jnp.float32)
    jp = JP.unzip(JA.init_mla_attention(ini, jcfg))[0]
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _x(cfg, B, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _caches(cfg, B, cap, dtype):
    """An empty MLA cache of the reference's layout in each framework,
    its ``ckv`` and ``k_rope`` in ``dtype`` (jnp and torch)."""
    m = cfg.mla
    jdt, tdt = dtype
    jc = {"ckv": jnp.zeros((B, cap, m.kv_lora_rank), jdt),
          "k_rope": jnp.zeros((B, cap, m.qk_rope_dim), jdt),
          "pos": jnp.full((cap,), -1, jnp.int32)}
    tc = {"ckv": torch.zeros((B, cap, m.kv_lora_rank), dtype=tdt),
          "k_rope": torch.zeros((B, cap, m.qk_rope_dim), dtype=tdt),
          "pos": torch.full((cap,), -1, dtype=torch.int32)}
    return jc, tc


def _jmla(cfg):
    return jax.jit(lambda p, x, pos, c: JA.mla_forward(
        p, cfg, x, pos, cache=c))


def test_init_mla_attention_matches_the_reference_tree():
    """The same leaves and shapes, each drawn at the reference's scale
    (1 / sqrt(fan_in)): the port's draws' std within 15 % of the
    reference's."""
    jcfg, tcfg = _cfgs()
    jtree = JP.unzip(JA.init_mla_attention(
        JP.Initializer(jax.random.PRNGKey(0), dtype=jnp.float32), jcfg))[0]
    ttree = TA.init_mla_attention(Initializer(0, "cpu"), tcfg)
    assert sorted(ttree) == sorted(jtree) == sorted(
        ["wq", "w_dkv", "w_krope", "w_uk", "w_uv", "wo"])
    for name, j in jtree.items():
        t = ttree[name]
        assert tuple(t.shape) == tuple(j.shape), name
        assert t.dtype == torch.float32, name
        ratio = t.std().item() / float(jnp.std(j))
        assert abs(ratio - 1) < 0.15, (name, ratio)
    # the full config's shapes, on the meta device
    full = get_config(ARCH)
    tfull = TA.init_mla_attention(Initializer(0, "meta"), full)
    jfull = JP.unzip(JA.init_mla_attention(
        JP.Initializer(None, abstract=True), j_get_config(ARCH)))[0]
    assert {k: tuple(v.shape) for k, v in tfull.items()} == {
        k: tuple(v.shape) for k, v in jfull.items()}
    assert tuple(tfull["wq"].shape) == (5120, 128, 192)
    assert tuple(tfull["w_uk"].shape) == (512, 128, 128)


@pytest.mark.parametrize("S", [40, S_LONG])
def test_mla_forward_without_a_cache_matches_reference(S):
    """The naive form over S keys, no cache (S 600: two blocks)."""
    jcfg, tcfg, jp, tp = _params()
    x = _x(jcfg, 2, S)
    pos = jnp.arange(S, dtype=jnp.int32)
    ref, _ = jax.jit(lambda p, x: JA.mla_forward(p, jcfg, x, pos))(
        jp, jnp.asarray(x))
    out, cache = TA.mla_forward(tp, tcfg, torch.from_numpy(x))
    assert cache is None
    _close(out, ref, F32_TOL, f"mla no cache S {S}")


def test_mla_forward_one_token_without_a_cache_matches_reference():
    """S == 1 takes the absorbed form, also with no cache."""
    jcfg, tcfg, jp, tp = _params()
    x = _x(jcfg, 2, 1)
    ref, _ = JA.mla_forward(jp, jcfg, jnp.asarray(x),
                            jnp.arange(1, dtype=jnp.int32))
    out, _ = TA.mla_forward(tp, tcfg, torch.from_numpy(x))
    _close(out, ref, F32_TOL, "mla one token")


@pytest.mark.parametrize("cap", [640, 1100])
@pytest.mark.parametrize("cache_dtype", ["f32", "bf16"])
def test_mla_prefill_then_decode_over_a_cache_matches_reference(
        cap, cache_dtype):
    """A 600-token prefill (naive form, two blocks) and three one-token
    steps (absorbed form, two blocks) over one cache: each output, and
    the cache's ``ckv``, ``k_rope`` and ``pos`` after each call."""
    jcfg, tcfg, jp, tp = _params()
    B = 2
    x = _x(jcfg, B, S_LONG + N_DECODE)
    f32 = cache_dtype == "f32"
    dt = (jnp.float32, torch.float32) if f32 else (jnp.bfloat16,
                                                   torch.bfloat16)
    tol = F32_TOL if f32 else F32_CACHE_TOL
    jc, tc = _caches(jcfg, B, cap, dt)
    mla = _jmla(jcfg)
    for start, S in [(0, S_LONG)] + [(S_LONG + j, 1)
                                     for j in range(N_DECODE)]:
        xs = x[:, start:start + S]
        ref, jc = mla(jp, jnp.asarray(xs),
                      jnp.arange(start, start + S, dtype=jnp.int32), jc)
        before = tc
        out, tc = TA.mla_forward(tp, tcfg, torch.from_numpy(xs), start,
                                 cache=tc)
        assert all(tc[n] is before[n] for n in tc), "written in place"
        what = f"cap {cap} {cache_dtype} start {start}"
        _close(out, ref, tol, what)
        for name in ("ckv", "k_rope"):
            assert tc[name].dtype == dt[1]
            _close(tc[name], jc[name], tol, f"{what} cache {name}")
        assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert int(tc["pos"].max()) == S_LONG + N_DECODE - 1


def test_the_naive_and_absorbed_forms_agree():
    """The naive form's prefill of 600 tokens against the absorbed form
    stepped token by token over an f32 cache from position 0: the same
    outputs and caches within ``F32_TOL``."""
    _, tcfg, _, tp = _params()
    B, cap = 2, 640
    x = torch.from_numpy(_x(tcfg, B, S_LONG))
    _, naive_c = _caches(tcfg, B, cap, (jnp.float32, torch.float32))
    naive, _ = TA.mla_forward(tp, tcfg, x, 0, cache=naive_c)
    _, step_c = _caches(tcfg, B, cap, (jnp.float32, torch.float32))
    steps = [TA.mla_forward(tp, tcfg, x[:, p:p + 1], p, cache=step_c)[0]
             for p in range(S_LONG)]
    _close(torch.cat(steps, 1), naive, F32_TOL, "absorbed vs naive")
    # one row's projection against 600 rows': the GEMMs round elsewhere
    for name in ("ckv", "k_rope"):
        _close(step_c[name], naive_c[name], F32_TOL, name)
    assert torch.equal(step_c["pos"], naive_c["pos"])


def test_mla_forward_refuses_a_chunked_prefill_and_a_full_cache():
    """A chunked prefill (start > 0 with S > 1) and a step past the
    cache's slots raise before any write."""
    _, tcfg, _, tp = _params()
    x = torch.from_numpy(_x(tcfg, 1, 12))
    _, tc = _caches(tcfg, 1, 8, (jnp.float32, torch.float32))
    TA.mla_forward(tp, tcfg, x[:, :8], 0, cache=tc)
    before = {n: t.clone() for n, t in tc.items()}
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        TA.mla_forward(tp, tcfg, x[:, 4:7], 4, cache=tc)
    with pytest.raises(ValueError, match="overflows the cache's 8 slots"):
        TA.mla_forward(tp, tcfg, x[:, 8:9], 8, cache=tc)
    for n, t in tc.items():
        assert torch.equal(t, before[n]), n


# ---------------------------------------------------------------------------
# the step rules of an MLA stack (models/transformer.py)
# ---------------------------------------------------------------------------

def _model():
    """The port's deepseek-v2 smoke model (a dense prefix layer and two
    MoE layers) with its own f32 params from seed 0."""
    tm = Model(get_config(ARCH).smoke())
    return tm, tm.init(0, device="cpu").float()


def _toks(cfg, S, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (1, S)).astype(np.int32))


def _cache_tensors(cache):
    out = {(k, n): t.clone() for k in cache if k.startswith("prefix")
           for n, t in cache[k]["kv"].items()}
    out.update({(key, n): t.clone() for key, blk in cache["blocks"].items()
                for n, t in blk["kv"].items()})
    return out


def test_an_mla_cache_holds_the_reference_layout():
    """``init_lm_cache``: the dense prefix layer and each stacked MoE
    layer hold bf16 ``ckv`` (B, cap, r) and ``k_rope`` (B, cap, rope) and
    ``pos`` -1, as the reference's ``init_layer_cache``."""
    tm, _ = _model()
    m = tm.cfg.mla
    cache = tm.init_cache(2, 24, device="cpu")
    kv = cache["prefix0"]["kv"]
    assert tuple(kv["ckv"].shape) == (2, 24, m.kv_lora_rank)
    assert tuple(kv["k_rope"].shape) == (2, 24, m.qk_rope_dim)
    assert kv["ckv"].dtype == kv["k_rope"].dtype == torch.bfloat16
    assert bool((kv["pos"] == -1).all())
    blk = cache["blocks"]["pos0"]["kv"]
    assert sorted(blk) == ["ckv", "k_rope", "pos"]
    assert tuple(blk["ckv"].shape) == (tm.cfg.n_periods, 2, 24,
                                       m.kv_lora_rank)
    assert TT._capacity(cache) == 24


def test_an_mla_stack_raises_on_a_gap_and_rolls_back_exactly():
    """An attention cache rolls back (the one-step restart rule is a
    Mamba rule): a step past the filled prefix raises, a step at an
    earlier position gives the same logits as the first time."""
    tm, tp = _model()
    toks = _toks(tm.cfg, 12)
    cache = tm.init_cache(1, 24, device="cpu")
    _, cache = tm.prefill(tp, cache, {"tokens": toks[:, :10]})
    with pytest.raises(ValueError, match="gap"):
        tm.decode_step(tp, cache, toks[:, 10:11], 11)
    a, cache = tm.decode_step(tp, cache, toks[:, 10:11], 10)
    tm.decode_step(tp, cache, toks[:, 11:12], 11)
    b, cache = tm.decode_step(tp, cache, toks[:, 10:11], 10)   # roll back
    assert torch.equal(a, b)
    assert cache["filled"] == 12


def test_an_mla_stack_raises_on_a_full_cache_and_writes_nothing():
    tm, tp = _model()
    toks = _toks(tm.cfg, 9)
    cache = tm.init_cache(1, 8, device="cpu")
    _, cache = tm.prefill(tp, cache, {"tokens": toks[:, :8]})
    before = _cache_tensors(cache)
    with pytest.raises(ValueError, match="overflows the cache's 8 slots"):
        tm.decode_step(tp, cache, toks[:, 8:9], 8)
    assert cache["filled"] == 8
    after = _cache_tensors(cache)
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_an_mla_stack_refuses_a_chunked_prefill_and_writes_nothing():
    tm, tp = _model()
    toks = _toks(tm.cfg, 16)
    cache = tm.init_cache(1, 24, device="cpu")
    _, cache = tm.prefill(tp, cache, {"tokens": toks[:, :10]})
    before = _cache_tensors(cache)
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        TT.lm_forward(tp, tm.cfg, toks[:, 10:13], 10, cache=cache)
    assert cache["filled"] == 10
    after = _cache_tensors(cache)
    assert all(torch.equal(before[k], after[k]) for k in before)
