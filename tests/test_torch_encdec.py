"""The port's cross-attention and encoder-decoder stack (seamless-m4t-
medium at ``smoke()`` scale: 2 encoder and 2 decoder layers, 4 / 4 heads
x 16) against the reference's, with the reference's weights carried
across by ``params_from_numpy`` and the same numpy inputs:
``gqa_forward(kv_const=)``, a cross layer's ``layer_forward`` with the
encoder output and then over its cache, an encoder layer,
``encoder_forward`` and ``encdec_forward``, and prefill followed by
three decode steps through the step functions; then the port's rules.

Tolerances, as ``test_torch_model.py``'s: normwise,
``max|port - ref| <= tol * max|ref|``, 1e-4 in f32 per module, 2e-3
through the bf16 cache (an f32 k or v on the other side of a bf16
rounding boundary is stored one bf16 step apart).  In bf16, the port
lies no farther from the reference's bf16 result than ``BF16_REL`` (1)
times that result's own distance from the reference's f32 one.

The reference's f32 result of the whole stack cannot come from its
``encdec_forward``: its encoder scans from the frames cast to bf16, and
f32 weights promote the carry to f32, which ``lax.scan`` refuses
(``TypeError``).  So the f32 yardstick is composed from the reference's
own ``layer_forward`` / ``rmsnorm`` / ``lm_forward`` in the order its
``encoder_forward`` runs them, from the bf16-rounded frames.

The reference's prefill replaces each layer's ``xkv`` by the fresh
projection of the S_enc frames, so its decode attends over exactly
those; the port writes them into the first S_enc of ``enc_cap`` slots
and attends over ``enc_len`` = S_enc of them.  The caches here have
``enc_cap`` > S_enc, so the two must agree on the slots read and the
port's slots past S_enc stay zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as JA
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro.models.params import unzip
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention as TA
from repro_torch.models import encdec as TE
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.models.params import index_tree

ARCH = "seamless-m4t-medium"
F32_TOL, F32_CACHE_TOL, BF16_REL = 1e-4, 2e-3, 1.0
B, S, N_DECODE, CAP = 2, 24, 3, 32
S_ENC, ENC_CAP = 6, 10                  # enc_cap > S_enc: enc_len is read


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


def _close_bf16(out, ref, ref_f32, what=""):
    out, ref, ref_f32 = _np(out), _np(ref), _np(ref_f32)
    assert out.shape == ref.shape == ref_f32.shape, what
    assert np.isfinite(out).all(), what
    err, noise = np.abs(out - ref).max(), np.abs(ref - ref_f32).max()
    assert err <= BF16_REL * noise, (
        f"{what}: max err {err} > {BF16_REL} x the reference's own bf16 "
        f"noise {noise}")


def _f32(jp):
    return jax.tree.map(lambda a: a.astype(jnp.float32), jp)


_PARAMS = {}


def _reference(f32: bool):
    """(jax Model, jax params, the port's Model and params) at smoke(),
    the params cast to f32 when ``f32``."""
    if f32 not in _PARAMS:
        jm = JModel(j_get_config(ARCH).smoke())
        jp = unzip(jm.init(jax.random.PRNGKey(0)))[0]
        if f32:
            jp = _f32(jp)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _PARAMS[f32] = (jm, jp, Model(get_config(ARCH).smoke()), tp)
    return _PARAMS[f32]


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def _rng(seed):
    return np.random.default_rng(seed)


def _frames(seed=1, n=S_ENC, d=64):
    """Frames as the reference's model takes them: bf16 numbers."""
    a = _rng(seed).standard_normal((B, n, d)).astype(np.float32)
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _tokens(n=S, seed=0):
    return _rng(seed).integers(0, 256, (B, n)).astype(np.int32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_gqa_forward_kv_const_matches_reference(f32):
    """Cross-attention over given k, v at decoder positions 7..7+S-1: q
    is RoPE'd there, k is not, and nothing is masked."""
    jm, jp, tm, tp = _reference(f32)
    cfg = jm.cfg
    lp_j = _layer(jp["decoder"]["blocks"]["pos0"])["cross"]
    lp_t = index_tree(tp["decoder"]["blocks"]["pos0"], 0)["cross"]
    rng = _rng(2)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((B, S_ENC, cfg.n_kv_heads, cfg.head_dim_))
            .astype(np.float32) for _ in range(2))
    pos = jnp.arange(7, 7 + S, dtype=jnp.int32)
    kv_pos = jnp.arange(S_ENC, dtype=jnp.int32)
    jdt, tdt = (jnp.float32, torch.float32) if f32 else \
        (jnp.bfloat16, torch.bfloat16)
    fwd = jax.jit(lambda p, x, k, v: JA.gqa_forward(
        p, cfg, x, pos, kv_const=(k, v, kv_pos))[0])
    ref = fwd(lp_j, *(jnp.asarray(a, jdt) for a in (x, k, v)))
    out, none = TA.gqa_forward(lp_t, tm.cfg, _t(x, tdt), 7,
                               kv_const=(_t(k, tdt), _t(v, tdt)))
    assert none is None and out.dtype == tdt
    if f32:
        _close(out, ref, F32_TOL, "kv_const f32")
        return
    # the same bf16 numbers through the reference's f32 params
    ref32 = fwd(_f32(lp_j), *(jnp.asarray(a, jdt).astype(jnp.float32)
                             for a in (x, k, v)))
    _close_bf16(out, ref, ref32, "kv_const bf16")


@pytest.mark.parametrize("layer", ["encoder", "decoder"])
def test_layer_forward_without_a_cache_matches_reference(layer):
    """f32, no cache: an encoder layer (bidirectional self-attention) at
    positions 0..S_enc-1, and a decoder layer (causal self-attention,
    then cross-attention over the fresh projection of ``enc_out``)."""
    jm, jp, tm, tp = _reference(f32=True)
    rng = _rng(3)
    d = jm.cfg.d_model
    if layer == "encoder":
        x = rng.standard_normal((B, S_ENC, d)).astype(np.float32)
        lp_j, lp_t = (_layer(jp["encoder"]["blocks"], 1),
                      index_tree(tp["encoder"]["blocks"], 1))
        ref = jax.jit(lambda p, x: JT.layer_forward(
            p, jm.cfg, JE.ENC_SPEC, x, jnp.arange(S_ENC, dtype=jnp.int32),
            causal=False)[0])(lp_j, jnp.asarray(x))
        out = TT.layer_forward(lp_t, tm.cfg, TE.ENC_SPEC, _t(x), 0,
                               causal=False)[0]
    else:
        x = rng.standard_normal((B, S, d)).astype(np.float32)
        enc = rng.standard_normal((B, S_ENC, d)).astype(np.float32)
        spec = jm.cfg.pattern[0]
        lp_j, lp_t = (_layer(jp["decoder"]["blocks"]["pos0"], 1),
                      index_tree(tp["decoder"]["blocks"]["pos0"], 1))
        ref = jax.jit(lambda p, x, e: JT.layer_forward(
            p, jm.cfg, spec, x, jnp.arange(S, dtype=jnp.int32),
            enc_out=e)[0])(lp_j, jnp.asarray(x), jnp.asarray(enc))
        out = TT.layer_forward(lp_t, tm.cfg, spec, _t(x), 0,
                               enc_out=_t(enc))[0]
    _close(out, ref, F32_TOL, f"{layer} layer")


def test_cross_layer_with_enc_out_then_over_its_cache_matches_reference():
    """f32 params, the bf16 cache: one decoder layer's prefill of S
    tokens with ``enc_out`` (xkv written, the fresh projection attended
    over), then two decode steps reading ``xkv``; outputs and every
    cache leaf."""
    jm, jp, tm, tp = _reference(f32=True)
    cfg, spec = jm.cfg, jm.cfg.pattern[0]
    rng = _rng(4)
    x = rng.standard_normal((B, S + 2, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    lp_j = _layer(jp["decoder"]["blocks"]["pos0"])
    lp_t = index_tree(tp["decoder"]["blocks"]["pos0"], 0)
    jc = unzip(JT.init_layer_cache(cfg, spec, B, CAP, enc_cap=ENC_CAP))[0]
    tc = TT.init_layer_cache(tm.cfg, spec, B, CAP, "cpu", enc_cap=ENC_CAP)
    jstep = jax.jit(lambda p, x, pos, c, e: JT.layer_forward(
        p, cfg, spec, x, pos, c, e)[:2])
    for start, n, e in ((0, S, enc), (S, 1, None), (S + 1, 1, None)):
        xs = x[:, start:start + n]
        ref, jc = jstep(lp_j, jnp.asarray(xs),
                        jnp.arange(start, start + n, dtype=jnp.int32), jc,
                        None if e is None else jnp.asarray(e))
        out, tc, _ = TT.layer_forward(lp_t, tm.cfg, spec, _t(xs), start, tc,
                                      None if e is None else _t(e),
                                      enc_len=S_ENC)
        _close(out, ref, F32_CACHE_TOL, f"layer output at {start}")
        assert jc["xkv"]["k"].shape[1] == S_ENC      # replaced, not updated
        for name in ("k", "v"):
            _close(tc["kv"][name], jc["kv"][name], F32_CACHE_TOL,
                   f"kv {name} at {start}")
            _close(tc["xkv"][name][:, :S_ENC], jc["xkv"][name],
                   F32_CACHE_TOL, f"xkv {name} at {start}")
            assert not tc["xkv"][name][:, S_ENC:].any()
        assert np.array_equal(tc["kv"]["pos"].numpy(),
                              np.asarray(jc["kv"]["pos"]))


def _ref_encoder_f32(jm, jp32, frames):
    """The reference's f32 encoder, composed in ``encoder_forward``'s
    order (its scan cannot run in f32: module docstring)."""
    cfg = jm.cfg
    x = jnp.asarray(frames, jnp.float32)
    pos = jnp.arange(frames.shape[1], dtype=jnp.int32)
    for i in range(cfg.n_enc_layers):
        x = JT.layer_forward(_layer(jp32["encoder"]["blocks"], i), cfg,
                             JE.ENC_SPEC, x, pos, causal=False)[0]
    return JL.rmsnorm(jp32["encoder"]["final_norm"], x, cfg.rms_eps)


def test_encoder_forward_and_encdec_forward_match_reference_in_bf16():
    """bf16 params (the reference's ``encdec_forward`` runs only in bf16):
    the encoder's output and the whole stack's logits without a cache,
    each held to the reference's own bf16 distance from its f32
    composition (module docstring)."""
    jm, jp, tm, tp = _reference(f32=False)
    jp32 = _f32(jp)
    frames, toks = _frames(), _tokens()
    jframes = jnp.asarray(frames, jnp.bfloat16)
    enc = jax.jit(lambda p, f: JE.encoder_forward(p, jm.cfg, f))(
        jp["encoder"], jframes)
    enc32 = jax.jit(lambda p, f: _ref_encoder_f32(jm, p, f))(jp32, frames)
    out = TE.encoder_forward(tp["encoder"], tm.cfg, _t(frames))
    assert out.dtype == torch.bfloat16 and enc.dtype == jnp.bfloat16
    _close_bf16(out, enc, enc32, "encoder_forward")

    ref = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks),
                                   "frames": jframes})[0]
    ref32 = jax.jit(lambda p, t, e: JT.lm_forward(p, jm.cfg, t,
                                                  enc_out=e)[0])(
        jp32["decoder"], jnp.asarray(toks), enc32)
    with torch.no_grad():
        logits, none, _ = tm.forward(tp, {"tokens": _t(toks, torch.int32),
                                          "frames": _t(frames)})
    assert none is None
    assert logits.shape == (B, S, tm.cfg.padded_vocab)
    _close_bf16(logits, ref, ref32, "encdec_forward")
    direct, _, _ = TE.encdec_forward(tp, tm.cfg, _t(frames),
                                     _t(toks, torch.int32))
    assert torch.equal(direct, logits)


def _cache_leaves(cache):
    """{(key, kind, name): tensor} of a cache tree's stacks."""
    return {(key, kind, n): t for key, blk in cache["blocks"].items()
            for kind, leaves in blk.items() for n, t in leaves.items()}


def test_decoder_prefill_then_decode_matches_reference_in_f32():
    """The decoder stack in f32 over the bf16 cache, through
    ``lm_forward`` with an f32 ``enc_out``: prefill, then three decode
    steps reading ``xkv[:, :enc_len]``; logits and every cache leaf
    (2e-3: through the bf16 cache)."""
    jm, jp, tm, tp = _reference(f32=True)
    cfg = jm.cfg
    toks = _tokens(S + N_DECODE)
    enc = _rng(5).standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    jc = unzip(JT.init_lm_cache(cfg, B, CAP, enc_cap=ENC_CAP))[0]
    tc = TT.init_lm_cache(tm.cfg, B, CAP, "cpu", enc_cap=ENC_CAP)
    jstep = jax.jit(lambda p, t, pos, c, e: JT.lm_forward(
        p, cfg, t, positions=pos, cache=c, enc_out=e)[:2])
    steps = [(0, S, enc)] + [(S + j, 1, None) for j in range(N_DECODE)]
    for start, n, e in steps:
        t = toks[:, start:start + n]
        ref, jc = jstep(jp["decoder"], jnp.asarray(t),
                        jnp.arange(start, start + n, dtype=jnp.int32), jc,
                        None if e is None else jnp.asarray(e))
        with torch.no_grad():
            out, tc, _ = TT.lm_forward(tp["decoder"], tm.cfg,
                                       _t(t, torch.int32), start, cache=tc,
                                       enc_out=None if e is None else _t(e))
        _close(out, ref, F32_CACHE_TOL, f"logits at {start}")
    assert tc["filled"] == S + N_DECODE and tc["enc_len"] == S_ENC
    jl, tl = _cache_leaves(jc), _cache_leaves(tc)
    assert sorted(jl) == sorted(tl)
    for key, j in jl.items():
        t = tl[key]
        if key[1] == "xkv":
            assert j.shape[2] == S_ENC and not t[:, :, S_ENC:].any()
            t = t[:, :, :S_ENC]
        if key[2] == "pos":
            assert np.array_equal(t.numpy(), np.asarray(j))
        else:
            _close(t, j, F32_CACHE_TOL, f"cache {key}")


def _ref_serve_f32(jm, jp32, frames, toks, fed):
    """The f32 yardstick of a served run: the composed f32 encoder, then
    the reference's ``lm_forward`` over its bf16 cache, fed ``fed``."""
    cfg = jm.cfg
    enc32 = _ref_encoder_f32(jm, jp32, frames)
    cache = unzip(JT.init_lm_cache(cfg, B, CAP, enc_cap=ENC_CAP))[0]
    logits, cache, _ = JT.lm_forward(jp32["decoder"], cfg, jnp.asarray(toks),
                                     cache=cache, enc_out=enc32)
    outs = [logits]
    for j in range(N_DECODE):
        logits, cache, _ = JT.lm_forward(
            jp32["decoder"], cfg, jnp.asarray(fed[:, j:j + 1]),
            positions=jnp.full((1,), S + j, jnp.int32), cache=cache)
        outs.append(logits)
    return outs, cache


def test_prefill_then_decode_matches_reference():
    """seamless in bf16 through ``make_prefill_step`` (tokens and frames)
    and three ``make_decode_step`` steps fed the reference's greedy
    tokens: logits after every step and the whole cache (``kv``, ``pos``,
    ``xkv``) at the end, against the reference's ``Model.prefill`` /
    ``decode_step`` over a cache of ``enc_cap`` > S_enc, held to its own
    bf16 distance from the f32 yardstick."""
    jm, jp, tm, tp = _reference(f32=False)
    frames, toks = _frames(), _tokens()
    jframes = jnp.asarray(frames, jnp.bfloat16)
    jc = unzip(jm.init_cache(B, CAP, enc_cap=ENC_CAP))[0]
    logits, jc = jax.jit(jm.prefill)(jp, jc, {"tokens": jnp.asarray(toks),
                                              "frames": jframes})
    ref, fed = [logits], []
    dec = jax.jit(jm.decode_step)
    for j in range(N_DECODE):
        nxt = np.argmax(_np(ref[-1])[:, -1:], -1).astype(np.int32)
        fed.append(nxt)
        logits, jc = dec(jp, jc, jnp.asarray(nxt), jnp.int32(S + j))
        ref.append(logits)
    fed = np.concatenate(fed, 1)
    ref32, jc32 = jax.jit(lambda p, f, t, g: _ref_serve_f32(jm, p, f, t, g))(
        _f32(jp), frames, toks, fed)

    tc = tm.init_cache(B, CAP, device="cpu", enc_cap=ENC_CAP)
    prefill, decode = make_prefill_step(tm), make_decode_step(tm)
    outs = [prefill(tp, tc, {"tokens": _t(toks, torch.int32),
                             "frames": _t(frames, torch.bfloat16)})[0]]
    for j in range(N_DECODE):
        out, tc = decode(tp, tc, _t(fed[:, j:j + 1], torch.int32), S + j)
        assert out.shape == (B, 1, tm.cfg.padded_vocab)
        outs.append(out)
    assert tc["filled"] == S + N_DECODE and tc["enc_len"] == S_ENC
    for i, (o, r, r32) in enumerate(zip(outs, ref, ref32, strict=True)):
        _close_bf16(o, r, r32, f"logits of step {i}")
    jl, jl32, tl = (_cache_leaves(c) for c in (jc, jc32, tc))
    assert sorted(jl) == sorted(tl) == sorted(jl32)
    for key, j in jl.items():
        t = tl[key]
        if key[1] == "xkv":
            assert j.shape[2] == S_ENC and not t[:, :, S_ENC:].any()
            t = t[:, :, :S_ENC]
        if key[2] == "pos":
            assert np.array_equal(t.numpy(), np.asarray(j))
        else:
            _close_bf16(t, j, jl32[key], f"cache {key}")


# ---------------------------------------------------------------------------
# the port's rules
# ---------------------------------------------------------------------------

def test_init_tree_is_the_reference_tree():
    """The port's seamless tree has the reference's keys, shapes and
    dtypes: the encoder one (n_enc_layers, ...) stack, each decoder
    layer's ``cross_norm`` and ``cross`` beside its self-attention; the
    reference's weights carry across exactly."""
    jm, jp, tm, tp = _reference(f32=False)

    def leaf(tree, name):
        for k in name.split("."):
            tree = tree[k]
        return tree
    ref = sorted(".".join(k.key for k in path) for path, _ in
                 jax.tree_util.tree_leaves_with_path(jp))
    mine = tm.init(0, device="cpu")
    assert ref == sorted(n for n, _ in mine.named_parameters()) == \
        sorted(n for n, _ in tp.named_parameters())
    for n in ref:
        j, m, t = np.asarray(leaf(jp, n)), leaf(mine, n), leaf(tp, n)
        assert tuple(m.shape) == tuple(t.shape) == j.shape, n
        assert m.dtype == t.dtype, n
        assert np.array_equal(t.float().numpy(), j.astype(np.float32)), n
    assert tp["encoder"]["blocks"]["attn"]["wq"].shape[0] == \
        tm.cfg.n_enc_layers
    assert "cross" in tp["decoder"]["blocks"]["pos0"]


def test_f32_params_raise_in_both_packages():
    """The reference's encoder scan refuses f32 params (bf16 frames x f32
    weights change the carry's dtype), and the port raises the same
    ``TypeError`` before any work or write."""
    jm, jp, tm, tp = _reference(f32=True)
    frames, toks = _frames(), _tokens()
    with pytest.raises(TypeError, match="carry"):
        jm.forward(jp, {"tokens": jnp.asarray(toks),
                        "frames": jnp.asarray(frames)})
    batch = {"tokens": _t(toks, torch.int32), "frames": _t(frames)}
    with pytest.raises(TypeError, match="carry"):
        tm.forward(tp, batch)
    cache = tm.init_cache(B, CAP, device="cpu", enc_cap=ENC_CAP)
    with pytest.raises(TypeError, match="carry"):
        tm.prefill(tp, cache, batch)
    assert cache["filled"] == 0 and cache["enc_len"] == 0
    assert not any(t.any() for key, t in _cache_leaves(cache).items()
                   if key[2] != "pos")


def _snapshot(cache):
    return ({k: t.clone() for k, t in _cache_leaves(cache).items()},
            cache["filled"], cache["enc_len"])


def _unchanged(cache, snap):
    leaves, filled, enc_len = snap
    assert cache["filled"] == filled and cache["enc_len"] == enc_len
    now = _cache_leaves(cache)
    for k, t in leaves.items():
        assert torch.equal(now[k], t), k


def test_a_step_without_an_encoder_output_raises_and_writes_nothing():
    """A decode (or a prefill without frames) over a cache no frames have
    reached raises before any write: the reference would attend over
    ``enc_cap`` zero keys.  ``forward`` without frames or a cache raises,
    and so does a cross layer with neither."""
    _, _, tm, tp = _reference(f32=False)
    toks = _t(_tokens(), torch.int32)
    cache = tm.init_cache(B, CAP, device="cpu", enc_cap=ENC_CAP)
    snap = _snapshot(cache)
    with pytest.raises(ValueError, match="no encoder output"):
        tm.decode_step(tp, cache, toks[:, :1], 0)
    with pytest.raises(ValueError, match="no encoder output"):
        tm.prefill(tp, cache, {"tokens": toks})
    _unchanged(cache, snap)
    with pytest.raises(ValueError, match="frames"):
        tm.forward(tp, {"tokens": toks})
    spec = tm.cfg.pattern[0]
    with pytest.raises(ValueError, match="encoder output"):
        TT.layer_forward(index_tree(tp["decoder"]["blocks"]["pos0"], 0),
                         tm.cfg, spec, torch.zeros(B, 1, 64,
                                                   dtype=torch.bfloat16))


def test_frames_past_enc_cap_raise_and_write_nothing():
    _, _, tm, tp = _reference(f32=False)
    toks = _t(_tokens(), torch.int32)
    cache = tm.init_cache(B, CAP, device="cpu", enc_cap=ENC_CAP)
    tm.prefill(tp, cache, {"tokens": toks,
                           "frames": _t(_frames(), torch.bfloat16)})
    snap = _snapshot(cache)
    long = _t(_frames(seed=2, n=ENC_CAP + 1), torch.bfloat16)
    with pytest.raises(ValueError, match=f"overflows the cache's {ENC_CAP}"):
        tm.prefill(tp, cache, {"tokens": toks, "frames": long})
    _unchanged(cache, snap)
    # exactly enc_cap frames fit
    tm.prefill(tp, cache, {"tokens": toks, "frames": long[:, :ENC_CAP]})
    assert cache["enc_len"] == ENC_CAP


def test_a_later_prefill_with_fewer_frames_reads_only_its_own():
    """``enc_len`` follows the last frames: a prefill of 3 frames over a
    cache that held 6 leaves their slots 3..5 in place but unread, so the
    decode after it equals the same steps over a fresh cache bit for
    bit."""
    _, _, tm, tp = _reference(f32=False)
    toks = _t(_tokens(), torch.int32)
    few = _t(_frames(seed=3, n=3), torch.bfloat16)
    used = tm.init_cache(B, CAP, device="cpu", enc_cap=ENC_CAP)
    tm.prefill(tp, used, {"tokens": toks,
                          "frames": _t(_frames(), torch.bfloat16)})
    fresh = tm.init_cache(B, CAP, device="cpu", enc_cap=ENC_CAP)
    outs = []
    for cache in (used, fresh):
        a, _ = tm.prefill(tp, cache, {"tokens": toks, "frames": few})
        b, _ = tm.decode_step(tp, cache, toks[:, :1], S)
        outs.append((a, b))
        assert cache["enc_len"] == 3
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert _cache_leaves(used)["pos0", "xkv", "k"][:, :, 3:6].any()
