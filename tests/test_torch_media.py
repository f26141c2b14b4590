"""The port's VLM stub frontend (``media_embeds``, pixtral-12b at
``smoke()`` scale: 2 layers, d_model 64, 4 / 4 heads x 16, 8 media
positions) against the reference's, with the reference's weights carried
across by ``params_from_numpy`` and the same numpy media and tokens:
``lm_forward`` with media, ``Model.forward``, and a prefill with media
followed by three decode steps through the step functions, every cache
leaf included; then the step rules over the media's slots.

The media are drawn as bf16 values (the reference's input spec is bf16,
``configs/shapes.py``) and given to both packages as such; each casts
them to its embeddings' dtype and puts them before the tokens, so a
prefill covers S_MEDIA + S_TEXT positions and its first decode step is
at that position.

Tolerances, as ``test_torch_model.py``'s: normwise,
``max|port - ref| <= tol * max|ref|``, 1e-4 in f32 without a cache, 2e-3
through the bf16 cache (an f32 k or v on the other side of a bf16
rounding boundary is stored one bf16 step apart).  In bf16 the port lies
no farther from the reference's bf16 result than ``BF16_REL`` (1) times
that result's own distance from the reference's f32 one.  That rule
holds the prefill's logits (B, S, V) as one tensor, and so it holds the
decode's (B, N_DECODE, V), the three steps' logits together: one step's
two rows are too few to measure the reference's own noise by (at seed 0
the reference's bf16 logits of the first step lie only 1.7 % of their
max from its f32 ones, and the port's one or two bf16 steps of other
rounding, 2.2 %, exceed that, as they do at 3 of 24 single steps over
seeds 0-5, with media or with as many text tokens instead).  In f32
every step is held on its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro.models.params import unzip
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model, params_from_numpy

ARCH = "pixtral-12b"
F32_TOL, F32_CACHE_TOL, BF16_REL = 1e-4, 2e-3, 1.0
B, S_TEXT, N_DECODE, CAP = 2, 24, 3, 40


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


def _reference(f32: bool):
    """(jax Model, jax params, the port's Model and params) at smoke()."""
    jm = JModel(j_get_config(ARCH).smoke())
    jp = unzip(jm.init(jax.random.PRNGKey(0)))[0]
    if f32:
        jp = _f32(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, Model(get_config(ARCH).smoke()), tp


def _inputs(cfg, seed=0):
    """(media as bf16 values in f32, tokens) for B sequences."""
    rng = np.random.default_rng(seed)
    media = rng.standard_normal(
        (B, cfg.num_media_tokens, cfg.d_model)).astype(np.float32)
    media = np.asarray(jnp.asarray(media, jnp.bfloat16), np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S_TEXT)).astype(np.int32)
    return media, toks


def _jbatch(media, toks):
    return {"tokens": jnp.asarray(toks),
            "media": jnp.asarray(media, jnp.bfloat16)}


def _tbatch(media, toks):
    return {"tokens": torch.from_numpy(toks),
            "media": torch.from_numpy(media).to(torch.bfloat16)}


def test_smoke_config_keeps_the_media_positions():
    cfg = get_config(ARCH).smoke()
    assert cfg.num_media_tokens == 8
    assert cfg.num_media_tokens == j_get_config(ARCH).smoke().num_media_tokens
    assert get_config(ARCH).num_media_tokens == 1024


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_lm_forward_with_media_matches_reference(f32):
    """The whole stack without a cache: media rows first, then the text
    rows, every position's logits."""
    jm, jp, tm, tp = _reference(f32)
    media, toks = _inputs(tm.cfg)
    fwd = jax.jit(lambda p, t, m: JT.lm_forward(p, jm.cfg, t,
                                                media_embeds=m)[0])
    jb = _jbatch(media, toks)
    ref = fwd(jp, jb["tokens"], jb["media"])
    tb = _tbatch(media, toks)
    with torch.no_grad():
        out, cache, _ = TT.lm_forward(tp, tm.cfg, tb["tokens"],
                                      media_embeds=tb["media"])
    assert cache is None
    assert out.shape == (B, tm.cfg.num_media_tokens + S_TEXT,
                         tm.cfg.padded_vocab)
    if f32:
        _close(out, ref, F32_TOL, "lm_forward with media")
        return
    ref32 = fwd(_f32(jp), jb["tokens"], jb["media"])
    _close_bf16(out, ref, ref32, "lm_forward with media")


def test_model_forward_with_media_matches_reference():
    """``Model.forward`` with media and no cache, f32: logits of
    S_media + S_text rows equal to the reference's ``Model.forward``, and
    the media change them (they are read, not dropped)."""
    jm, jp, tm, tp = _reference(f32=True)
    media, toks = _inputs(tm.cfg)
    ref, _, jmet = jax.jit(jm.forward)(jp, _jbatch(media, toks))
    with torch.no_grad():
        out, _, tmet = tm.forward(tp, _tbatch(media, toks))
        other = tm.forward(tp, _tbatch(np.zeros_like(media), toks))[0]
    assert out.shape[1] == tm.cfg.num_media_tokens + S_TEXT
    assert sorted(tmet) == sorted(jmet)
    _close(out, ref, F32_TOL, "Model.forward with media")
    text = slice(tm.cfg.num_media_tokens, None)
    assert not torch.allclose(out[:, text], other[:, text])


def _ref_serve(jm, jp, media, toks, greedy=None):
    """The reference's prefill with media and N_DECODE decode steps from
    position S_media + S_text: the logits of each and the final cache,
    as numpy, and the tokens fed (``greedy`` or the run's own argmax)."""
    P = media.shape[1] + toks.shape[1]
    cache = unzip(jm.init_cache(B, CAP))[0]
    logits, cache = jax.jit(jm.prefill)(jp, cache, _jbatch(media, toks))
    outs, fed = [_np(logits)], []
    dec = jax.jit(jm.decode_step)
    for step in range(N_DECODE):
        nxt = (greedy[:, step:step + 1] if greedy is not None else
               np.argmax(outs[-1][:, -1:], axis=-1).astype(np.int32))
        fed.append(nxt)
        logits, cache = dec(jp, cache, jnp.asarray(nxt), jnp.int32(P + step))
        outs.append(_np(logits))
    return outs, jax.tree.map(np.asarray, cache), np.concatenate(fed, 1)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_prefill_with_media_then_decode_matches_reference(f32):
    """A prefill of 8 media + 24 text positions and three greedy decode
    steps at positions 32, 33, 34 through the step functions, fed the
    reference's tokens: the logits after every step (the prefill's media
    rows included) and every cache leaf at the end, the media's slots
    among them."""
    jm, jp, tm, tp = _reference(f32)
    media, toks = _inputs(tm.cfg)
    P = tm.cfg.num_media_tokens + S_TEXT
    ref, jc, fed = _ref_serve(jm, jp, media, toks)
    if not f32:
        ref32, jc32, _ = _ref_serve(jm, _f32(jp), media, toks, greedy=fed)
    tc = tm.init_cache(B, CAP, device="cpu")
    prefill, decode = make_prefill_step(tm), make_decode_step(tm)
    outs = [prefill(tp, tc, _tbatch(media, toks))[0]]
    assert outs[0].shape == (B, P, tm.cfg.padded_vocab)
    assert tc["filled"] == P
    for step in range(N_DECODE):
        out, tc = decode(tp, tc, torch.from_numpy(fed[:, step:step + 1]),
                         P + step)
        outs.append(out)
    assert tc["filled"] == P + N_DECODE
    if f32:
        pairs = [(f"logits of step {i}", outs[i], ref[i], None)
                 for i in range(N_DECODE + 1)]
    else:
        cat = lambda steps: np.concatenate([_np(a) for a in steps], 1)
        pairs = [("logits of the prefill", outs[0], ref[0], ref32[0]),
                 ("logits of the decode steps", cat(outs[1:]), cat(ref[1:]),
                  cat(ref32[1:]))]
    assert sorted(tc["blocks"]) == sorted(jc["blocks"])
    for key, jblk in jc["blocks"].items():
        tkv, jkv = tc["blocks"][key]["kv"], jblk["kv"]
        assert sorted(tkv) == sorted(jkv) == ["k", "pos", "v"]
        assert np.array_equal(tkv["pos"].numpy(), jkv["pos"])
        assert (tkv["pos"].numpy()[..., :P + N_DECODE] >= 0).all()
        pairs += [(f"cache {key} {n}", tkv[n], jkv[n],
                   jc32["blocks"][key]["kv"][n] if not f32 else None)
                  for n in ("k", "v")]
    for what, out, r, r32 in pairs:
        if f32:
            _close(out, r, F32_CACHE_TOL, what)
        else:
            _close_bf16(out, r, r32, what)


def test_filled_counts_the_media_and_a_step_past_it_raises():
    """A prefill with media fills S_media + S_text slots; a decode step
    past them raises (a gap) and one at them serves; a prefill whose
    media and tokens overflow the cache raises before any write."""
    _, _, tm, tp = _reference(f32=True)
    media, toks = _inputs(tm.cfg)
    P = tm.cfg.num_media_tokens + S_TEXT
    cache = tm.init_cache(B, CAP, device="cpu")
    _, cache = tm.prefill(tp, cache, _tbatch(media, toks))
    assert cache["filled"] == P
    nxt = torch.from_numpy(toks[:, :1])
    with pytest.raises(ValueError, match="gap"):
        tm.decode_step(tp, cache, nxt, P + 1)
    _, cache = tm.decode_step(tp, cache, nxt, P)
    assert cache["filled"] == P + 1

    small = tm.init_cache(B, P - 1, device="cpu")
    before = {key: {n: t.clone() for n, t in blk["kv"].items()}
              for key, blk in small["blocks"].items()}
    with pytest.raises(ValueError, match=f"overflows the cache's {P - 1}"):
        tm.prefill(tp, small, _tbatch(media, toks))
    assert small["filled"] == 0
    for key, blk in small["blocks"].items():
        for n, t in blk["kv"].items():
            assert torch.equal(t, before[key][n]), (key, n)
