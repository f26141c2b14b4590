"""The port's transformer serving path against the reference's ``Model``
at ``smoke()`` scale, with the reference's weights carried across by
``params_from_numpy`` and the same numpy tokens: layers (RoPE, FFN,
softcap, GQA, one whole layer), ``Model.forward``, and ``prefill``
followed by three ``decode_step``s, for gemma2-9b (window 32, both
softcaps, post-norms, GeGLU, tied embeddings), llama3-8b, deepseek-7b,
starcoder2-3b (ungated GELU MLP, tied embeddings) and phi3.5-MoE (every
layer a MoE FFN, 4 experts top-2 at smoke scale; ``test_torch_moe.py``
holds its FFN and metrics).

Tolerances:

- f32 params (both trees cast to f32; the caches stay bf16 as in the
  reference): normwise, ``max|port - ref| <= tol * max|ref|``.  The
  arithmetic is the same and its sums run in other orders:
  ``F32_TOL`` = 1e-4 without a cache.  With one, an f32 k or v entry
  that lands on the other side of a bf16 rounding boundary is stored one
  bf16 step (2^-8 relative) apart, so the caches and the logits that
  read them are held to ``F32_CACHE_TOL`` = 2e-3 (measured up to 4.2e-4
  on the CPU).
- bf16 params (the default): against the reference's own bf16 noise.
  Both frameworks round every matmul, norm and activation output to
  bf16, at places that do not all agree (XLA's CPU GELU rounds its
  intermediates to bf16, torch's does not), and with random weights at
  smoke scale those roundings compound: the reference's bf16 logits lie
  13-32 % (normwise) from its own f32 logits on these inputs.  The port
  must lie no farther from the reference's bf16 result than that result
  lies from the reference's own f32 one:
  ``max|port - ref_bf16| <= BF16_REL * max|ref_bf16 - ref_f32|`` with
  ``BF16_REL`` = 1 (measured 0.04-0.85 over logits and caches on the
  CPU).

MoE routing (phi3.5-MoE).  A token whose k-th and (k+1)-th router
logits nearly tie routes by a coin flip of bf16 rounding: one bf16 step
of difference in the router's input picks another expert, and that row
then differs by a whole expert's output.  At smoke scale in bf16 this
happens in both frameworks (seed 0: the port flips 2 and the
reference's own bf16 run 2 of 160 (token, layer) pairs against the f32
routing, at gaps of 0.002-0.01).  So in f32 the routing must be
identical, every token and layer (``_Routes``); in bf16 a (token, layer)
is *flipped* when the port's bf16, the reference's bf16 and the
reference's f32 runs do not all pick the same expert set, at most
``FLIP_MAX`` of them may flip (a wrong router would flip most), and the
bf16 rule is held on the rows no flip reaches: a flip at (b, p, layer l)
reaches row (b, p) and, through attention, every later row of sequence
b when l is not the last layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro.models.params import unzip
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.models.params import index_tree, param_count

ARCHS = ["gemma2-9b", "llama3-8b", "deepseek-7b", "starcoder2-3b",
         "phi3.5-moe-42b-a6.6b"]
F32_TOL, F32_CACHE_TOL, BF16_REL = 1e-4, 2e-3, 1.0
FLIP_MAX = 0.05        # share of (token, layer) pairs whose routing flips
S_PROMPT, N_DECODE, CAP = 40, 3, 48     # prompt longer than gemma2's window


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


def _close_bf16(out, ref, ref_f32, what="", rows=None):
    """The bf16 rule of the module docstring, over ``rows`` (a (B, S)
    mask of the leading axes; all rows by default)."""
    out, ref, ref_f32 = _np(out), _np(ref), _np(ref_f32)
    assert out.shape == ref.shape and np.isfinite(out).all(), what
    if rows is not None:
        out, ref, ref_f32 = out[rows], ref[rows], ref_f32[rows]
    err, noise = np.abs(out - ref).max(), np.abs(ref - ref_f32).max()
    assert err <= BF16_REL * noise, (
        f"{what}: max err {err} > {BF16_REL} x the reference's own bf16 "
        f"noise {noise}")


class _Routes:
    """The top-k expert ids of every MoE layer call, in call order: the
    reference's through a ``jax.debug.callback`` (which fires inside jit
    and scan), the port's from its ``route``."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        j_route, t_route = JMOE.route, TMOE.route

        def jr(*a, **k):
            out = j_route(*a, **k)
            jax.debug.callback(lambda i: self.ref.append(np.asarray(i)),
                               out[1], ordered=True)
            return out

        def tr(*a, **k):
            out = t_route(*a, **k)
            self.port.append(out[1].numpy().copy())
            return out
        monkeypatch.setattr(JMOE, "route", jr)
        monkeypatch.setattr(TMOE, "route", tr)

    def done(self):
        jax.effects_barrier()       # every callback has fired

    @staticmethod
    def flips(base, *runs):
        """Per call, a (T,) mask: some run's expert set at that token
        differs from ``base``'s."""
        sets = lambda r: [np.sort(np.asarray(i), axis=-1) for i in r]
        out = [np.zeros(len(b), bool) for b in base]
        for run in runs:
            for f, a, b in zip(out, sets(run), sets(base), strict=True):
                f |= (a != b).any(-1)
        return out


def _reached(flips, n_layers, B, P):
    """(B, P) mask of the rows a flip reaches (module docstring);
    ``flips``: (layer, (B, P) mask) pairs."""
    hit = np.zeros((B, P), bool)
    for layer, f in flips:
        hit |= f
        if layer < n_layers - 1:
            hit |= np.cumsum(f, axis=1) > 0
    return hit


def _f32(jp):
    return jax.tree.map(lambda a: a.astype(jnp.float32), jp)


def _reference(arch, f32: bool):
    """(jax Model, jax params, the port's Model and params) at smoke()."""
    jcfg = j_get_config(arch).smoke()
    jm = JModel(jcfg)
    jp = unzip(jm.init(jax.random.PRNGKey(0)))[0]
    if f32:
        jp = _f32(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, Model(get_config(arch).smoke()), tp


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 300, 4, 64)).astype(np.float32)
    pos = np.arange(5000, 5300, dtype=np.int32)
    out = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gated,act", [(True, "gelu"), (True, "silu"),
                                       (False, "gelu")])
def test_ffn_matches_reference(gated, act):
    rng = np.random.default_rng(1)
    f = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
    p = {"w_up": f(32, 96), "w_down": f(96, 32)}
    if gated:
        p["w_gate"] = f(32, 96)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    out = TL.ffn({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x), act)
    ref = JL.ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                 act)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softcap_matches_reference(dtype):
    x = np.random.default_rng(2).standard_normal((4, 50)).astype(
        np.float32) * 60
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    out = TL.softcap(torch.from_numpy(x).to(dtype), 30.0)
    ref = JL.softcap(jnp.asarray(x, jdt), 30.0)
    assert out.dtype == dtype
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-6, atol=1e-5)
    assert torch.equal(TL.softcap(torch.from_numpy(x), 0.0),
                       torch.from_numpy(x))


@pytest.mark.parametrize("arch", ["gemma2-9b", "llama3-8b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_gqa_forward_prefill_and_decode_match_reference(arch):
    """One attention layer with a cache: a 40-token prefill, then a
    decode at 40 (gemma2's local layer: window 32)."""
    jm, jp, tm, tp = _reference(arch, f32=True)
    spec = jm.cfg.pattern[0]
    lp_j = jax.tree.map(lambda a: a[0], jp["blocks"]["pos0"])["attn"]
    lp_t = index_tree(tp["blocks"]["pos0"], 0)["attn"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, S_PROMPT + 1, jm.cfg.d_model)).astype(
        np.float32)
    jc = jax.tree.map(lambda a: a[0], unzip(
        JT.init_lm_cache(jm.cfg, 2, CAP))[0]["blocks"]["pos0"])["kv"]
    tc = index_tree(TT.init_lm_cache(tm.cfg, 2, CAP, "cpu")["blocks"]["pos0"],
                    0)["kv"]
    jgqa = jax.jit(lambda p, x, pos, c: JA.gqa_forward(
        p, jm.cfg, x, pos, window=spec.window, cache=c))
    for start, S in ((0, S_PROMPT), (S_PROMPT, 1)):
        xs = x[:, start:start + S]
        pos = jnp.arange(start, start + S, dtype=jnp.int32)
        ref, jc = jgqa(lp_j, jnp.asarray(xs), pos, jc)
        out, tc = TA.gqa_forward(lp_t, tm.cfg, torch.from_numpy(xs), start,
                                 window=spec.window, cache=tc)
        _close(out, ref, F32_CACHE_TOL, f"{arch} gqa start {start}")
        for name in ("k", "v"):
            _close(tc[name], jc[name], F32_CACHE_TOL, f"{arch} cache {name}")
        assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("arch", ["gemma2-9b", "starcoder2-3b"])
def test_layer_forward_matches_reference(arch):
    jm, jp, tm, tp = _reference(arch, f32=True)
    x = np.random.default_rng(4).standard_normal(
        (2, 24, jm.cfg.d_model)).astype(np.float32)
    for pos, spec in enumerate(jm.cfg.pattern):
        lp_j = jax.tree.map(lambda a: a[1], jp["blocks"][f"pos{pos}"])
        lp_t = index_tree(tp["blocks"][f"pos{pos}"], 1)
        ref, _, _ = jax.jit(lambda p, x: JT.layer_forward(
            p, jm.cfg, spec, x, jnp.arange(24, dtype=jnp.int32)))(
                lp_j, jnp.asarray(x))
        out, _, _ = TT.layer_forward(lp_t, tm.cfg, spec, torch.from_numpy(x),
                                     0)
        _close(out, ref, F32_TOL, f"{arch} layer pos{pos}")


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, f32, monkeypatch):
    jm, jp, tm, tp = _reference(arch, f32)
    routes = _Routes(monkeypatch)
    toks = {"tokens": jnp.asarray(_tokens(jm.cfg, 2, S_PROMPT))}
    fwd = jax.jit(jm.forward)
    ref, _, jmet = fwd(jp, toks)
    with torch.no_grad():
        out, _, tmet = tm.forward(tp, {"tokens": torch.from_numpy(
            np.array(toks["tokens"]))})
    assert out.shape == (2, S_PROMPT, tm.cfg.padded_vocab)
    assert sorted(tmet) == sorted(jmet)
    routes.done()
    if f32:
        _close(out, ref, F32_TOL, f"{arch} forward")
        for r, t in zip(routes.ref, routes.port, strict=True):
            assert np.array_equal(t, np.asarray(r)), f"{arch} routing"
        if "expert_counts" in jmet:
            assert np.array_equal(tmet["expert_counts"].numpy(),
                                  np.asarray(jmet["expert_counts"]))
        return
    ref32 = fwd(_f32(jp), toks)[0]
    routes.done()
    rows = None
    if tm.cfg.moe is not None:
        L = len(routes.port)
        flips = _Routes.flips(routes.ref[L:], routes.ref[:L], routes.port)
        assert np.mean(flips) <= FLIP_MAX, f"{arch}: routing flips {flips}"
        rows = ~_reached([(l, f.reshape(2, S_PROMPT))
                          for l, f in enumerate(flips)], L, 2, S_PROMPT)
    _close_bf16(out, ref, ref32, f"{arch} forward", rows)


def _ref_serve(jm, jp, toks, greedy=None):
    """The reference's prefill and N_DECODE decode steps: the logits of
    each and the final cache, as numpy.  The decode tokens are ``greedy``
    (B, N_DECODE) or the run's own argmax."""
    cache = unzip(jm.init_cache(2, CAP))[0]
    logits, cache = jax.jit(jm.prefill)(jp, cache,
                                        {"tokens": jnp.asarray(toks)})
    outs, fed = [_np(logits)], []
    dec = jax.jit(jm.decode_step)
    for step in range(N_DECODE):
        nxt = (greedy[:, step:step + 1] if greedy is not None else
               np.argmax(outs[-1][:, -1:], axis=-1).astype(np.int32))
        fed.append(nxt)
        logits, cache = dec(jp, cache, jnp.asarray(nxt),
                            jnp.int32(S_PROMPT + step))
        outs.append(_np(logits))
    return outs, jax.tree.map(np.asarray, cache), np.concatenate(fed, 1)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch, f32, monkeypatch):
    """prefill(40 tokens) and three greedy decode steps through the step
    functions, fed the reference's tokens; logits after every step and the
    whole cache at the end."""
    jm, jp, tm, tp = _reference(arch, f32)
    routes = _Routes(monkeypatch)
    toks = _tokens(jm.cfg, 2, S_PROMPT)
    ref, jc, fed = _ref_serve(jm, jp, toks)
    if not f32:
        ref32, jc32, _ = _ref_serve(jm, _f32(jp), toks, greedy=fed)
    tc = tm.init_cache(2, CAP, device="cpu")
    prefill, decode = make_prefill_step(tm), make_decode_step(tm)
    outs = [prefill(tp, tc, {"tokens": torch.from_numpy(toks)})[0]]
    for step in range(N_DECODE):
        out, tc = decode(tp, tc, torch.from_numpy(fed[:, step:step + 1]),
                         S_PROMPT + step)
        assert out.shape == (2, 1, tm.cfg.padded_vocab)
        outs.append(out)
    assert tc["filled"] == S_PROMPT + N_DECODE
    pairs = [(f"logits of step {i}", outs[i], ref[i], i)
             for i in range(N_DECODE + 1)]
    for key, jblk in jc["blocks"].items():
        tblk = tc["blocks"][key]["kv"]
        assert np.array_equal(tblk["pos"].numpy(), jblk["kv"]["pos"])
        pairs += [(f"cache {key} {n}", tblk[n], jblk["kv"][n], (key, n))
                  for n in ("k", "v")]
    reached = None
    routes.done()
    if tm.cfg.moe is not None:
        L = len(routes.port) // (N_DECODE + 1)
        if f32:
            for r, t in zip(routes.ref, routes.port, strict=True):
                assert np.array_equal(t, np.asarray(r)), f"{arch} routing"
        else:
            n = len(routes.port)
            flips = _Routes.flips(routes.ref[n:], routes.ref[:n],
                                  routes.port)
            assert np.concatenate(flips).mean() <= FLIP_MAX, flips
            # prefill calls hold (B * S) tokens, decode calls B
            P = S_PROMPT + N_DECODE
            per_layer = []
            for c, f in enumerate(flips):
                step, layer = divmod(c, L)
                m = np.zeros((2, P), bool)
                if step == 0:
                    m[:, :S_PROMPT] = f.reshape(2, S_PROMPT)
                else:
                    m[:, S_PROMPT + step - 1] = f
                per_layer.append((layer, m))
            reached = _reached(per_layer, L, 2, P)
    for what, out, r, tag in pairs:
        if f32:
            _close(out, r, F32_CACHE_TOL, f"{arch} {what}")
        else:
            r32 = (ref32[tag] if isinstance(tag, int)
                   else jc32["blocks"][tag[0]]["kv"][tag[1]])
            rows = None
            if reached is not None and isinstance(tag, int):
                # step 0 is the prompt's rows, step i the token at 39 + i
                rows = ~(reached[:, :S_PROMPT] if tag == 0 else
                         reached[:, S_PROMPT + tag - 1:S_PROMPT + tag])
            elif reached is not None:
                # a stacked cache (n_periods, B, CAP, ...): layer l's slot
                # p is reached by a flip at an earlier layer at p' <= p
                period = len(tm.cfg.pattern)
                pos = int(tag[0][3:])
                rows = np.stack([~np.pad(np.cumsum(sum(
                    (m for layer, m in per_layer
                     if layer < i * period + pos), np.zeros((2, P))),
                    axis=1) > 0,
                    ((0, 0), (0, CAP - P)))
                    for i in range(tm.cfg.n_periods)])
            _close_bf16(out, r, r32, f"{arch} {what}", rows)


def test_decode_step_raises_on_a_gap_and_rolls_back_exactly():
    _, _, tm, tp = _reference("llama3-8b", f32=True)
    toks = torch.from_numpy(_tokens(tm.cfg, 1, 12))
    cache = tm.init_cache(1, 24, device="cpu")
    _, cache = tm.prefill(tp, cache, {"tokens": toks[:, :10]})
    with pytest.raises(ValueError, match="gap"):
        tm.decode_step(tp, cache, toks[:, 10:11], 11)
    a, cache = tm.decode_step(tp, cache, toks[:, 10:11], 10)
    tm.decode_step(tp, cache, toks[:, 11:12], 11)
    b, cache = tm.decode_step(tp, cache, toks[:, 10:11], 10)   # roll back
    assert torch.equal(a, b)
    assert cache["filled"] == 12


def test_decode_step_raises_on_a_full_cache_and_writes_nothing():
    """A step past the cache's capacity raises before any write (the
    reference's dynamic_update_slice clamps it silently onto the last
    slot, models/attention.py:230-235)."""
    _, _, tm, tp = _reference("llama3-8b", f32=True)
    toks = torch.from_numpy(_tokens(tm.cfg, 1, 9))
    cache = tm.init_cache(1, 8, device="cpu")
    _, cache = tm.prefill(tp, cache, {"tokens": toks[:, :8]})
    before = {key: {n: t.clone() for n, t in blk["kv"].items()}
              for key, blk in cache["blocks"].items()}
    with pytest.raises(ValueError, match="overflows the cache's 8 slots"):
        tm.decode_step(tp, cache, toks[:, 8:9], 8)
    assert cache["filled"] == 8
    for key, blk in cache["blocks"].items():
        for n in ("k", "v", "pos"):
            assert torch.equal(blk["kv"][n], before[key][n]), (key, n)


def test_unported_branches_raise():
    for arch in ("mamba2-1.3b", "jamba-v0.1-52b", "deepseek-v2-236b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Model(get_config(arch).smoke()).init(0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(get_config("seamless-m4t-medium").smoke())
    pix = Model(get_config("pixtral-12b").smoke())
    pp = pix.init(0, device="cpu")
    media = torch.zeros((1, 8, pix.cfg.d_model), dtype=torch.bfloat16)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="media_embeds"):
        pix.forward(pp, {"tokens": toks, "media": media})
    with pytest.raises(NotImplementedError, match="training|loss"):
        pix.loss(pp, {"tokens": toks, "labels": toks})
    cache = pix.init_cache(1, 16, device="cpu")
    pix.prefill(pp, cache, {"tokens": toks})
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        TT.lm_forward(pp, pix.cfg, toks, 4, cache=cache)


# tests/test_arch_smoke.py:84-95
EXPECTED_PARAMS = {"gemma2-9b": (9e9, 0.25), "deepseek-7b": (7e9, 0.25),
                   "llama3-8b": (8e9, 0.25), "starcoder2-3b": (3e9, 0.35),
                   "phi3.5-moe-42b-a6.6b": (42e9, 0.25)}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_count(arch):
    """Counted from shapes on the meta device, nothing allocated; equal to
    the reference's abstract count."""
    n = param_count(Model(get_config(arch)).init(device="meta"))
    jparams = unzip(JModel(j_get_config(arch)).init(None, abstract=True))[0]
    assert n == sum(int(np.prod(l.shape)) for l in jax.tree.leaves(jparams))
    target, tol = EXPECTED_PARAMS[arch]
    assert abs(n - target) / target < tol, f"{arch}: {n / 1e9:.2f}B"
