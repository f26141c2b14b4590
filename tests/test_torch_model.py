"""The port's transformer serving path against the reference's ``Model``
at ``smoke()`` scale, with the reference's weights carried across by
``params_from_numpy`` and the same numpy tokens: layers (RoPE, FFN,
softcap, GQA, one whole layer), ``Model.forward``, and ``prefill``
followed by three ``decode_step``s, for gemma2-9b (window 32, both
softcaps, post-norms, GeGLU, tied embeddings), llama3-8b, deepseek-7b,
starcoder2-3b (ungated GELU MLP, tied embeddings), phi3.5-MoE (every
layer a MoE FFN, 4 experts top-2 at smoke scale; ``test_torch_moe.py``
holds its FFN and metrics), deepseek-v2 (MLA attention in every layer,
a dense prefix layer, then MoE layers with a shared expert;
``test_torch_mla.py`` holds its attention and its step rules),
mamba2-1.3b (Mamba2 layers alone, no FFN)
and jamba (a period of 8: attention at position 2, Mamba elsewhere, a
MoE FFN on the odd positions and a dense one on the even); then the
step rules of a cache with Mamba layers (``models/transformer.py``).

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
- Mamba stacks.  In f32, jamba's 16 layers re-read 14 bf16 conv states
  and 2 bf16 kv caches at every decode step, and a last-bit difference
  that lands a stored value on the other side of a bf16 rounding
  boundary moves it by one bf16 step, up to 2^-7 of the tensor's max
  (measured 2.1e-3 on a k cache and 4.7e-3 on a conv state, past
  ``F32_CACHE_TOL``); so jamba's f32 case stores its caches in f32, in
  both frameworks (``F32_CACHED``), and is held at ``F32_TOL``.  In
  bf16 the two frameworks round in other places (one bf16 step apart on
  a layer's output, which at a decode step of two rows is more than the
  reference's own bf16-vs-f32 distance), and jamba is chaotic besides:
  the reference's own bf16 routing parts from its f32 routing at 6-8 %
  of (token, layer) pairs, the port's at 8-9 %.  So a Mamba stack's bf16
  result is held against the f32 truth instead:
  ``max|port - ref_f32| <= BF16_F32_REL * max|ref_bf16 - ref_f32|``, 2
  for mamba2 (two bf16 roundings of one function; measured 0.65-1.5)
  and 3 for jamba (measured 0.70-2.42, the largest on the last Mamba
  layer's state), and jamba's routing parts from the f32 routing at no
  more than twice the reference's own share.

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
reaches row (b, p) and, through attention or a Mamba state, every later
row of sequence b when l is not the last layer (jamba's MoE calls sit on
its odd layers: ``_moe_layers`` maps a call to its layer).
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
         "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b", "mamba2-1.3b",
         "jamba-v0.1-52b"]
MAMBA_ARCHS = ["mamba2-1.3b", "jamba-v0.1-52b"]
F32_TOL, F32_CACHE_TOL, BF16_REL = 1e-4, 2e-3, 1.0
FLIP_MAX = 0.05        # share of (token, layer) pairs whose routing flips
# Mamba stacks in bf16: held against the reference's f32 result (module
# docstring), at this factor of the reference's own bf16 distance from it
BF16_F32_REL = {"mamba2-1.3b": 2.0, "jamba-v0.1-52b": 3.0}
F32_CACHED = {"jamba-v0.1-52b"}         # f32 case run with an f32 cache
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


def _close_to_f32(arch, out, ref, ref_f32, what=""):
    """The bf16 rule of a Mamba stack (module docstring): the port's bf16
    result lies no farther from the reference's f32 one than
    ``BF16_F32_REL[arch]`` times the reference's own bf16 result."""
    out, ref, ref_f32 = _np(out), _np(ref), _np(ref_f32)
    assert out.shape == ref.shape and np.isfinite(out).all(), what
    err, noise = np.abs(out - ref_f32).max(), np.abs(ref - ref_f32).max()
    rel = BF16_F32_REL[arch]
    assert err <= rel * noise, (
        f"{what}: max |port - reference f32| {err} > {rel} x the "
        f"reference's own bf16 distance {noise}")


def _hold_flips_to_f32(ref32, ref, port, what=""):
    """The port's bf16 routing parts from the reference's f32 routing at
    no more than twice the share of (token, layer) pairs at which the
    reference's own bf16 routing does."""
    own = np.concatenate(_Routes.flips(ref32, ref)).mean()
    got = np.concatenate(_Routes.flips(ref32, port)).mean()
    assert got <= 2 * own, (
        f"{what}: the port's bf16 routing parts from the f32 one at {got} "
        f"of (token, layer) pairs, the reference's own bf16 at {own}")


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


def _layer(cfg, period: int, pos: int) -> int:
    """The transformer layer of pattern position ``pos`` in ``period``."""
    return cfg.first_k_dense + period * len(cfg.pattern) + pos


def _moe_layers(cfg):
    """The transformer layer of each MoE layer call of one step, in call
    order."""
    return [_layer(cfg, i, pos) for i in range(cfg.n_periods)
            for pos, spec in enumerate(cfg.pattern) if spec.ffn == "moe"]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "jamba-v0.1-52b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_moe_layers_names_the_layer_of_each_moe_call(arch, monkeypatch):
    """``_moe_layers`` against the port's own walk of the stack: the
    transformer layer of each MoE call, past deepseek-v2's dense prefix
    layer and between jamba's dense ones."""
    tm = Model(get_config(arch).smoke())
    tp = tm.init(0, device="cpu")
    kinds, real = [], TT.layer_forward

    def tap(p, cfg, spec, *a, **kw):
        kinds.append("w_router" in p.get("ffn", {}))
        return real(p, cfg, spec, *a, **kw)
    monkeypatch.setattr(TT, "layer_forward", tap)
    with torch.no_grad():
        tm.forward(tp, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    assert len(kinds) == tm.cfg.n_layers
    assert _moe_layers(tm.cfg) == [i for i, moe in enumerate(kinds) if moe]
    assert all(_layer(tm.cfg, i, pos) < tm.cfg.n_layers
               for i in range(tm.cfg.n_periods)
               for pos in range(len(tm.cfg.pattern)))


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
    if arch in BF16_F32_REL:
        if tm.cfg.moe is not None:
            L = len(routes.port)
            _hold_flips_to_f32(routes.ref[L:], routes.ref[:L], routes.port,
                               arch)
        _close_to_f32(arch, out, ref, ref32, f"{arch} forward")
        return
    if tm.cfg.moe is not None:
        L = len(routes.port)
        flips = _Routes.flips(routes.ref[L:], routes.ref[:L], routes.port)
        assert np.mean(flips) <= FLIP_MAX, f"{arch}: routing flips {flips}"
        rows = ~_reached([(l, f.reshape(2, S_PROMPT)) for l, f in
                          zip(_moe_layers(tm.cfg), flips, strict=True)],
                         tm.cfg.n_layers, 2, S_PROMPT)
    _close_bf16(out, ref, ref32, f"{arch} forward", rows)


def _f32_cache(cache):
    """A cache tree with its bf16 leaves in f32 (the reference's or the
    port's)."""
    if isinstance(cache, dict):
        return {k: _f32_cache(v) for k, v in cache.items()}
    if isinstance(cache, torch.Tensor):
        return cache.float() if cache.dtype == torch.bfloat16 else cache
    if hasattr(cache, "dtype") and cache.dtype == jnp.bfloat16:
        return cache.astype(jnp.float32)
    return cache


def _ref_serve(jm, jp, toks, greedy=None, f32_cache=False):
    """The reference's prefill and N_DECODE decode steps: the logits of
    each and the final cache, as numpy.  The decode tokens are ``greedy``
    (B, N_DECODE) or the run's own argmax."""
    cache = unzip(jm.init_cache(2, CAP))[0]
    if f32_cache:
        cache = _f32_cache(cache)
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
    f32_cache = f32 and arch in F32_CACHED
    ref, jc, fed = _ref_serve(jm, jp, toks, f32_cache=f32_cache)
    if not f32:
        ref32, jc32, _ = _ref_serve(jm, _f32(jp), toks, greedy=fed)
    tc = tm.init_cache(2, CAP, device="cpu")
    if f32_cache:
        tc = _f32_cache(tc)
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
    # the dense prefix layers' caches (deepseek-v2), then the stacks'
    layers = [(k, jc[k], tc[k]) for k in jc if k.startswith("prefix")]
    layers += [(k, jblk, tc["blocks"][k]) for k, jblk in jc["blocks"].items()]
    assert layers
    for key, jblk, tblk in layers:
        kind = "kv" if "kv" in jblk else "mamba"
        jblk, tblk = jblk[kind], tblk[kind]
        assert sorted(tblk) == sorted(jblk), key
        if kind == "kv":
            assert np.array_equal(tblk["pos"].numpy(), jblk["pos"])
        pairs += [(f"cache {key} {n}", tblk[n], jblk[n], (key, kind, n))
                  for n in sorted(tblk) if n != "pos"]
    reached = None
    routes.done()
    if tm.cfg.moe is not None:
        moe_layers = _moe_layers(tm.cfg)
        L = len(moe_layers)
        assert len(routes.port) == L * (N_DECODE + 1)
        if f32:
            for r, t in zip(routes.ref, routes.port, strict=True):
                assert np.array_equal(t, np.asarray(r)), f"{arch} routing"
        elif arch in BF16_F32_REL:
            n = len(routes.port)
            _hold_flips_to_f32(routes.ref[n:], routes.ref[:n], routes.port,
                               arch)
        else:
            n = len(routes.port)
            flips = _Routes.flips(routes.ref[n:], routes.ref[:n],
                                  routes.port)
            assert np.concatenate(flips).mean() <= FLIP_MAX, flips
            # prefill calls hold (B * S) tokens, decode calls B
            P = S_PROMPT + N_DECODE
            per_layer = []
            for c, f in enumerate(flips):
                step, call = divmod(c, L)
                m = np.zeros((2, P), bool)
                if step == 0:
                    m[:, :S_PROMPT] = f.reshape(2, S_PROMPT)
                else:
                    m[:, S_PROMPT + step - 1] = f
                per_layer.append((moe_layers[call], m))
            reached = _reached(per_layer, tm.cfg.n_layers, 2, P)
    for what, out, r, tag in pairs:
        if f32:
            _close(out, r, F32_TOL if f32_cache else F32_CACHE_TOL,
                   f"{arch} {what}")
        else:
            r32 = (ref32[tag] if isinstance(tag, int)
                   else (jc32[tag[0]] if tag[0].startswith("prefix")
                         else jc32["blocks"][tag[0]])[tag[1]][tag[2]])
            if arch in BF16_F32_REL:
                _close_to_f32(arch, out, r, r32, f"{arch} {what}")
                continue
            rows = None
            if reached is not None and isinstance(tag, int):
                # step 0 is the prompt's rows, step i the token at 39 + i
                rows = ~(reached[:, :S_PROMPT] if tag == 0 else
                         reached[:, S_PROMPT + tag - 1:S_PROMPT + tag])
            elif reached is not None and tag[0].startswith("prefix"):
                rows = None          # a prefix layer precedes every flip
            elif reached is not None:
                # a stacked cache (n_periods, B, ...) of layers l: the
                # flips at earlier layers, (B, P)
                pos = int(tag[0][3:])
                before = [sum((m for layer, m in per_layer
                               if layer < _layer(tm.cfg, i, pos)),
                              np.zeros((2, P))) > 0
                          for i in range(tm.cfg.n_periods)]
                if tag[1] == "kv":
                    # slot p is reached by a flip at p' <= p
                    rows = np.stack([~np.pad(
                        np.cumsum(b, axis=1) > 0, ((0, 0), (0, CAP - P)))
                        for b in before])
                else:
                    # a Mamba state has taken in every position
                    rows = np.stack([~b.any(1) for b in before])
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


# ---------------------------------------------------------------------------
# the step rules of a cache with Mamba layers
# ---------------------------------------------------------------------------

def _port_model(arch):
    """The port's smoke model with its own f32 params from seed 0."""
    tm = Model(get_config(arch).smoke())
    return tm, tm.init(0, device="cpu").float()


def _cache_tensors(cache):
    return {(key, kind, n): t.clone()
            for key, blk in cache["blocks"].items()
            for kind, leaves in blk.items() for n, t in leaves.items()}


def test_a_mamba_stack_has_no_capacity_and_raises_on_a_gap():
    tm, tp = _port_model("mamba2-1.3b")
    toks = torch.from_numpy(_tokens(tm.cfg, 1, 12))
    cache = tm.init_cache(1, 4, device="cpu")       # cap is never read
    _, cache = tm.prefill(tp, cache, {"tokens": toks[:, :8]})
    for p in range(8, 11):
        tm.decode_step(tp, cache, toks[:, p:p + 1], p)
    assert cache["filled"] == 11
    with pytest.raises(ValueError, match="gap"):
        tm.decode_step(tp, cache, toks[:, 11:12], 12)


@pytest.mark.parametrize("arch", MAMBA_ARCHS)
def test_a_mamba_stack_refuses_to_roll_back_and_writes_nothing(arch):
    """Its state has absorbed every token: a step at 0 < start < filled
    raises before any write, as does a chunked prefill (start > 0,
    S > 1), which the reference would restart silently from zero."""
    tm, tp = _port_model(arch)
    toks = torch.from_numpy(_tokens(tm.cfg, 1, 16))
    cache = tm.init_cache(1, 24, device="cpu")
    _, cache = tm.prefill(tp, cache, {"tokens": toks[:, :10]})
    tm.decode_step(tp, cache, toks[:, 10:11], 10)
    before = _cache_tensors(cache)
    with pytest.raises(ValueError, match="roll back"):
        tm.decode_step(tp, cache, toks[:, 5:6], 5)
    with pytest.raises(ValueError, match="roll back"):
        TT.lm_forward(tp, tm.cfg, toks[:, 3:6], 3, cache=cache)
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        TT.lm_forward(tp, tm.cfg, toks[:, 11:14], 11, cache=cache)
    assert cache["filled"] == 11
    after = _cache_tensors(cache)
    assert all(torch.equal(before[k], after[k]) for k in before), arch


@pytest.mark.parametrize("S", [1, 6])
@pytest.mark.parametrize("arch", MAMBA_ARCHS)
def test_a_step_at_zero_restarts_a_used_cache(arch, S):
    """A step at start 0 on a used cache equals the same step on a fresh
    one: the logits, ``filled`` and every Mamba state bit for bit (S 1 is
    a one-token decode step over a zeroed state)."""
    tm, tp = _port_model(arch)
    toks = torch.from_numpy(_tokens(tm.cfg, 1, 12))
    new = torch.from_numpy(_tokens(tm.cfg, 1, S, seed=1))
    used = tm.init_cache(1, 24, device="cpu")
    _, used = tm.prefill(tp, used, {"tokens": toks[:, :10]})
    tm.decode_step(tp, used, toks[:, 10:11], 10)
    fresh = tm.init_cache(1, 24, device="cpu")
    a, used = TT.lm_forward(tp, tm.cfg, new, 0, cache=used)[:2]
    b, fresh = TT.lm_forward(tp, tm.cfg, new, 0, cache=fresh)[:2]
    assert torch.equal(a, b)
    assert used["filled"] == fresh["filled"] == S
    ua, fa = _cache_tensors(used), _cache_tensors(fresh)
    for (key, kind, n), t in fa.items():
        u = ua[key, kind, n]
        if kind == "kv":             # the slots past S hold the old run's
            cut = (slice(None),) * (1 if n == "pos" else 2) + (slice(S),)
            t, u = t[cut], u[cut]
        assert torch.equal(t, u), (key, kind, n)


def test_the_reference_one_token_step_at_zero_continues_a_used_state():
    """The divergence pinned in ROADMAP Queue 3: the reference's one-token
    step at position 0 over a used cache reads the state left there (its
    logits differ from a fresh cache's), while the port's restarts (equal
    to a fresh cache's, and to the reference's fresh one within
    ``F32_CACHE_TOL``)."""
    jm, jp, tm, tp = _reference("mamba2-1.3b", f32=True)
    toks = _tokens(jm.cfg, 1, 11)
    dec = jax.jit(jm.decode_step)
    used = unzip(jm.init_cache(1, 24))[0]
    _, used = jax.jit(jm.prefill)(jp, used, {"tokens": jnp.asarray(toks)})
    ref_used, _ = dec(jp, used, jnp.asarray(toks[:, :1]), jnp.int32(0))
    ref_fresh, _ = dec(jp, unzip(jm.init_cache(1, 24))[0],
                       jnp.asarray(toks[:, :1]), jnp.int32(0))
    assert np.abs(_np(ref_used) - _np(ref_fresh)).max() > 1e-2
    cache = tm.init_cache(1, 24, device="cpu")
    _, cache = tm.prefill(tp, cache, {"tokens": torch.from_numpy(toks)})
    out, _ = tm.decode_step(tp, cache, torch.from_numpy(toks[:, :1]), 0)
    fresh, _ = tm.decode_step(tp, tm.init_cache(1, 24, device="cpu"),
                              torch.from_numpy(toks[:, :1]), 0)
    assert torch.equal(out, fresh)
    _close(out, ref_fresh, F32_CACHE_TOL, "one-token step at 0")


def test_a_short_prompt_leaves_a_full_conv_state():
    """A 2-token prefill (fewer than conv_width - 1 = 3) leaves the conv
    state left-padded with the zeros the causal conv saw, so a decode
    step after it equals three one-token steps from an empty cache (f32
    params and caches, ``F32_TOL``).  The
    reference keeps one row there, and its next decode step raises
    (ROADMAP Queue 3)."""
    jm, jp, tm, tp = _reference("mamba2-1.3b", f32=True)
    toks = _tokens(tm.cfg, 2, 3)
    t = torch.from_numpy(toks)
    # f32 caches: the two paths round nothing to bf16 in between
    a = _f32_cache(tm.init_cache(2, 8, device="cpu"))
    _, a = tm.prefill(tp, a, {"tokens": t[:, :2]})
    conv = a["blocks"]["pos0"]["mamba"]["conv"]
    assert conv.shape[2] == tm.cfg.ssm.conv_width - 1
    assert not conv[:, :, 0].any() and conv[:, :, 1:].any()
    out_a, a = tm.decode_step(tp, a, t[:, 2:3], 2)
    b = _f32_cache(tm.init_cache(2, 8, device="cpu"))
    for p in range(3):
        out_b, b = tm.decode_step(tp, b, t[:, p:p + 1], p)
    _close(out_a, out_b, F32_TOL, "decode after a 2-token prefill")
    for k, u in _cache_tensors(a).items():
        _close(u, _cache_tensors(b)[k], F32_TOL, f"cache {k}")
    jc = unzip(jm.init_cache(2, 8))[0]
    _, jc = jax.jit(jm.prefill)(jp, jc, {"tokens": jnp.asarray(toks[:, :2])})
    assert jc["blocks"]["pos0"]["mamba"]["conv"].shape[2] == 1
    with pytest.raises(ValueError):
        jm.decode_step(jp, jc, jnp.asarray(toks[:, 2:3]), jnp.int32(2))


def test_params_from_numpy_carries_f32_mamba_leaves_of_a_bf16_tree():
    """The reference's bf16 tree keeps ``A_log``, ``D``, ``dt_bias`` and
    ``norm_scale`` in f32: they cross in f32 and exactly, the bf16 leaves
    in bf16."""
    _, jp, _, tp = _reference("jamba-v0.1-52b", f32=False)
    for key, jblk in jp["blocks"].items():
        for name, j in jblk.get("mamba", {}).items():
            t, j = tp["blocks"][key]["mamba"][name], np.asarray(j)
            f32_leaf = name in ("A_log", "D", "dt_bias", "norm_scale")
            assert (j.dtype == np.float32) == f32_leaf, (key, name)
            assert t.dtype == (torch.float32 if f32_leaf
                               else torch.bfloat16), (key, name)
            assert np.array_equal(t.float().numpy(), j.astype(np.float32))


def test_params_from_numpy_carries_mla_prefix_and_shared_leaves():
    """deepseek-v2's bf16 tree crosses exactly: every MLA leaf, the dense
    prefix layer ``prefix0`` and each MoE layer's ``shared`` FFN in bf16,
    the routers in f32, each leaf equal to the reference's."""
    _, jp, _, tp = _reference("deepseek-v2-236b", f32=False)
    mla = {"wq", "w_dkv", "w_krope", "w_uk", "w_uv", "wo"}
    assert set(jp["prefix0"]["attn"]) == mla
    assert set(jp["blocks"]["pos0"]["ffn"]["shared"]) == {
        "w_up", "w_gate", "w_down"}
    leaves = 0
    for path, j in jax.tree_util.tree_leaves_with_path(jp):
        keys = [k.key for k in path]
        t = tp
        for k in keys:
            t = t[k]
        j = np.asarray(j)
        f32_leaf = keys[-1] in ("w_router", "b_router") or keys[-1] == "scale"
        assert (j.dtype == np.float32) == f32_leaf, keys
        assert t.dtype == (torch.float32 if f32_leaf else torch.bfloat16), keys
        assert tuple(t.shape) == j.shape, keys
        assert np.array_equal(t.float().numpy(), j.astype(np.float32)), keys
        leaves += 1
    assert leaves == len(list(tp.parameters()))


def test_unported_branches_raise():
    pix = Model(get_config("pixtral-12b").smoke())
    pp = pix.init(0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="training|loss"):
        pix.loss(pp, {"tokens": toks, "labels": toks})
    cache = pix.init_cache(1, 16, device="cpu")
    pix.prefill(pp, cache, {"tokens": toks})
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        TT.lm_forward(pp, pix.cfg, toks, 4, cache=cache)


# tests/test_arch_smoke.py:84-95
EXPECTED_PARAMS = {"gemma2-9b": (9e9, 0.25), "deepseek-7b": (7e9, 0.25),
                   "llama3-8b": (8e9, 0.25), "starcoder2-3b": (3e9, 0.35),
                   "phi3.5-moe-42b-a6.6b": (42e9, 0.25),
                   "deepseek-v2-236b": (236e9, 0.25),
                   "mamba2-1.3b": (1.3e9, 0.25),
                   "jamba-v0.1-52b": (52e9, 0.25),
                   "seamless-m4t-medium": (1.2e9, 0.5),
                   "pixtral-12b": (12e9, 0.25)}


@pytest.mark.parametrize("arch", ARCHS + ["seamless-m4t-medium",
                                          "pixtral-12b"])
def test_full_config_param_count(arch):
    """Counted from shapes on the meta device, nothing allocated; equal to
    the reference's abstract count."""
    n = param_count(Model(get_config(arch)).init(device="meta"))
    jparams = unzip(JModel(j_get_config(arch)).init(None, abstract=True))[0]
    assert n == sum(int(np.prod(l.shape)) for l in jax.tree.leaves(jparams))
    target, tol = EXPECTED_PARAMS[arch]
    assert abs(n - target) / target < tol, f"{arch}: {n / 1e9:.2f}B"
