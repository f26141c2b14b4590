"""The tensor-parallel layout of the dense stacks
(``distributed/tensor_parallel.py``) on CPU debug meshes, held against
the reference's single-device functions in process on one JAX device,
with inputs made by numpy from a seed and the reference's weights
carried across by ``tree_from_numpy``:

* the vocab-parallel embedding, bit for bit, bf16 and f32;
* ``ffn`` (gated SiLU, plain GELU) and ``gqa_forward`` at a prefill and
  one decode step (a kv-split case, Hkv dividing the model axis, and a
  kv-replicated one, 8 / 2 heads on a model axis of 4; a window with a
  softcap; a cache capacity of 45, which the model axis does not divide,
  so its slots stay whole, with kv heads split and replicated) within
  ``LAYER_TOL`` = 1e-5 of max |y|, f32;
* whole small stacks, llama-like (8 / 2 heads, and 8 / 4 heads over a
  cache of 45 slots), gemma2-like (window 32, both softcaps, tied table,
  post-norms) and pixtral-like (8 media embeddings before the tokens):
  prefill and 4 greedy decode steps
  against the reference's ``Model.prefill`` / ``decode_step`` on (2, 2)
  and (1, 4) meshes, logits within ``LOGIT_TOL`` = 1e-4 of max |ref| in
  f32 (f32 params, and f32 caches in both packages: a bf16 cache stores
  an f32 k that lands across a rounding boundary one bf16 step apart,
  ``test_torch_model.py``'s ``F32_CACHE_TOL``), the placed cache's
  blocks gathered within the same tolerance of the reference's cache,
  and on the (2, 2) mesh a second call equal to the first bit for bit;
* every placed leaf laid out as the reference's ``spec_for`` gives it,
  the placement round trip bit for bit, the layout chosen by the stack,
  a misplaced operand raising, and params placed by the FSDP rules
  raising ``NotImplementedError``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.distributed.compat import abstract_mesh as j_abstract_mesh
from repro.distributed.sharding import make_rules as j_make_rules
from repro.distributed.sharding import spec_for as j_spec_for
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import params as JP
from repro.models.model import Model as JModel
from repro.models.params import unzip
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import compat
from repro_torch.distributed.meshctx import MeshPolicy, use_policy
from repro_torch.distributed.sharding import (NamedSharding, cache_pspecs,
                                              dense_layout, gather_to_host,
                                              logical_axes, make_rules,
                                              param_pspecs, place_batch,
                                              place_cache, place_params,
                                              shardings_for)
from repro_torch.distributed.tensor_parallel import TPRun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.model import Model, greedy, params_from_numpy
from repro_torch.models.params import flat_tree, tree_from_numpy

LAYER_TOL, LOGIT_TOL = 1e-5, 1e-4
MESHES = [(2, 2), (1, 4)]
S_PROMPT, N_DECODE = 40, 4


def _policy(n_data, n_model):
    return MeshPolicy(mesh=make_debug_mesh(n_data, n_model, device="cpu"),
                      rules=make_rules(False, fsdp=False))


def _run(pol, B, params, cache=None):
    """A TPRun over ``params`` (and ``cache``) placed by ``pol``."""
    mesh, rules = pol.mesh, pol.rules
    placed = place_params(params, mesh, rules)
    placed_cache = {} if cache is None else place_cache(cache, mesh, rules)
    return TPRun(pol, B, placed, placed_cache), placed, placed_cache


def _whole(run, xs):
    """Per-coordinate rows as one tensor, each model group's members
    equal bit for bit."""
    rows = []
    for g in run.groups:
        for c in g[1:]:
            assert torch.equal(xs[c], xs[g[0]]), c
        rows.append(xs[g[0]])
    return torch.cat(rows)


def _close(out, ref, tol, what=""):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mesh", MESHES)
def test_vocab_parallel_embedding_is_bit_equal(mesh, dtype):
    rng = np.random.default_rng(0)
    V, D, B, S = 256, 32, 4, 9
    table = jnp.asarray(rng.standard_normal((V, D)), jnp.dtype(dtype))
    tok = rng.integers(0, V, (B, S)).astype(np.int32)
    tok[0, :3] = [0, V - 1, V // 4]           # both ends of a vocab block
    ref = np.asarray(JL.embed({"table": table}, jnp.asarray(tok)))
    params = {"embed": tree_from_numpy({"table": np.asarray(table)},
                                       "cpu")}
    want_dtype = params["embed"]["table"].dtype
    run, _, _ = _run(_policy(*mesh), B, params)
    assert run.param_sh["embed"]["table"].spec == ("model",)
    out = TL.embed_tp(run, run.param_sh["embed"]["table"],
                      {c: run.params[c]["embed"]["table"]
                       for c in run.coords},
                      run.split_rows(torch.from_numpy(tok)), V)
    got = _whole(run, out)
    assert got.dtype == want_dtype
    assert np.array_equal(got.float().numpy(), ref.astype(np.float32))


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")])
@pytest.mark.parametrize("mesh", MESHES)
def test_ffn_tp_matches_reference(mesh, gated, act):
    rng = np.random.default_rng(1)
    D, F, B, S = 32, 64, 4, 7
    p = {"w_up": rng.standard_normal((D, F)) / 6,
         "w_down": rng.standard_normal((F, D)) / 8}
    if gated:
        p["w_gate"] = rng.standard_normal((D, F)) / 6
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    ref = JL.ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                 act)
    run, _, _ = _run(_policy(*mesh), B, {"ffn": tree_from_numpy(p, "cpu")})
    sh = run.param_sh["ffn"]
    assert sh["w_up"].spec == (None, "model")
    assert sh["w_down"].spec == ("model",)
    out = TL.ffn_tp(run, {c: run.params[c]["ffn"] for c in run.coords},
                    sh["w_down"], run.split_rows(torch.from_numpy(x)), act)
    _close(_whole(run, out), ref, LAYER_TOL, f"ffn {act}")


GQA_CASES = {
    # name: (H, Hkv, window, softcap, mesh, cap)
    "kv-split": (8, 4, None, 0.0, (2, 2), 48),
    "kv-replicated-8/2-on-4": (8, 2, None, 0.0, (1, 4), 48),
    "window-softcap": (4, 2, 24, 50.0, (2, 2), 48),
    # a capacity the model axis does not divide: the cache's slots stay
    # whole, its kv heads split with the query heads or stay whole
    "cap-45-kv-split": (8, 4, None, 0.0, (2, 2), 45),
    "cap-45-kv-replicated": (8, 2, 24, 50.0, (1, 4), 45),
}


@pytest.mark.parametrize("case", list(GQA_CASES))
def test_gqa_forward_tp_matches_reference(case):
    """A prefill of 40 and one decode step through ``gqa_forward_tp`` on
    a placed cache against the reference's ``gqa_forward``; then the
    placed cache, gathered, against the reference's."""
    H, Hkv, window, softcap, mesh, cap = GQA_CASES[case]
    jcfg = dataclasses.replace(j_get_config("llama3-8b").smoke(), n_heads=H,
                               n_kv_heads=Hkv, attn_logit_softcap=softcap)
    tcfg = get_config("llama3-8b").smoke().replace(
        n_heads=H, n_kv_heads=Hkv, attn_logit_softcap=softcap)
    ini = JP.Initializer(jax.random.PRNGKey(0), dtype=jnp.float32)
    jp = unzip(JA.init_attention(ini, jcfg))[0]
    B, D, hd = 4, jcfg.d_model, jcfg.head_dim_
    x = np.random.default_rng(2).standard_normal(
        (B, S_PROMPT + 1, D)).astype(np.float32)
    jc = {"k": jnp.zeros((B, cap, Hkv, hd)), "v": jnp.zeros((B, cap, Hkv, hd)),
          "pos": jnp.full((cap,), -1, jnp.int32)}
    jo1, jc = JA.gqa_forward(jp, jcfg, jnp.asarray(x[:, :S_PROMPT]),
                             jnp.arange(S_PROMPT, dtype=jnp.int32),
                             window=window, cache=jc)
    jo2, jc = JA.gqa_forward(jp, jcfg, jnp.asarray(x[:, S_PROMPT:]),
                             jnp.asarray([S_PROMPT], jnp.int32),
                             window=window, cache=jc)

    # one stacked layer, as the stacks hold it
    stacked = {"blocks": {"pos0": {"attn": tree_from_numpy(
        jax.tree.map(lambda a: np.asarray(a)[None], jp), "cpu")}}}
    cache = {"blocks": {"pos0": {"kv": {
        "k": torch.zeros((1, B, cap, Hkv, hd)),
        "v": torch.zeros((1, B, cap, Hkv, hd)),
        "pos": torch.full((1, cap), -1, dtype=torch.int32)}}}, "filled": 0}
    pol = _policy(*mesh)
    run, _, placed = _run(pol, B, stacked, cache)
    sh = run.param_sh["blocks"]["pos0"]["attn"]
    kv_sh = run.cache_sh["blocks"]["pos0"]["kv"]
    n = mesh[1]
    assert kv_sh["k"].spec == ((None, "data", "model") if cap % n == 0 else
                               (None, "data", None, "model") if Hkv % n == 0
                               else (None, "data"))
    outs = []
    for start, xs in ((0, x[:, :S_PROMPT]), (S_PROMPT, x[:, S_PROMPT:])):
        out = TA.gqa_forward_tp(
            run, tcfg, {c: {k: v[0] for k, v in run.params[c]["blocks"]
                            ["pos0"]["attn"].items()} for c in run.coords},
            sh, run.split_rows(torch.from_numpy(xs)), start, window=window,
            kv={c: {k: v[0] for k, v in run.cache[c]["blocks"]["pos0"]
                    ["kv"].items()} for c in run.coords},
            kv_sh=kv_sh, pos_at=lambda c: run.cache_block(
                "blocks/pos0/kv/pos", c)[0], cap=cap)
        outs.append(_whole(run, out))
    _close(outs[0], jo1, LAYER_TOL, f"{case} prefill")
    _close(outs[1], jo2, LAYER_TOL, f"{case} decode")
    got = gather_to_host(placed)
    for name in ("k", "v"):
        _close(got[f"blocks/pos0/kv/{name}"][0], jc[name], LAYER_TOL,
               f"{case} cache {name}")
    assert np.array_equal(got["blocks/pos0/kv/pos"][0].numpy(),
                          np.asarray(jc["pos"]))


# ---------------------------------------------------------------------------
# whole stacks
# ---------------------------------------------------------------------------

def _stack_cfgs(kind):
    if kind.startswith("llama-"):
        H, Hkv = map(int, kind.split("-")[1].split("/"))
        j = dataclasses.replace(j_get_config("llama3-8b").smoke(),
                                n_heads=H, n_kv_heads=Hkv)
        return j, get_config("llama3-8b").smoke().replace(n_heads=H,
                                                          n_kv_heads=Hkv)
    arch = {"gemma2": "gemma2-9b", "pixtral": "pixtral-12b"}[kind]
    return j_get_config(arch).smoke(), get_config(arch).smoke()


def _f32_cache(cache):
    if isinstance(cache, dict):
        return {k: _f32_cache(v) for k, v in cache.items()}
    if isinstance(cache, torch.Tensor):
        return cache.float() if cache.dtype == torch.bfloat16 else cache
    if hasattr(cache, "dtype") and cache.dtype == jnp.bfloat16:
        return cache.astype(jnp.float32)
    return cache


_REFERENCE = {}


def _reference(kind):
    """The reference's prefill and greedy decode (f32 params and cache):
    its params, batch, logits of each step, tokens fed and final cache."""
    if kind in _REFERENCE:
        return _REFERENCE[kind]
    jcfg, tcfg = _stack_cfgs(kind)
    jm = JModel(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      unzip(jm.init(jax.random.PRNGKey(0)))[0])
    B = 4
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, S_PROMPT)).astype(
        np.int32)}
    if jcfg.num_media_tokens:
        batch["media"] = rng.standard_normal(
            (B, jcfg.num_media_tokens, jcfg.d_model)).astype(np.float32)
    P = S_PROMPT + jcfg.num_media_tokens
    # cap-45: a capacity the model axis does not divide (its slots whole)
    cap = 45 if kind.endswith("cap-45") else -(-(P + N_DECODE) // 8) * 8
    cache = _f32_cache(unzip(jm.init_cache(B, cap))[0])
    logits, cache = jax.jit(jm.prefill)(
        jp, cache, {k: jnp.asarray(v) for k, v in batch.items()})
    outs, fed = [np.asarray(logits)], []
    dec = jax.jit(jm.decode_step)
    for step in range(N_DECODE):
        nxt = np.argmax(outs[-1][:, -1:], axis=-1).astype(np.int32)
        fed.append(nxt)
        logits, cache = dec(jp, cache, jnp.asarray(nxt), jnp.int32(P + step))
        outs.append(np.asarray(logits))
    _REFERENCE[kind] = (tcfg, jax.tree.map(np.asarray, jp), batch, cap, outs,
                        fed, jax.tree.map(np.asarray, cache))
    return _REFERENCE[kind]


def _serve(model, params, cache, batch, fed, P, pol):
    with use_policy(pol):
        logits, cache = model.prefill(params, cache, batch)
        outs = [logits]
        for step, tok in enumerate(fed):
            logits, cache = model.decode_step(
                params, cache, torch.from_numpy(tok), P + step)
            outs.append(logits)
    return outs, cache


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", ["llama-8/2", "gemma2", "pixtral",
                                  "llama-8/4-cap-45"])
def test_stack_prefill_and_decode_match_reference(kind, mesh):
    tcfg, jp, batch, cap, ref, fed, jc = _reference(kind)
    model = Model(tcfg)
    pol = _policy(*mesh)
    assert dense_layout(tcfg, pol) == "tensor_parallel"
    params = place_params(params_from_numpy(jp, "cpu"), pol.mesh, pol.rules)
    B, P = batch["tokens"].shape[0], S_PROMPT + tcfg.num_media_tokens
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = []
    for _ in range(2 if mesh == (2, 2) else 1):   # call == call on one
        cache = place_cache(_f32_cache(model.init_cache(B, cap, "cpu")),
                            pol.mesh, pol.rules)
        runs.append(_serve(model, params, cache, tbatch, fed, P, pol))
    outs, cache = runs[0]
    for i, (out, r) in enumerate(zip(outs, ref)):
        assert isinstance(out, compat.Sharded) and out.grid == (
            mesh[0], mesh[1])
        _close(out.gather("cpu"), r, LOGIT_TOL, f"{kind} logits {i}")
        for again, _ in runs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(
                out.shards, again[i].shards))
        want = np.argmax(r[:, -1], -1)
        if i < N_DECODE:
            assert np.array_equal(want[:, None], fed[i])
        assert np.array_equal(greedy(out).numpy()[:, 0], want)
    assert cache["filled"] == P + N_DECODE
    got = gather_to_host(cache)
    for key, want in flat_tree(jc).items():
        if key.endswith("/pos"):
            assert np.array_equal(got[key].numpy(), want), key
        else:
            _close(got[key], want, LOGIT_TOL, f"{kind} cache {key}")


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mesh,shape", [
    ("gemma2-9b", (2, 2), None), ("starcoder2-3b", (1, 4), None),
    ("llama3-8b", (16, 16), "meta"), ("deepseek-7b", (16, 16), "meta"),
])
def test_placement_follows_reference_spec_for(arch, mesh, shape):
    """Every param, cache and batch leaf placed as the reference's
    ``spec_for`` gives it: each coordinate's block is the whole leaf cut
    by the reference's spec (shapes and, on the CPU, values)."""
    device = shape or "cpu"
    cfg = get_config(arch) if shape else get_config(arch).smoke()
    model = Model(cfg)
    params = model.init(0, device) if device == "cpu" else model.init(
        device="meta")
    B, cap = (32, 64) if shape else (4, 24)
    cache = model.init_cache(B, cap, device=device)
    if device == "cpu":
        for t in flat_tree(cache).values():
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                t.copy_(torch.randn(t.shape))
    whole = {k: v.clone() for k, v in flat_tree(cache).items()
             if isinstance(v, torch.Tensor)}
    pol = _policy(*mesh) if device == "cpu" else MeshPolicy(
        mesh=make_debug_mesh(*mesh, device="meta"),
        rules=make_rules(False, fsdp=False))
    j_mesh = j_abstract_mesh(mesh, ("data", "model"))
    j_rules = j_make_rules(False, fsdp=False)
    p_axes = logical_axes(param_pspecs(params))
    c_axes = logical_axes(cache_pspecs(cache))
    tok = torch.zeros((B, 8), dtype=torch.int32, device=device)
    p_whole = {k: v.clone() for k, v in flat_tree(params).items()}
    placed = {"params": place_params(params, pol.mesh, pol.rules),
              "cache": place_cache(cache, pol.mesh, pol.rules),
              "batch": place_batch({"tokens": tok}, pol.mesh, pol.rules)}
    axes = {**{f"params/{k}": v for k, v in p_axes.items()},
            **{f"cache/{k}": v for k, v in c_axes.items()},
            "batch/tokens": ("batch", None)}
    src = {**{f"params/{k}": v for k, v in p_whole.items()},
           **{f"cache/{k}": v for k, v in whole.items()},
           "batch/tokens": tok}
    for key, leaf in flat_tree(placed).items():
        if key == "cache/filled":
            continue
        spec = tuple(j_spec_for(axes[key], j_rules, j_mesh,
                                tuple(leaf.shape)))
        sh = NamedSharding(pol.mesh, spec)
        assert sh.holds(leaf), (key, spec, leaf)
        for c in pol.mesh.coords():
            blk = (leaf.shards[sh.index_at(c)] if not sh.replicated
                   else leaf.value if isinstance(leaf, compat.Replicated)
                   else leaf)
            sl = tuple(slice(*sh.range_at(c, d, n))
                       for d, n in enumerate(leaf.shape))
            assert tuple(blk.shape) == tuple(src[key][sl].shape), key
            if device == "cpu":
                assert torch.equal(blk, src[key][sl]), (key, c)


def test_layout_is_the_stacks_and_a_misplaced_operand_raises():
    pol = _policy(2, 2)
    slice_archs = {"llama3-8b", "starcoder2-3b", "gemma2-9b", "deepseek-7b",
                   "pixtral-12b", "phi3.5-moe-42b-a6.6b", "mamba2-1.3b",
                   "jamba-v0.1-52b"}
    for arch in ARCH_IDS:
        want = "tensor_parallel" if arch in slice_archs else "home"
        assert dense_layout(get_config(arch), pol) == want, arch
        assert dense_layout(get_config(arch), MeshPolicy(
            mesh=pol.mesh)) == "home"
    model = Model(get_config("llama3-8b").smoke())
    params = model.init(0, "cpu")
    cache = place_cache(model.init_cache(2, 8, "cpu"), pol.mesh, pol.rules)
    tok = torch.zeros((2, 4), dtype=torch.int32)
    with use_policy(pol), pytest.raises(ValueError, match="not placed"):
        model.prefill(params, cache, {"tokens": tok})
    placed = place_params(params, pol.mesh, pol.rules)
    whole = model.init_cache(2, 8, "cpu")
    with use_policy(pol), pytest.raises(ValueError, match="not placed"):
        model.prefill(placed, whole, {"tokens": tok})
    bad = compat.split(tok, [torch.device("cpu")] * 2, dim=1)
    with use_policy(pol), pytest.raises(ValueError, match="not placed"):
        model.prefill(placed, cache, {"tokens": bad})
    with use_policy(pol), pytest.raises(NotImplementedError):
        model.forward(placed, {"tokens": tok})


def test_fsdp_rules_raise_not_implemented():
    """The FSDP rules (``make_rules``' default) split params over the
    batch axes: serving on them is not ported, and says so."""
    pol = MeshPolicy(mesh=make_debug_mesh(2, 2, device="cpu"),
                     rules=make_rules(False))
    model = Model(get_config("llama3-8b").smoke())
    assert dense_layout(model.cfg, pol) == "tensor_parallel"
    params = model.init(0, "cpu")
    specs = flat_tree(shardings_for(param_pspecs(params), pol.mesh,
                                    pol.rules))
    assert any("data" in str(spec) for spec in specs.values())
    params = place_params(params, pol.mesh, pol.rules)
    cache = place_cache(model.init_cache(2, 8, "cpu"), pol.mesh, pol.rules)
    tok = torch.zeros((2, 4), dtype=torch.int32)
    with use_policy(pol), pytest.raises(NotImplementedError, match="FSDP"):
        model.prefill(params, cache, {"tokens": tok})
