"""mamba2-1.3b and jamba partitioned over a mesh (``models/ssd.py``'s
``mamba_forward_tp`` in
``distributed/tensor_parallel.py``'s loop) on CPU debug meshes, with
inputs made by numpy from a seed and the reference's weights carried
across by ``params_from_numpy``:

* against the reference: the mamba2 and jamba smoke stacks (jamba's
  first period, ``LAYERS``, at capacity factor 4, so the expert bodies
  drop nothing) do a prefill of
  20 and 3 greedy decode steps on (2, 2) and (1, 4) meshes, against the
  reference's single-device ``lm_forward`` in process (what its
  ``Model.prefill`` / ``decode_step`` run, with the metrics): logits
  within ``LOGIT_TOL`` = 1e-4 of max |ref| in f32, every cache leaf (the
  Mamba state blocks gathered) within the same, jamba's
  ``expert_counts`` equal; the smoke widths (``in_proj`` 304 columns,
  conv 160 channels, 16 heads) put ``in_proj``'s block boundaries inside
  x on both meshes, so the exchanges move pieces; on the (2, 2) mesh a
  second call equal to the first bit for bit, the states and metrics
  included;
* against the home layout (a policy without rules): jamba's B 1 decode
  on the (2, 2) mesh, whose KV cache splits its slots over ``("data",
  "model")``, from a cache the home layout's prefill filled and
  ``place_cache`` placed; and a mamba2 variant with ``d_state`` 5 on the
  (1, 4) mesh, where ``in_proj`` and ``conv_w`` stay whole: logits within
  ``HOME_TOL`` = 1e-5, ``dropped`` and ``expert_counts`` equal exactly.
  A partitioned B 1 prefill long enough for the MoE all-to-all body
  raises ``NotImplementedError``;
* the gated RMSNorm over the whole d_inner, where one coordinate's
  channels alone would give another scale;
* the step rules on placed state: a one-token step at 0 restarts from
  zero, a roll-back and a gap raise and write nothing;
* every Mamba leaf (and the B 1 KV cache) placed as the reference's
  ``spec_for`` gives it, at smoke scale on the CPU and at full width on a
  16 x 16 ``meta`` mesh; a head count the model axis does not divide
  raises ``NotImplementedError``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as j_get_config
from repro.distributed.compat import abstract_mesh as j_abstract_mesh
from repro.distributed.sharding import make_rules as j_make_rules
from repro.distributed.sharding import spec_for as j_spec_for
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro.models.params import unzip
from repro_torch.configs import get_config
from repro_torch.distributed import compat
from repro_torch.distributed.meshctx import MeshPolicy, use_policy
from repro_torch.distributed.sharding import (NamedSharding, cache_pspecs,
                                              dense_layout, gather_to_host,
                                              logical_axes, make_rules,
                                              param_pspecs, place_cache,
                                              place_params)
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import ssd as TS
from repro_torch.models.layers import rmsnorm
from repro_torch.models.model import Model, greedy, params_from_numpy
from repro_torch.models.params import flat_tree, index_tree, unflat_tree

ARCHS = {"mamba2": "mamba2-1.3b", "jamba": "jamba-v0.1-52b"}
LOGIT_TOL, HOME_TOL = 1e-4, 1e-5
B, S_PROMPT, N_DECODE, CAP = 4, 20, 3, 24
# jamba's smoke stack cut to its first period (8 layers: attention,
# Mamba, dense and MoE FFNs).  Random-weight jamba is chaotic in depth
# (tests/test_torch_model.py): over the smoke stack's 16 layers a one-ulp
# change of the embedding table moves the home layout's own logits by up
# to 4.8e-5 of their max, which leaves neither HOME_TOL nor LOGIT_TOL
# room for another order of the same sums; over 8 layers, 5.8e-6
# (tools/hybrid_tp_depth_witness.py)
LAYERS = {"jamba": 8}


def _policy(n_data, n_model, rules=True):
    return MeshPolicy(mesh=make_debug_mesh(n_data, n_model, device="cpu"),
                      rules=make_rules(False, fsdp=False) if rules else None)


def _cfgs(kind, **ssm):
    """The reference's and the port's smoke configs of ``kind``, MoE at
    capacity factor 4, cut to ``LAYERS`` and SSM fields replaced where
    given."""
    out = []
    for c in (j_get_config(ARCHS[kind]).smoke(),
              get_config(ARCHS[kind]).smoke()):
        if c.moe is not None:
            c = c.replace(moe=dataclasses.replace(c.moe, capacity_factor=4.0))
        if kind in LAYERS:
            c = c.replace(n_layers=LAYERS[kind])
        if ssm:
            c = c.replace(ssm=dataclasses.replace(c.ssm, **ssm))
        out.append(c)
    return out


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float() if tree.dtype == torch.bfloat16 else tree
    if hasattr(tree, "dtype") and tree.dtype == jnp.bfloat16:
        return tree.astype(jnp.float32)
    return tree


def _close(out, ref, tol, what):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else \
        np.asarray(out, np.float32)
    ref = ref.float().numpy() if isinstance(ref, torch.Tensor) else \
        np.asarray(jnp.asarray(ref, jnp.float32))
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _whole(logits):
    return logits.gather("cpu") if isinstance(logits, compat.Sharded) \
        else logits


def _serve(model, params, cache, tokens, fed, P, pol, prefill=True):
    """A prefill (unless ``prefill`` is False) and one decode step a fed
    token under ``pol``: each call's logits and metrics."""
    outs = []
    with use_policy(pol):
        if prefill:
            logits, cache, m = model.prefill(params, cache,
                                             {"tokens": tokens},
                                             with_metrics=True)
            outs.append((logits, m))
        for step, tok in enumerate(fed):
            logits, cache, m = model.decode_step(params, cache, tok, P + step,
                                                 with_metrics=True)
            outs.append((logits, m))
    return outs


def _states(cache) -> dict:
    """Every Mamba state leaf of a (placed) cache, whole on the host."""
    return {k: v for k, v in gather_to_host(cache).items() if "/mamba/" in k}


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

_REFERENCE = {}


def _reference(kind):
    """The reference's prefill and greedy decode on one device (f32 params
    and cache) through its ``lm_forward`` (each call's metrics too): its
    params, prompt, each call's logits and metrics, the tokens fed and the
    final cache."""
    if kind in _REFERENCE:
        return _REFERENCE[kind]
    jcfg, tcfg = _cfgs(kind)
    jm = JModel(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      unzip(jm.init(jax.random.PRNGKey(0)))[0])
    tokens = np.random.default_rng(7).integers(
        0, jcfg.vocab, (B, S_PROMPT)).astype(np.int32)
    cache = _f32(unzip(jm.init_cache(B, CAP))[0])
    step = jax.jit(lambda p, c, t, pos: JT.lm_forward(
        p, jcfg, t, positions=pos, cache=c))
    logits, cache, m = step(jp, cache, jnp.asarray(tokens),
                            jnp.arange(S_PROMPT, dtype=jnp.int32))
    outs, fed = [(np.asarray(logits), jax.tree.map(np.asarray, m))], []
    for j in range(N_DECODE):
        nxt = np.argmax(outs[-1][0][:, -1:], axis=-1).astype(np.int32)
        fed.append(nxt)
        logits, cache, m = step(jp, cache, jnp.asarray(nxt),
                                jnp.asarray([S_PROMPT + j], jnp.int32))
        outs.append((np.asarray(logits), jax.tree.map(np.asarray, m)))
    _REFERENCE[kind] = (tcfg, jax.tree.map(np.asarray, jp), tokens, outs,
                        fed, jax.tree.map(np.asarray, cache))
    return _REFERENCE[kind]


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
@pytest.mark.parametrize("kind", list(ARCHS))
def test_stack_prefill_and_decode_match_reference(kind, mesh):
    tcfg, jp, tokens, ref, fed, jc = _reference(kind)
    model = Model(tcfg)
    pol = _policy(*mesh)
    assert dense_layout(tcfg, pol) == "tensor_parallel"
    params = place_params(params_from_numpy(jp, "cpu"), pol.mesh, pol.rules)
    # in_proj's column blocks end inside x ([d_inner, 2 d_inner)), so the
    # conv blocks and the heads take pieces of other members' columns
    d_inner = tcfg.ssm.expand * tcfg.d_model
    inp = params["blocks"]["pos0"]["mamba"]["in_proj"]
    width = inp.shards[0].shape[-1]
    assert isinstance(inp, compat.Sharded) and any(
        d_inner < k * width < 2 * d_inner for k in range(1, mesh[1]))
    runs = []
    for _ in range(2 if mesh == (2, 2) else 1):   # call == call on one
        cache = place_cache(_f32(model.init_cache(B, CAP, "cpu")),
                            pol.mesh, pol.rules)
        outs = _serve(model, params, cache, torch.from_numpy(tokens),
                      [torch.from_numpy(t) for t in fed], S_PROMPT, pol)
        runs.append((outs, cache))
    (outs, cache) = runs[0]
    for i, ((out, m), (r, rm)) in enumerate(zip(outs, ref)):
        assert isinstance(out, compat.Sharded) and out.grid == mesh
        _close(out.gather("cpu"), r, LOGIT_TOL, f"{kind} logits {i}")
        if tcfg.moe is not None:
            assert np.array_equal(m["expert_counts"].numpy(),
                                  rm["expert_counts"]), i
            assert float(m["dropped"]) == 0.0
        want = np.argmax(r[:, -1], -1)
        if i < N_DECODE:
            assert np.array_equal(want[:, None], fed[i])
        assert np.array_equal(greedy(out).numpy()[:, 0], want)
        for again, _ in runs[1:]:
            a, am = again[i]
            assert all(torch.equal(x, y) for x, y in zip(out.shards,
                                                         a.shards))
            assert all(torch.equal(m[k], am[k]) for k in m)
    assert cache["filled"] == S_PROMPT + N_DECODE
    got = gather_to_host(cache)
    for key, want in flat_tree(jc).items():
        if key.endswith("/pos"):
            assert np.array_equal(got[key].numpy(), want), key
        else:
            _close(got[key], want, LOGIT_TOL, f"{kind} cache {key}")
    for _, again in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(
            _states(cache).values(), _states(again).values()))


# ---------------------------------------------------------------------------
# against the home layout
# ---------------------------------------------------------------------------

def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _home_and_mesh(tcfg, mesh, Bc, P, N, *, tp_prefill, seed=11):
    """The home layout's prefill and N decode steps, and the partitioned
    layout's on the same params (f32) and tokens: a partitioned prefill
    (``tp_prefill``), or the home prefill's cache placed and the decode
    steps partitioned from it.  Returns (home outputs, mesh outputs, the
    mesh's cache, its params)."""
    model = Model(tcfg)
    params = {k: v.float() for k, v in flat_tree(model.init(0, "cpu")).items()}
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab, (Bc, P)).astype(
        np.int32))
    fed = [torch.from_numpy(rng.integers(0, tcfg.vocab, (Bc, 1)).astype(
        np.int32)) for _ in range(N)]
    tp, home = _policy(*mesh), _policy(*mesh, rules=False)
    cap = -(-(P + N) // 8) * 8
    hp = unflat_tree({k: v.clone() for k, v in params.items()})
    placed = place_params(unflat_tree(params), tp.mesh, tp.rules)
    home_cache = _f32(model.init_cache(Bc, cap, "cpu"))
    if tp_prefill:
        ref = _serve(model, hp, home_cache, tokens, fed, P, home)
        cache = place_cache(_f32(model.init_cache(Bc, cap, "cpu")), tp.mesh,
                            tp.rules)
        got = _serve(model, placed, cache, tokens, fed, P, tp)
    else:
        first = _serve(model, hp, home_cache, tokens, [], P, home)
        cache = place_cache(_clone(home_cache), tp.mesh, tp.rules)
        ref = first + _serve(model, hp, home_cache, tokens, fed, P, home,
                             prefill=False)
        got = first + _serve(model, placed, cache, tokens, fed, P, tp,
                             prefill=False)
    return ref, got, cache, placed


HOME_CASES = {
    # name: (kind, mesh, B, prompt, decode steps, partitioned prefill, ssm)
    "jamba-B1-2x2": ("jamba", (2, 2), 1, 21, 3, False, {}),
    "mamba2-dstate5-1x4": ("mamba2", (1, 4), 4, 20, 3, True,
                           {"d_state": 5}),
}


@pytest.mark.parametrize("case", list(HOME_CASES))
def test_stack_matches_the_home_layout(case):
    kind, mesh, Bc, P, N, tp_prefill, ssm = HOME_CASES[case]
    _, tcfg = _cfgs(kind, **ssm)
    ref, got, cache, placed = _home_and_mesh(tcfg, mesh, Bc, P, N,
                                             tp_prefill=tp_prefill)
    if Bc == 1:     # the slots split over (data, model): a block each
        k = flat_tree(cache)["blocks/pos2/kv/k"]
        assert k.dims == (2,) and k.grid == (mesh[0] * mesh[1],)
    else:           # in_proj and conv_w whole: 282 and 138 do not divide
        ps = flat_tree(placed)
        for name in ("in_proj", "conv_w", "conv_b"):
            assert not isinstance(ps[f"blocks/pos0/mamba/{name}"],
                                  compat.Sharded), name
        assert isinstance(ps["blocks/pos0/mamba/A_log"], compat.Sharded)
    for i, ((out, m), (r, rm)) in enumerate(zip(got, ref)):
        _close(_whole(out), r, HOME_TOL, f"{case} logits {i}")
        for key in ("dropped", "expert_counts"):
            if key in rm:
                assert torch.equal(m[key], rm[key]), (key, i)


def test_batch_1_prefill_past_the_psum_body_raises():
    """A partitioned B 1 prefill whose T / (n_batch x n_model) reaches 8
    would take the MoE all-to-all body, whose token slices assume rows
    split over the batch axes: it raises (a later item)."""
    _, tcfg = _cfgs("jamba")
    model = Model(tcfg)
    pol = _policy(2, 2)
    params = place_params(model.init(0, "cpu"), pol.mesh, pol.rules)
    cache = place_cache(model.init_cache(1, 32, "cpu"), pol.mesh, pol.rules)
    tok = torch.zeros((1, 32), dtype=torch.int32)
    with use_policy(pol), pytest.raises(NotImplementedError,
                                        match="all-to-all"):
        model.prefill(params, cache, {"tokens": tok})


# ---------------------------------------------------------------------------
# the gated RMSNorm over the whole d_inner
# ---------------------------------------------------------------------------

def test_norm_spans_the_whole_inner_width():
    """The skip term of the first coordinate's heads scaled up 30 times:
    the gated y's mean square over that coordinate's channels is far from
    the mean over all of d_inner (shown on the home layer's own values),
    and the partitioned stack still equals the home layout, so each
    coordinate divides the model group's sum by d_inner."""
    _, tcfg = _cfgs("mamba2")
    model = Model(tcfg)
    params = model.init(0, "cpu")
    Hl = tcfg.ssm.expand * tcfg.d_model // tcfg.ssm.head_dim // 4
    params["blocks"]["pos0"]["mamba"]["D"][:, :Hl] = 30.0
    flat = {k: v.float() for k, v in flat_tree(params).items()}
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab, (B, S_PROMPT))
                              .astype(np.int32))
    # the home layer 0's gated y, before its norm
    tree = unflat_tree(dict(flat))
    lp = index_tree(tree["blocks"]["pos0"], 0)
    x = rmsnorm(lp["mamba_norm"], tree["embed"]["table"][tokens.long()],
                tcfg.rms_eps)
    s, d_inner, H, _ = TS._dims(tcfg)
    z, xBC, dt = TS._split(lp["mamba"], tcfg, x)
    xc = TS._conv_full(lp["mamba"], xBC, s.conv_width)
    x_in, Bm, Cm, dt_sp, A = TS._ssd_inputs(lp["mamba"], tcfg, xc, dt)
    y, _ = kops.ssd_scan(x_in, dt_sp, A, Bm, Cm, chunk=s.chunk)
    y = (y + lp["mamba"]["D"][:, None] * x_in).reshape(B, S_PROMPT, d_inner)
    g = y * F.silu(z)
    whole_ms = g.square().mean(-1)
    local_ms = g[..., :Hl * s.head_dim].square().mean(-1)
    assert float((local_ms / whole_ms).min()) > 2.0
    outs = []
    for rules in (True, False):
        pol = _policy(1, 4, rules)
        p = unflat_tree({k: v.clone() for k, v in flat.items()})
        cache = _f32(model.init_cache(B, CAP, "cpu"))
        if rules:
            p = place_params(p, pol.mesh, pol.rules)
            cache = place_cache(cache, pol.mesh, pol.rules)
        outs.append(_serve(model, p, cache, tokens, [], S_PROMPT, pol))
    _close(outs[0][0][0].gather("cpu"), outs[1][0][0], HOME_TOL, "logits")


# ---------------------------------------------------------------------------
# the step rules on placed state
# ---------------------------------------------------------------------------

def test_restart_and_rollback_on_placed_state():
    _, tcfg = _cfgs("mamba2")
    model = Model(tcfg)
    pol = _policy(2, 2)
    params = place_params(model.init(0, "cpu"), pol.mesh, pol.rules)
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab, (B, 8)).astype(
        np.int32))
    one = tokens[:, :1]

    def fresh():
        return place_cache(_f32(model.init_cache(B, CAP, "cpu")), pol.mesh,
                           pol.rules)
    with use_policy(pol):
        # a one-token step at 0 reads the state it restarts: on a fresh
        # cache and on one a prefill and two steps left, the same bits
        clean, _ = model.prefill(params, fresh(), {"tokens": one})
        clean_states = _states(model.prefill(params, fresh(),
                                             {"tokens": one})[1])
        cache = fresh()
        model.prefill(params, cache, {"tokens": tokens})
        model.decode_step(params, cache, one, 8)
        model.decode_step(params, cache, one, 9)
        before = _states(cache)
        with pytest.raises(ValueError, match="roll back"):
            model.decode_step(params, cache, one, 5)
        with pytest.raises(ValueError, match="gap"):
            model.decode_step(params, cache, one, 11)
        after = _states(cache)
        assert all(torch.equal(before[k], after[k]) for k in before)
        assert cache["filled"] == 10
        again, cache = model.prefill(params, cache, {"tokens": one})
    assert cache["filled"] == 1
    assert all(torch.equal(a, b) for a, b in zip(clean.shards, again.shards))
    states = _states(cache)
    assert all(torch.equal(states[k], clean_states[k]) for k in states)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

# full width on 16: in_proj's column blocks, conv blocks, heads and
# d_inner channels a coordinate (the reference's spec_for)
FULL_BLOCKS = {"mamba2-1.3b": (532, 272, 4, 256),
               "jamba-v0.1-52b": (1048, 528, 8, 512)}


@pytest.mark.parametrize("arch,mesh,device", [
    ("mamba2-1.3b", (1, 4), "cpu"), ("jamba-v0.1-52b", (2, 2), "cpu"),
    ("mamba2-1.3b", (16, 16), "meta"), ("jamba-v0.1-52b", (16, 16), "meta")])
def test_mamba_leaves_follow_reference_spec_for(arch, mesh, device):
    """Every Mamba param and state leaf, and a batch of 1's KV cache
    (slots over (data, model)), placed as the reference's ``spec_for``
    gives it: each coordinate's block is the whole leaf cut by the
    reference's spec (shapes, and on the CPU values)."""
    cfg = get_config(arch) if device == "meta" else get_config(arch).smoke()
    model = Model(cfg)
    params = model.init(0, device) if device == "cpu" else model.init(
        device="meta")
    Bc, cap = (32, 64) if device == "meta" else (4, 24)
    caches = {"": model.init_cache(Bc, cap, device=device)}
    if any(sp.kind == "attn" for sp in cfg.pattern):
        caches["b1/"] = model.init_cache(1, 512 if device == "meta" else 24,
                                         device=device)
    if device == "cpu":
        for c in caches.values():
            for t in flat_tree(c).values():
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    t.copy_(torch.randn(t.shape))
    src = {f"params/{k}": v.clone() for k, v in flat_tree(params).items()}
    axes = {f"params/{k}": v for k, v in logical_axes(
        param_pspecs(params)).items()}
    for pre, c in caches.items():
        src.update({f"cache/{pre}{k}": v.clone()
                    for k, v in flat_tree(c).items()
                    if isinstance(v, torch.Tensor)})
        axes.update({f"cache/{pre}{k}": v for k, v in logical_axes(
            cache_pspecs(c)).items()})
    pol = MeshPolicy(mesh=make_debug_mesh(*mesh, device=device),
                     rules=make_rules(False, fsdp=False))
    placed = {f"params/{k}": v for k, v in flat_tree(
        place_params(params, pol.mesh, pol.rules)).items()}
    for pre, c in caches.items():
        placed.update({f"cache/{pre}{k}": v for k, v in flat_tree(
            place_cache(c, pol.mesh, pol.rules)).items()})
    j_mesh = j_abstract_mesh(mesh, ("data", "model"))
    j_rules = j_make_rules(False, fsdp=False)
    seen = set()
    for key, leaf in placed.items():
        if "/mamba/" not in key and not key.startswith("cache/b1/"):
            continue
        if key.endswith("filled"):
            continue
        spec = tuple(j_spec_for(axes[key], j_rules, j_mesh,
                                tuple(leaf.shape)))
        sh = NamedSharding(pol.mesh, spec)
        assert sh.holds(leaf), (key, spec, leaf)
        seen.add(key.rsplit("/", 1)[-1])
        for co in pol.mesh.coords():
            blk = (leaf.shards[sh.index_at(co)] if not sh.replicated
                   else leaf.value if isinstance(leaf, compat.Replicated)
                   else leaf)
            sl = tuple(slice(*sh.range_at(co, d, n))
                       for d, n in enumerate(leaf.shape))
            assert tuple(blk.shape) == tuple(src[key][sl].shape), key
            if device == "cpu":
                assert torch.equal(blk, src[key][sl]), (key, co)
        if key.startswith("cache/b1/") and key.endswith(("/k", "/v")):
            assert spec[2] == ("data", "model"), (key, spec)
    assert seen >= {
        "in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
        "norm_scale", "out_proj", "conv", "ssm"}
    if device == "meta":
        cols, conv, heads, chans = FULL_BLOCKS[arch]
        pm = {k.rsplit("/", 1)[-1]: v for k, v in placed.items()
              if k.startswith("params/blocks/pos0/mamba/")}
        cm = {k.rsplit("/", 1)[-1]: v for k, v in placed.items()
              if k.startswith("cache/blocks/pos0/mamba/")}
        assert pm["in_proj"].shards[0].shape[-1] == cols
        assert pm["conv_w"].shards[0].shape[-1] == conv
        assert cm["conv"].shards[0].shape[-1] == conv
        assert pm["A_log"].shards[0].shape[-1] == heads
        assert cm["ssm"].shards[0].shape[2] == heads
        assert pm["norm_scale"].shards[0].shape[-1] == chans
        assert pm["out_proj"].shards[0].shape[1] == chans


def test_heads_the_model_axis_does_not_divide_raise():
    """head_dim 64 leaves 2 SSM heads, which the model axis of 4 does not
    divide: the rules keep them whole, and the call raises before any
    work."""
    _, tcfg = _cfgs("mamba2", head_dim=64)
    model = Model(tcfg)
    pol = _policy(1, 4)
    assert dense_layout(tcfg, pol) == "tensor_parallel"
    params = place_params(model.init(0, "cpu"), pol.mesh, pol.rules)
    cache = place_cache(model.init_cache(2, 8, "cpu"), pol.mesh, pol.rules)
    tok = torch.zeros((2, 4), dtype=torch.int32)
    with use_policy(pol), pytest.raises(NotImplementedError,
                                        match="SSM heads"):
        model.prefill(params, cache, {"tokens": tok})
    assert cache["filled"] == 0
