"""phi3.5-MoE partitioned over a mesh (``models/moe.py::moe_ffn_tp`` in
``distributed/tensor_parallel.py``'s loop) on CPU debug meshes, with
inputs made by numpy from a seed and the reference's weights carried
across by ``tree_from_numpy``:

* against the reference: phi3.5's smoke stack at capacity factor 4 (so
  the expert-parallel bodies drop nothing) does a prefill of 40 and 4
  greedy decode steps on (2, 2) and (1, 4) meshes, against the
  reference's single-device ``Model.prefill`` / ``decode_step`` and its
  ``lm_forward`` metrics in process: logits within ``LOGIT_TOL`` = 1e-4
  of max |ref| in f32, ``expert_counts`` equal, a decode step's
  ``aux_loss`` within 1e-4 (a prefill's is the mean over the token
  shards, the reference's mesh semantics, which one device does not
  compute); the same with a shared
  expert (``num_shared=1``); on the (2, 2) mesh a second call equal to
  the first bit for bit, metrics included;
* against the home layout (a policy without rules, whose
  ``moe_ffn_sharded`` runs the same bodies on the global batch): the
  smoke stack with phi3.5's 16 experts at the default capacity factor
  1.25, and a router bias that sends every token to expert 0, so that
  both bodies drop: a prefill (the all-to-all body) and decode steps of
  B 18, which the 4 token shards do not divide (the psum body), logits
  within ``HOME_TOL`` = 1e-5, ``dropped`` and ``expert_counts`` equal
  exactly, ``dropped`` > 0, ``aux_loss`` within 1e-5;
* every expert leaf placed as the reference's ``spec_for`` gives it, at
  smoke scale on the CPU and at full width on a 16 x 16 ``meta`` mesh
  (one expert a coordinate there), and a rule table that puts the
  experts elsewhere than the model axis raising ``NotImplementedError``.
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
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro.models.params import unzip
from repro_torch.configs import get_config
from repro_torch.distributed import compat
from repro_torch.distributed.meshctx import MeshPolicy, use_policy
from repro_torch.distributed.sharding import (NamedSharding, dense_layout,
                                              logical_axes, make_rules,
                                              param_pspecs, place_cache,
                                              place_params)
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.model import Model, greedy, params_from_numpy
from repro_torch.models.params import flat_tree, unflat_tree

ARCH = "phi3.5-moe-42b-a6.6b"
LOGIT_TOL, HOME_TOL = 1e-4, 1e-5
MESHES = [(2, 2), (1, 4)]
B, S_PROMPT, N_DECODE = 4, 40, 4


def _policy(n_data, n_model, rules=True):
    return MeshPolicy(mesh=make_debug_mesh(n_data, n_model, device="cpu"),
                      rules=make_rules(False, fsdp=False) if rules else None)


def _cfgs(capacity=None, shared=0, experts=None):
    """The reference's and the port's phi3.5 smoke configs with the MoE
    fields replaced where given."""
    out = []
    for c in (j_get_config(ARCH).smoke(), get_config(ARCH).smoke()):
        kw = {"num_shared": shared}
        if capacity is not None:
            kw["capacity_factor"] = capacity
        if experts is not None:
            kw["num_experts"] = experts
        out.append(c.replace(moe=dataclasses.replace(c.moe, **kw)))
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
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    ref = ref.float().numpy() if isinstance(ref, torch.Tensor) else \
        np.asarray(jnp.asarray(ref, jnp.float32))
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _serve(model, params, cache, tokens, fed, P, pol):
    """A prefill and one decode step a fed token under ``pol``: the
    logits and metrics of each call."""
    with use_policy(pol):
        logits, cache, m = model.prefill(params, cache, {"tokens": tokens},
                                         with_metrics=True)
        outs = [(logits, m)]
        for step, tok in enumerate(fed):
            logits, cache, m = model.decode_step(params, cache, tok, P + step,
                                                 with_metrics=True)
            outs.append((logits, m))
    return outs


def _whole(logits):
    return logits.gather("cpu") if isinstance(logits, compat.Sharded) \
        else logits


_REFERENCE = {}


def _reference(shared):
    """The reference's prefill and greedy decode on one device (f32
    params and cache), with each call's metrics from its ``lm_forward``
    (its ``prefill`` / ``decode_step`` discard them)."""
    if shared in _REFERENCE:
        return _REFERENCE[shared]
    jcfg, tcfg = _cfgs(capacity=4.0, shared=shared)
    jm = JModel(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      unzip(jm.init(jax.random.PRNGKey(0)))[0])
    tokens = np.random.default_rng(7).integers(
        0, jcfg.vocab, (B, S_PROMPT)).astype(np.int32)
    cap = S_PROMPT + N_DECODE
    cache = _f32(unzip(jm.init_cache(B, cap))[0])
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
    _REFERENCE[shared] = (tcfg, jax.tree.map(np.asarray, jp), tokens, cap,
                          outs, fed)
    return _REFERENCE[shared]


@pytest.mark.parametrize("mesh,shared", [((2, 2), 0), ((1, 4), 0),
                                         ((2, 2), 1)])
def test_stack_prefill_and_decode_match_reference(mesh, shared):
    tcfg, jp, tokens, cap, ref, fed = _reference(shared)
    model = Model(tcfg)
    pol = _policy(*mesh)
    assert dense_layout(tcfg, pol) == "tensor_parallel"
    params = place_params(params_from_numpy(jp, "cpu"), pol.mesh, pol.rules)
    runs = []
    for _ in range(2 if mesh == (2, 2) else 1):   # call == call on one
        cache = place_cache(_f32(model.init_cache(B, cap, "cpu")),
                            pol.mesh, pol.rules)
        runs.append(_serve(model, params, cache, torch.from_numpy(tokens),
                           [torch.from_numpy(t) for t in fed], S_PROMPT,
                           pol))
    for i, ((out, m), (r, rm)) in enumerate(zip(runs[0], ref)):
        assert isinstance(out, compat.Sharded) and out.grid == mesh
        _close(out.gather("cpu"), r, LOGIT_TOL, f"logits {i}")
        assert m["expert_counts"].dtype == torch.int32
        assert np.array_equal(m["expert_counts"].numpy(),
                              rm["expert_counts"]), i
        assert float(m["dropped"]) == 0.0
        if i:       # the psum body routes all T tokens, as one device
            np.testing.assert_allclose(float(m["aux_loss"]),
                                       float(rm["aux_loss"]), rtol=1e-4)
        want = np.argmax(r[:, -1], -1)
        if i < N_DECODE:
            assert np.array_equal(want[:, None], fed[i])
        assert np.array_equal(greedy(out).numpy()[:, 0], want)
        for again in runs[1:]:
            a, am = again[i]
            assert all(torch.equal(x, y) for x, y in zip(out.shards,
                                                         a.shards))
            assert all(torch.equal(m[k], am[k]) for k in m)


# ---------------------------------------------------------------------------
# against the home layout, with drops
# ---------------------------------------------------------------------------

HOME_CASES = {
    # name: (mesh, B, prompt, decode steps); B * prompt splits into the
    # 4 token shards (all-to-all), B = 18 at decode does not (psum)
    "prefill-2x2": ((2, 2), 4, 40, 0),
    "prefill-1x4": ((1, 4), 4, 40, 0),
    "decode-2x2-B18": ((2, 2), 18, 8, 2),
}


@pytest.mark.parametrize("case", list(HOME_CASES))
def test_stack_matches_the_home_layout_where_it_drops(case):
    mesh, Bc, P, N = HOME_CASES[case]
    _, tcfg = _cfgs(experts=16)
    assert tcfg.moe.capacity_factor == 1.25
    model = Model(tcfg)
    params = model.init(0, "cpu")
    for i in range(tcfg.n_periods):        # every token to expert 0
        params["blocks"]["pos0"]["ffn"]["b_router"][i, 0] = 8.0
    params = {k: v.float() for k, v in flat_tree(params).items()}
    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab, (Bc, P)).astype(
        np.int32))
    fed = [torch.from_numpy(rng.integers(0, tcfg.vocab, (Bc, 1)).astype(
        np.int32)) for _ in range(N)]
    runs = []
    for rules in (True, False):
        pol = _policy(*mesh, rules=rules)
        cache = _f32(model.init_cache(Bc, P + N, "cpu"))
        p = unflat_tree({k: v.clone() for k, v in params.items()})
        if rules:
            p = place_params(p, pol.mesh, pol.rules)
            cache = place_cache(cache, pol.mesh, pol.rules)
        runs.append(_serve(model, p, cache, tokens, fed, P, pol))
    dropped = 0.0
    for i, ((out, m), (ref, rm)) in enumerate(zip(*runs)):
        _close(_whole(out), ref, HOME_TOL, f"{case} logits {i}")
        assert torch.equal(m["expert_counts"], rm["expert_counts"]), i
        assert float(m["dropped"]) == float(rm["dropped"]), i
        np.testing.assert_allclose(float(m["aux_loss"]),
                                   float(rm["aux_loss"]), rtol=1e-5)
        dropped += float(m["dropped"])
        if i:                               # a decode step drops too
            assert float(m["dropped"]) > 0, i
    assert dropped > 0


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,device", [((2, 2), "cpu"), ((1, 4), "cpu"),
                                         ((16, 16), "meta")])
def test_expert_leaves_follow_reference_spec_for(mesh, device):
    cfg = get_config(ARCH) if device == "meta" else get_config(ARCH).smoke()
    params = Model(cfg).init(0, device) if device == "cpu" else \
        Model(cfg).init(device="meta")
    whole = {k: v.clone() for k, v in flat_tree(params).items()}
    axes = logical_axes(param_pspecs(params))
    pol = MeshPolicy(mesh=make_debug_mesh(*mesh, device=device),
                     rules=make_rules(False, fsdp=False))
    placed = flat_tree(place_params(params, pol.mesh, pol.rules))
    j_mesh = j_abstract_mesh(mesh, ("data", "model"))
    j_rules = j_make_rules(False, fsdp=False)
    E = cfg.moe.num_experts
    seen = set()
    for key, leaf in placed.items():
        name = key.rsplit("/", 1)[-1]
        if name not in ("w1", "w3", "w2", "w_router", "b_router"):
            continue
        seen.add(name)
        spec = tuple(j_spec_for(axes[key], j_rules, j_mesh,
                                tuple(leaf.shape)))
        sh = NamedSharding(pol.mesh, spec)
        assert sh.holds(leaf), (key, spec, leaf)
        if name in ("w1", "w3", "w2"):
            # experts over model, each coordinate E / n_model whole ones
            assert spec == (None, "model"), (key, spec)
        for c in pol.mesh.coords():
            blk = (leaf.shards[sh.index_at(c)] if not sh.replicated
                   else leaf.value if isinstance(leaf, compat.Replicated)
                   else leaf)
            sl = tuple(slice(*sh.range_at(c, d, n))
                       for d, n in enumerate(leaf.shape))
            assert tuple(blk.shape) == tuple(whole[key][sl].shape), key
            if name != "b_router" and blk.dim() == 4:
                assert blk.shape[1] == E // mesh[1]
            if device == "cpu":
                assert torch.equal(blk, whole[key][sl]), (key, c)
    assert seen == {"w1", "w3", "w2", "w_router", "b_router"}


@pytest.mark.parametrize("where", [("data",), ()])
def test_experts_placed_elsewhere_raise(where):
    """A rule table that splits the experts over the data axis, or keeps
    them whole (the MLP columns then take the model axis), is not the
    partitioned MoE body's layout: the call raises before any work."""
    model = Model(get_config(ARCH).smoke())
    rules = {**make_rules(False, fsdp=False), "experts": where}
    pol = MeshPolicy(mesh=make_debug_mesh(2, 2, device="cpu"), rules=rules)
    params = place_params(model.init(0, "cpu"), pol.mesh, rules)
    cache = place_cache(model.init_cache(2, 8, "cpu"), pol.mesh, rules)
    tok = torch.zeros((2, 4), dtype=torch.int32)
    with use_policy(pol), pytest.raises(NotImplementedError,
                                        match="experts"):
        model.prefill(params, cache, {"tokens": tok})
