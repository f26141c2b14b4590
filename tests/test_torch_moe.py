"""The port's MoE FFN inside the transformer (``models/moe.py``) against
the reference's, at phi3.5-MoE's ``smoke()`` scale (d_model 64, 4
experts top-2, expert d_ff 128), with the reference's weights carried
across by ``params_from_numpy`` and the same numpy inputs: the init
tree, ``moe_ffn`` (with and without a shared expert), one layer with a
MoE FFN and ``lm_forward``'s metrics.

Tolerances are ``test_torch_model.py``'s: f32 normwise ``F32_TOL``, with
the routing and ``expert_counts`` exact; bf16 within the reference's own
bf16 noise (``BF16_REL``), plus one bf16 step at the output's largest
magnitude (``2**-7 * max|ref|``): a single FFN's noise does not compound
over layers, and two results that each round to bf16 may differ by one
step of the format (measured: the port's largest difference is exactly
one step, 0.0156 on outputs in [2, 4), against the reference's own
bf16 noise of 0.0119).  One MoE layer fed the same bf16 input routes
identically in both frameworks (its router runs in f32 on equal
inputs), so the bf16 cases hold the routing exactly too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import moe as JMOE
from repro.models import params as JP
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.models.params import Initializer, index_tree, \
    stack_draws, stack_pspecs, tree_from_numpy

ARCH = "phi3.5-moe-42b-a6.6b"
F32_TOL, BF16_REL = 1e-4, 1.0


def _cfgs(shared: bool):
    """The reference's and the port's smoke configs, ``num_shared`` 1 or
    0 (phi3.5 has none; the smoke config keeps ``shared_d_ff`` 128)."""
    j, t = j_get_config(ARCH).smoke(), get_config(ARCH).smoke()
    n = int(shared)
    return (j.replace(moe=dataclasses.replace(j.moe, num_shared=n)),
            t.replace(moe=dataclasses.replace(t.moe, num_shared=n)))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(out, ref, tol, what):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape and np.isfinite(out).all(), what
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


def _close_bf16(out, ref, ref_f32, what):
    out, ref, ref_f32 = _np(out), _np(ref), _np(ref_f32)
    assert out.shape == ref.shape and np.isfinite(out).all(), what
    err, noise = np.abs(out - ref).max(), np.abs(ref - ref_f32).max()
    step = 2.0 ** -7 * np.abs(ref).max()
    assert err <= BF16_REL * noise + step, (
        f"{what}: {err} > {BF16_REL} x {noise} + one bf16 step {step}")


def _moe_params(jcfg, seed=0):
    """The reference's init_moe tree (bf16 experts, f32 router) as
    numpy; the router bias drawn too, so it is not all zeros."""
    tree = JP.unzip(JMOE.init_moe(JP.Initializer(
        jax.random.PRNGKey(seed)), jcfg))[0]
    tree = jax.tree.map(np.asarray, tree)
    tree["b_router"] = np.random.default_rng(seed).standard_normal(
        tree["b_router"].shape).astype(np.float32)
    return tree


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _tree_meta(tree):
    """{path: (shape, dtype name)} of a nested dict of arrays/tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _tree_meta(v).items()})
        else:
            dt = str(v.dtype).replace("torch.", "")
            out[k] = (tuple(v.shape), dt)
    return out


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
def test_init_moe_tree_equals_the_reference(shared):
    jcfg, tcfg = _cfgs(shared)
    ref = _tree_meta(jax.tree.map(np.asarray, JP.unzip(JMOE.init_moe(
        JP.Initializer(jax.random.PRNGKey(0)), jcfg))[0]))
    for device in ("cpu", "meta"):
        ini = Initializer(0, device, dtype=torch.bfloat16)
        assert _tree_meta(TMOE.init_moe(ini, tcfg)) == ref
    assert ref["w_router"][1] == ref["b_router"][1] == "float32"
    assert ("shared.w_gate" in ref) == shared


def test_params_from_numpy_keeps_a_bf16_trees_f32_router():
    tree = _moe_params(_cfgs(False)[0])
    tp = tree_from_numpy(tree, "cpu")
    assert tp["w1"].dtype == torch.bfloat16
    for name in ("w_router", "b_router"):
        assert tp[name].dtype == torch.float32
        assert np.array_equal(tp[name].numpy(), tree[name])


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_moe_ffn_matches_reference(f32, shared):
    """Output, aux_loss, dropped and expert_counts of the reference's
    ``moe_ffn`` (no mesh, no hot set) on a (2, 24, 64) input."""
    jcfg, tcfg = _cfgs(shared)
    tree = _moe_params(jcfg)
    x = np.random.default_rng(1).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    run_j = jax.jit(lambda p, x: JMOE.moe_ffn(p, x, jcfg))

    def ref(tree, dtype):
        p = jax.tree.map(jnp.asarray, tree)
        return run_j(p, jnp.asarray(x, dtype))
    if f32:
        jy, jm = ref(_f32(tree), jnp.float32)
        tp = tree_from_numpy(_f32(tree), "cpu")
        ty, tm = TMOE.moe_ffn(tp, torch.from_numpy(x), tcfg)
        _close(ty, jy, F32_TOL, "moe_ffn f32")
    else:
        jy, jm = ref(tree, jnp.bfloat16)
        jy32, _ = ref(_f32(tree), jnp.float32)
        tp = tree_from_numpy(tree, "cpu")
        ty, tm = TMOE.moe_ffn(tp, torch.from_numpy(x).bfloat16(), tcfg)
        assert ty.dtype == torch.bfloat16
        _close_bf16(ty, jy, jy32, "moe_ffn bf16")
    assert np.array_equal(tm["expert_counts"].numpy(),
                          np.asarray(jm["expert_counts"]))
    assert tm["expert_counts"].dtype == torch.int32
    assert tm["expert_counts"].sum() == 2 * 24 * tcfg.moe.top_k
    np.testing.assert_allclose(float(tm["aux_loss"]), float(jm["aux_loss"]),
                               rtol=1e-5)
    assert float(tm["dropped"]) == float(jm["dropped"]) == 0.0


def test_route_breaks_ties_toward_the_lower_expert_like_lax_top_k():
    """Equal logits: ``jax.lax.top_k`` picks the lower expert id first,
    and so does the port's stable descending sort.  Logits in {0, 1, 2}
    over 8 experts (``x`` the identity, so the logits are ``w``'s rows)
    tie at every rank."""
    w = np.random.default_rng(2).integers(0, 3, (6, 8)).astype(np.float32)
    x = np.eye(6, dtype=np.float32)
    jg, ji, _ = JMOE.route(jnp.asarray(w), jnp.asarray(x), 3)
    tg, ti, _ = TMOE.route(torch.from_numpy(w), torch.from_numpy(x), 3)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    want = np.argsort(-w, axis=1, kind="stable")[:, :3]
    assert np.array_equal(ti.numpy(), want)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)


def test_layer_forward_with_a_moe_ffn_matches_reference():
    jcfg, tcfg = _cfgs(False)
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), JP.unzip(
        JT.init_lm(jax.random.PRNGKey(0), jcfg))[0])
    tp = params_from_numpy(jp, device="cpu")
    spec = jcfg.pattern[0]
    assert spec.ffn == "moe"
    x = np.random.default_rng(4).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    lp_j = jax.tree.map(lambda a: a[1], jp["blocks"]["pos0"])
    ref, _, jmet = jax.jit(lambda p, x: JT.layer_forward(
        p, jcfg, spec, x, jnp.arange(24, dtype=jnp.int32)))(
            lp_j, jnp.asarray(x))
    out, _, tmet = TT.layer_forward(index_tree(tp["blocks"]["pos0"], 1),
                                    tcfg, spec, torch.from_numpy(x), 0)
    _close(out, ref, F32_TOL, "layer_forward")
    assert np.array_equal(tmet["expert_counts"].numpy(),
                          np.asarray(jmet["expert_counts"]))
    np.testing.assert_allclose(float(tmet["aux_loss"]),
                               float(jmet["aux_loss"]), rtol=1e-5)


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
def test_lm_forward_metrics_match_reference(shared):
    """The summed aux_loss, dropped and the (n_periods, E) expert_counts
    of a forward pass; a prefill and a decode step (which skip the aux
    loss) give the same logits bit for bit as ``lm_forward`` with it, and
    counts rows of B*S*K and B*K tokens."""
    jcfg, tcfg = _cfgs(shared)
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), JP.unzip(
        JT.init_lm(jax.random.PRNGKey(0), jcfg))[0])
    tp = params_from_numpy(jp, device="cpu")
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab, (2, 24)).astype(np.int32)
    _, _, jmet = jax.jit(lambda p, t: JT.lm_forward(p, jcfg, t))(
        jp, jnp.asarray(toks))
    t = torch.from_numpy(toks)
    logits, _, tmet = TT.lm_forward(tp, tcfg, t)
    assert sorted(tmet) == sorted(jmet) == ["aux_loss", "dropped",
                                            "expert_counts"]
    counts = tmet["expert_counts"]
    assert counts.shape == (tcfg.n_periods, tcfg.moe.num_experts)
    assert np.array_equal(counts.numpy(), np.asarray(jmet["expert_counts"]))
    assert (counts.sum(1) == 2 * 24 * tcfg.moe.top_k).all()
    np.testing.assert_allclose(float(tmet["aux_loss"]),
                               float(jmet["aux_loss"]), rtol=1e-5)
    assert float(tmet["dropped"]) == float(jmet["dropped"]) == 0.0

    model = Model(tcfg)
    full, cache = TT.lm_forward(tp, tcfg, t, 0, model.init_cache(
        2, 32, device="cpu"))[:2]
    pre, _ = model.prefill(tp, model.init_cache(2, 32, device="cpu"),
                           {"tokens": t})
    assert torch.equal(pre, full)
    a, cache, m = TT.lm_forward(tp, tcfg, t[:, :1], 24, cache=cache)
    cache["filled"] = 24                           # roll back the step
    b, cache = model.decode_step(tp, cache, t[:, :1], 24)
    assert torch.equal(a, b)
    assert float(m["aux_loss"]) > 0.0
    assert (m["expert_counts"].sum(1) == 2 * tcfg.moe.top_k).all()


def test_stacked_init_draws_as_a_list_stack_would():
    """``init_lm`` fills each (n_periods, ...) stack one drawn layer at a
    time; the values equal stacking the list of the same draws."""
    cfg = get_config(ARCH).smoke()
    spec = cfg.pattern[0]
    a, b = (Initializer(3, "cpu", dtype=torch.bfloat16) for _ in range(2))
    got = stack_draws(lambda: TT.init_layer(a, cfg, spec), 3)
    want = stack_pspecs([TT.init_layer(b, cfg, spec) for _ in range(3)])
    flat = lambda t, p="": ([(p, t)] if isinstance(t, torch.Tensor) else
                            [x for k, v in t.items()
                             for x in flat(v, f"{p}.{k}")])
    assert [k for k, _ in flat(got)] == [k for k, _ in flat(want)]
    for (k, g), (_, w) in zip(flat(got), flat(want)):
        assert g.dtype == w.dtype and torch.equal(g, w), k
