"""The split-K decode's arithmetic on the CPU: ``flash_attention_split_ref``
(the plain version of what the decode kernel computes: per-split f32
partials ``(m, l, acc)`` combined in split order) against the port's
``flash_attention_ref`` and the JAX package's, the split planner
``decode_splits``, the kernels' softcap formula, and the wrapper's path
rule.  The kernels themselves run in ``test_torch_cuda.py`` on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as TR

# (B, Sq, Sk, H, Hkv, D): decode-shaped (G * Sq <= 64)
SHAPES = [(2, 1, 128, 4, 2, 32), (2, 1, 300, 16, 8, 64),
          (1, 4, 1000, 8, 2, 16), (2, 3, 65, 4, 4, 8)]
# (causal, window, cap): the reference decode case sees only key 0
MASKS = [(True, None, 0.0), (False, None, 0.0), (False, 100, 50.0),
         (True, 40, 30.0)]


def _qkv(B, Sq, Sk, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, Sq, H, D), f(B, Sk, Hkv, D), f(B, Sk, Hkv, D)


def _splits(Sk):
    tiles = -(-Sk // TR.SPLIT_TILE)
    return sorted({1, 3, 17, tiles})


@pytest.mark.parametrize("causal,window,cap", MASKS)
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D", SHAPES)
def test_split_ref_equals_flash_attention_ref(B, Sq, Sk, H, Hkv, D, causal,
                                              window, cap):
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, Sq, Sk, H, Hkv, D))
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    ref = TR.flash_attention_ref(q, k, v, **kw)
    for splits in _splits(Sk):
        out = TR.flash_attention_split_ref(q, k, v, splits=splits, **kw)
        assert out.shape == ref.shape and out.dtype == ref.dtype
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_split_ref_with_splits_that_see_no_key():
    """More splits than tiles (empty ranges), splits wholly past the
    causal diagonal, and rows that see no key at all (-> 0)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 200, 4, 2, 16))
    for kw in (dict(causal=True), dict(causal=False, window=0),
               dict(causal=False)):
        ref = TR.flash_attention_ref(q, k, v, **kw)
        for splits in (4, 9, 50):
            out = TR.flash_attention_split_ref(q, k, v, splits=splits, **kw)
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    out = TR.flash_attention_split_ref(q, k, v, splits=3, causal=True,
                                       window=0)
    assert torch.equal(out, torch.zeros_like(out))
    out = TR.flash_attention_split_ref(q, k[:, :0], v[:, :0], splits=1)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("tdt,jdt,tol", [(torch.float32, jnp.float32, 2e-5),
                                         (torch.bfloat16, jnp.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,window,cap", MASKS)
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D", SHAPES[:2])
def test_split_ref_matches_the_reference(B, Sq, Sk, H, Hkv, D, causal,
                                         window, cap, tdt, jdt, tol):
    arrs = _qkv(B, Sq, Sk, H, Hkv, D, seed=1)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    splits = FA.decode_splits(B, Hkv, Sk)[0]
    out = TR.flash_attention_split_ref(
        *(torch.from_numpy(a).to(tdt) for a in arrs), splits=splits, **kw)
    ref = R.flash_attention_ref(*(jnp.asarray(a, jdt) for a in arrs), **kw)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jnp.asarray(ref, jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("Sk", [0, 1, 63, 64, 65, 4096, 6176])
@pytest.mark.parametrize("B,Hkv", [(2, 8), (1, 1), (4, 32), (2, 2)])
def test_decode_splits_cover_the_keys_once(B, Hkv, Sk):
    splits, n = FA.decode_splits(B, Hkv, Sk)
    assert splits >= 1 and n >= 1 and n % TR.SPLIT_TILE == 0
    seen = np.zeros(Sk, dtype=int)
    for s in range(splits):
        lo, hi = min(s * n, Sk), min((s + 1) * n, Sk)
        assert lo < hi or Sk == 0        # no split past the keys
        seen[lo:hi] += 1
    assert (seen == 1).all()
    tiles = -(-Sk // TR.SPLIT_TILE)
    assert splits <= max(1, tiles)
    if tiles >= 2 * FA.SMS:              # enough tiles: >= 2 blocks an SM
        assert B * Hkv * splits >= 2 * FA.SMS


def test_decode_splits_of_gemma2_decode():
    # batch 2 x 8 kv heads over the 6176-slot cache and the 4096 window
    assert FA.decode_splits(2, 8, 6176) == (17, 384)
    assert FA.decode_splits(2, 8, 4096) == (16, 256)


@pytest.mark.parametrize("cap", [50.0, 30.0, 1.0])
def test_softcap_formula_stays_within_2e_6_cap_of_tanh(cap):
    x = torch.cat([torch.linspace(-1e3, 1e3, 400_001),
                   torch.tensor([float("inf"), -float("inf"), -1e30, 1e30,
                                 0.0, -0.0, 1e-30])])
    got = TR.softcap_exp2(x, cap).double()
    want = cap * torch.tanh(x.double() / cap)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2e-6 * cap
    assert got[-7].item() == cap and got[-6].item() == -cap
    assert got[-5].item() == -cap


@pytest.mark.parametrize("Sq,H,Hkv,D,dtype,path", [
    (1, 16, 8, 256, torch.bfloat16, "split_k_decode"),
    (4, 16, 2, 128, torch.float32, "split_k_decode"),
    (64, 4, 4, 32, torch.bfloat16, "split_k_decode"),
    (65, 4, 4, 32, torch.bfloat16, "mma_sync"),
    (6144, 16, 8, 256, torch.bfloat16, "wgmma_prefill"),
    (64, 4, 1, 64, torch.bfloat16, "wgmma_prefill"),
    (130, 8, 2, 128, torch.bfloat16, "wgmma_prefill"),
    (70, 2, 1, 24, torch.bfloat16, "mma_sync"),
    (100, 4, 2, 256, torch.float32, "f32")])
def test_path_rule(Sq, H, Hkv, D, dtype, path):
    assert FA.choose_path(Sq, H, Hkv, D, dtype) == path
