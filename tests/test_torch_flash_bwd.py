"""The backward's plain pieces on the CPU: the logsumexp that the
``flash_attention`` kernels write and ``flash_attention_bwd`` reads
(``flash_attention_lse_ref``, log2 units) against ``jax.nn.logsumexp`` of
the logits the reference's ``attend_blocked`` forms, the probabilities it
gives, the head-group planner ``bwd_head_groups`` and the path rule
``bwd_path``.  The kernels themselves run in ``test_torch_cuda.py`` on the
card."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import NEG_INF
from repro.models.layers import dot_f32
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as TR

# (B, Sq, Sk, H, Hkv, D, causal, window, cap): test_torch_cuda.py's
# BWD_SHAPES at the CPU's size (the D 256 cases at 200 rows), and a
# window of 0, where no row sees a key
SHAPES = [(1, 64, 64, 4, 4, 32, True, None, 0.0),
          (2, 100, 100, 4, 2, 32, True, None, 0.0),
          (1, 64, 64, 4, 1, 64, True, None, 0.0),
          (1, 96, 96, 2, 2, 32, True, 32, 50.0),
          (1, 64, 64, 4, 4, 32, False, None, 0.0),
          (2, 1, 128, 4, 2, 32, True, None, 0.0),
          (1, 200, 200, 16, 8, 256, True, 128, 50.0),
          (1, 200, 200, 16, 8, 256, True, 64, 50.0),
          (2, 130, 130, 8, 2, 128, True, None, 0.0),
          (1, 70, 70, 2, 1, 24, True, 16, 30.0),
          (1, 512, 512, 24, 2, 128, True, None, 0.0),
          (2, 200, 200, 16, 16, 64, False, None, 0.0),
          (1, 300, 300, 24, 2, 128, True, None, 0.0),
          (1, 8, 8, 2, 2, 32, True, 0, 0.0)]
LSE_TOL = 1e-5     # natural units, absolute: f32 sums in another order


def _qk(B, Sq, Sk, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, Sq, H, D), f(B, Sk, Hkv, D)


def _reference_logits(q, k, causal, window, cap):
    """The logits of ``attend_blocked``'s step over all keys at once:
    (B, Hkv, G, Sq, Sk), the masked ones NEG_INF; and the mask."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = jnp.asarray(q).reshape(B, Sq, Hkv, H // Hkv, D)
    logits = dot_f32("bshgd,bthd->bhgst", qg, jnp.asarray(k)) / math.sqrt(D)
    if cap:
        logits = cap * jnp.tanh(logits / cap)
    q_pos, kv_pos = jnp.arange(Sq), jnp.arange(Sk)
    mask = jnp.ones((Sq, Sk), bool)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= q_pos[:, None] - kv_pos[None, :] < window
    mask = jnp.broadcast_to(mask, logits.shape)
    return jnp.where(mask, logits, NEG_INF), mask


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window,cap", SHAPES)
def test_lse_ref_is_the_reference_logsumexp(B, Sq, Sk, H, Hkv, D, causal,
                                            window, cap):
    """In log2 units, NEG_INF where a row sees no key (where the
    reference's logsumexp of its NEG_INF logits is NEG_INF too)."""
    q, k = _qk(B, Sq, Sk, H, Hkv, D)
    logits, mask = _reference_logits(q, k, causal, window, cap)
    want = np.asarray(jax.nn.logsumexp(logits, axis=-1)).reshape(B, H, Sq)
    seen = np.asarray(mask.any(axis=-1)).reshape(B, H, Sq)
    got = TR.flash_attention_lse_ref(
        torch.from_numpy(q), torch.from_numpy(k), causal=causal,
        window=window, logit_softcap=cap).numpy()
    assert got.dtype == np.float32 and got.shape == (B, H, Sq)
    assert (got[~seen] == NEG_INF).all() and (want[~seen] == NEG_INF).all()
    np.testing.assert_allclose(got[seen] / TR.LOG2E, want[seen], rtol=0,
                               atol=LSE_TOL)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window,cap", SHAPES)
def test_probabilities_from_the_lse_are_the_reference_softmax(
        B, Sq, Sk, H, Hkv, D, causal, window, cap):
    """P = 2^(s log2(e) - lse2) on visible pairs (the backward's
    formula) is the reference's softmax of its logits; a row that sees no
    key has P = 0 through the mask."""
    q, k = _qk(B, Sq, Sk, H, Hkv, D, seed=1)
    logits, mask = _reference_logits(q, k, causal, window, cap)
    want = np.where(np.asarray(mask), np.asarray(
        jax.nn.softmax(logits, axis=-1)), 0.0)
    lse2 = TR.flash_attention_lse_ref(
        torch.from_numpy(q), torch.from_numpy(k), causal=causal,
        window=window, logit_softcap=cap).numpy()
    G = H // Hkv
    lse2 = lse2.reshape(B, Hkv, G, Sq)[..., None]
    got = np.where(np.asarray(mask), np.exp2(
        np.asarray(logits) * TR.LOG2E - lse2), 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# (B, Hkv, Sk, G): starcoder2-3b's and seamless's training layers, a
# decode-sized one, a prime G, and shapes that fill the card alone
GROUP_SHAPES = [(4, 2, 2048, 12), (4, 16, 1024, 1), (1, 2, 300, 12),
                (1, 8, 6144, 2), (2, 1, 512, 7), (8, 8, 8192, 4),
                (1, 1, 1, 1), (4, 2, 0, 12)]


@pytest.mark.parametrize("B,Hkv,Sk,G", GROUP_SHAPES)
def test_head_groups_divide_g_and_fill_the_card(B, Hkv, Sk, G):
    groups = FA.bwd_head_groups(B, Hkv, Sk, G)
    assert 1 <= groups <= G and G % groups == 0
    blocks = B * Hkv * max(1, -(-Sk // FA.BWD_KEYS))
    if blocks * G >= 2 * FA.SMS:         # some count fills the card:
        assert blocks * groups >= 2 * FA.SMS          # this one does,
        assert all(blocks * d < 2 * FA.SMS            # and none fewer
                   for d in range(1, groups) if G % d == 0)
    else:
        assert groups == G


def test_head_groups_of_the_training_layers():
    """starcoder2-3b at 4 x 2048 (24 / 2 heads): 3 groups of 4, 384
    blocks; seamless's encoder (MHA) one group, no scratch."""
    assert FA.bwd_head_groups(4, 2, 2048, 12) == 3
    assert FA.bwd_head_groups(4, 16, 1024, 1) == 1


@pytest.mark.parametrize("D,dtype,path", [
    (64, torch.bfloat16, "wgmma"), (128, torch.bfloat16, "wgmma"),
    (256, torch.bfloat16, "cuda_cores"), (32, torch.bfloat16, "cuda_cores"),
    (24, torch.bfloat16, "cuda_cores"), (64, torch.float32, "cuda_cores"),
    (128, torch.float32, "cuda_cores")])
def test_bwd_path_rule(D, dtype, path):
    assert FA.bwd_path(D, dtype) == path
    assert path in FA.BWD_PATHS
