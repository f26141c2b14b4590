"""The port's attention against the reference's, on the same numpy inputs
from a seed: ``attend_blocked`` and ``flash_attention_ref`` on the shapes
of ``tests/test_kernels.py`` (its tolerances: 2e-5 in f32, 2e-2 in bf16,
abs + rel; the two compute the same blocked online softmax, with sums in
other orders), ``kv_pos < 0`` masking and position offsets, the decode
rule the port's ``gqa_forward`` relies on, and the dispatcher's CPU
rule.  The CUDA kernel itself is held against the plain version on the
card by ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.models import attention as JA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.models import attention as TA

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
# tests/test_kernels.py:28-35
SHAPES = [
    (1, 64, 64, 4, 4, 32, True, None, 0.0),      # MHA causal
    (2, 100, 100, 4, 2, 32, True, None, 0.0),    # GQA, ragged seq
    (1, 64, 64, 4, 1, 64, True, None, 0.0),      # MQA
    (1, 96, 96, 2, 2, 32, True, 32, 50.0),       # window + softcap
    (1, 64, 64, 4, 4, 32, False, None, 0.0),     # bidirectional
    (2, 1, 128, 4, 2, 32, True, None, 0.0),      # decode-shaped q
]


def _tol(tdt):
    return dict(rtol=2e-2, atol=2e-2) if tdt == torch.bfloat16 else \
        dict(rtol=2e-5, atol=2e-5)


def _qkv(B, Sq, Sk, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, Sq, H, D), f(B, Sk, Hkv, D), f(B, Sk, Hkv, D)


def _np(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(jnp.asarray(a, jnp.float32)))


@pytest.mark.parametrize("block", [32, 512])
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window,cap", SHAPES)
def test_flash_attention_ref_matches_reference(B, Sq, Sk, H, Hkv, D, causal,
                                               window, cap, jdt, tdt, block):
    q, k, v = _qkv(B, Sq, Sk, H, Hkv, D)
    kw = dict(causal=causal, window=window, logit_softcap=cap, block=block)
    out = TR.flash_attention_ref(*(torch.from_numpy(a).to(tdt)
                                   for a in (q, k, v)), **kw)
    ref = R.flash_attention_ref(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                **kw)
    assert out.dtype == tdt and out.shape == (B, Sq, H, D)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(tdt))


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("window,cap", [(None, 0.0), (24, 30.0)])
def test_attend_blocked_masks_empty_slots_and_takes_offsets(jdt, tdt,
                                                            window, cap):
    """A cache-shaped call: q at positions 40..47, a 96-slot cache whose
    slots 0..47 hold positions 0..47, slots 48..63 are empty (-1) and
    64..95 hold stale positions beyond q's."""
    q, k, v = _qkv(2, 8, 96, 4, 2, 16, seed=1)
    q_pos = np.arange(40, 48, dtype=np.int32)
    kv_pos = np.concatenate([np.arange(48), np.full(16, -1),
                             np.arange(100, 132)]).astype(np.int32)
    kw = dict(causal=True, window=window, logit_softcap=cap, block=32)
    out = TA.attend_blocked(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                            q_pos=torch.from_numpy(q_pos),
                            kv_pos=torch.from_numpy(kv_pos), **kw)
    ref = JA.attend_blocked(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                            q_pos=jnp.asarray(q_pos),
                            kv_pos=jnp.asarray(kv_pos), **kw)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(tdt))


def test_attend_blocked_fully_masked_rows_give_zero():
    q, k, v = _qkv(1, 4, 8, 2, 2, 8)
    out = TA.attend_blocked(*(torch.from_numpy(a) for a in (q, k, v)),
                            q_pos=torch.arange(4, dtype=torch.int32),
                            kv_pos=torch.full((8,), -1, dtype=torch.int32))
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("pos", [0, 5, 30, 47])
def test_decode_rule_equals_masking_the_whole_cache(pos, window):
    """What ``gqa_forward`` does at decode: attention without a mask over
    slots [lo, pos] equals the reference's rule, attention over the whole
    cache masked by its ``pos`` array (slots 0..pos hold positions 0..pos,
    the rest empty or stale)."""
    q, k, v = _qkv(2, 1, 64, 4, 2, 16, seed=2)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kv_pos = torch.cat([torch.arange(pos + 1),
                        torch.full((64 - pos - 1,), -1)]).to(torch.int32)
    kv_pos[pos + 1::2] = 1000                   # stale entries
    full = TA.attend_blocked(tq, tk, tv,
                             q_pos=torch.tensor([pos], dtype=torch.int32),
                             kv_pos=kv_pos, causal=True, window=window,
                             logit_softcap=50.0, block=16)
    lo = max(0, pos + 1 - window) if window is not None else 0
    sliced = ops.flash_attention(tq, tk[:, lo:pos + 1], tv[:, lo:pos + 1],
                                 causal=False, window=None,
                                 logit_softcap=50.0, block=16)
    np.testing.assert_allclose(sliced.numpy(), full.numpy(), rtol=2e-6,
                               atol=2e-6)


def test_ops_flash_attention_takes_the_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 100, 100, 4, 2, 32))
    before = ops.launches().get("flash_attention", 0)
    out = ops.flash_attention(q, k, v, window=32, logit_softcap=50.0)
    assert ops.launches().get("flash_attention", 0) == before
    assert torch.equal(out, TR.flash_attention_ref(q, k, v, window=32,
                                                   logit_softcap=50.0))


def test_ops_flash_attention_force_kernel_on_cpu_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 2, 16))
    with pytest.raises(RuntimeError, match="force='kernel' needs CUDA"):
        ops.flash_attention(q, k, v, force="kernel")
