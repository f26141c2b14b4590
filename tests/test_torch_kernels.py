"""The port's kernel layer against the reference's, on the same numpy
inputs: the plain PyTorch ``hot_gather`` / ``onehot_lookup`` against the
Pallas kernel in interpret mode and the jnp oracles (atol=0, f32 and
bf16) and the dispatcher's device rule.  The hand-written CUDA kernel
itself is tested on the card by ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.hot_gather import hot_gather_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
SHAPES = [(64, 16, 4, 32), (512, 64, 8, 100), (128, 32, 1, 7)]


def _inputs(V, D, Hn, T, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    hot_ids = rng.choice(V, Hn, replace=False).astype(np.int32)
    idx = rng.integers(0, V, T).astype(np.int32)
    return table, hot_ids, idx


def _both(table, hot_ids, idx, jdt, tdt):
    """Reference (interpret-mode kernel, oracle) and port outputs, as
    float32 numpy arrays (bf16 widens exactly)."""
    jt = jnp.asarray(table, jdt)
    jh = jnp.asarray(hot_ids)
    ji = jnp.asarray(idx)
    jrows = jnp.take(jt, jh, axis=0)
    kern = hot_gather_kernel(jt, jrows, jh, ji, interpret=True)
    oracle = R.hot_gather_ref(jt, jrows, jh, ji)
    tt = torch.from_numpy(table).to(tdt)
    th = torch.from_numpy(hot_ids)
    out = TR.hot_gather_ref(tt, tt.index_select(0, th), th,
                            torch.from_numpy(idx))
    as_np = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    return as_np(kern), as_np(oracle), out.float().numpy()


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("V,D,Hn,T", SHAPES)
def test_hot_gather_plain_matches_pallas(V, D, Hn, T, jdt, tdt):
    table, hot_ids, idx = _inputs(V, D, Hn, T)
    kern, oracle, port = _both(table, hot_ids, idx, jdt, tdt)
    np.testing.assert_array_equal(port, kern)
    np.testing.assert_array_equal(port, oracle)
    # exactness: a plain gather
    np.testing.assert_array_equal(
        port, torch.from_numpy(table).to(tdt)[torch.from_numpy(idx)]
        .float().numpy())


def test_hot_gather_all_hot_and_all_cold():
    rng = np.random.default_rng(1)
    table = rng.standard_normal((32, 8)).astype(np.float32)
    hot_ids = np.asarray([1, 2, 3], np.int32)
    for idx in (np.asarray([1, 2, 3, 1, 2], np.int32),
                np.asarray([9, 10, 11], np.int32)):
        kern, _, port = _both(table, hot_ids, idx, jnp.float32,
                              torch.float32)
        np.testing.assert_array_equal(port, kern)
        np.testing.assert_array_equal(port, table[idx])


def test_hot_gather_out_of_range_ids_clamp_like_the_tpu_kernel():
    """Out-of-range ids: the TPU kernel clamps cold ids to [0, V-1];
    ``jnp.take`` would fill NaN and ``index_select`` would raise.  The
    port's plain version (and its CUDA kernel) clamp like the kernel."""
    rng = np.random.default_rng(2)
    table = rng.standard_normal((16, 8)).astype(np.float32)
    hot_ids = np.asarray([3, 5], np.int32)
    idx = np.asarray([-4, 3, 16, 40, 5, 0], np.int32)
    kern, _, port = _both(table, hot_ids, idx, jnp.float32, torch.float32)
    np.testing.assert_array_equal(port, kern)
    np.testing.assert_array_equal(port, table[np.clip(idx, 0, 15)])


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
def test_onehot_lookup_plain_matches_reference(jdt, tdt):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((24, 16)).astype(np.float32)
    idx = rng.integers(0, 24, 40).astype(np.int32)
    want = R.onehot_lookup_ref(jnp.asarray(table, jdt), jnp.asarray(idx))
    got = ops.onehot_lookup(torch.from_numpy(table).to(tdt),
                            torch.from_numpy(idx))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jnp.asarray(want, jnp.float32)))


def test_dispatcher_cpu_takes_plain_version():
    table, hot_ids, idx = (torch.from_numpy(a) for a in _inputs(64, 16, 4,
                                                                 32))
    rows = table.index_select(0, hot_ids)
    ops.reset_launches()
    out = ops.hot_gather(table, rows, hot_ids, idx)
    assert torch.equal(out, TR.hot_gather_ref(table, rows, hot_ids, idx))
    assert ops.launches() == {}


def test_dispatcher_force_kernel_on_cpu_raises():
    table, hot_ids, idx = (torch.from_numpy(a) for a in _inputs(64, 16, 4,
                                                                 32))
    rows = table.index_select(0, hot_ids)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.hot_gather(table, rows, hot_ids, idx, force="kernel")
    with pytest.raises(ValueError):
        ops.hot_gather(table, rows, hot_ids, idx, force="interpret")
