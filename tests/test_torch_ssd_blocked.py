"""The ``ssd_scan`` kernel's arithmetic on the CPU: ``ssd_scan_blocked_ref``
(the plain version of what the CUDA kernel computes: chunk-parallel state
increments, a sequential state pass, C.B^T once per group, and every
product from TF32 inputs with the 3xTF32 split) against the JAX package's
``ssd_scan_ref`` and its Pallas kernel in interpret mode.  The kernel
itself runs in ``test_torch_cuda.py`` on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.ssd_scan import ssd_scan_kernel
from repro_torch.kernels import ref as TR

# tests/test_kernels.py:70-75 (B, S, H, P, N, chunk, hblk)
SHAPES = [(1, 32, 4, 8, 16, 8, 4), (2, 48, 8, 16, 32, 16, 4),
          (1, 40, 2, 8, 16, 16, 2), (2, 64, 8, 16, 16, 32, 8)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # tests/test_kernels.py:16-18
STATE_TOL = 1e-3
# a mamba2-1.3b head block: its P, N and chunk, 8 heads, two chunks; y is
# held normwise there, as chip_smoke.py holds the serving shape
MAMBA2_TILE = (1, 512, 8, 64, 128, 256)
NORMWISE = 1e-4


def _inputs(B, S, H, P, N, G, seed=0, init=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(B, S, H, P)
    dt = np.logaddexp(f(B, S, H), 0.0).astype(np.float32)   # softplus
    A = -np.exp(f(H) * 0.5).astype(np.float32)
    Bm, Cm = f(B, S, G, N) * 0.3, f(B, S, G, N) * 0.3
    s0 = f(B, H, P, N) * 0.1 if init else None
    return x, dt, A, Bm, Cm, s0


def _both(arrays, dtype):
    """(jax, torch) versions; x, B and C in ``dtype``, the rest f32."""
    x, dt, A, Bm, Cm, s0 = arrays
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    j = (jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(Bm, jd), jnp.asarray(Cm, jd))
    t = (torch.from_numpy(x).to(td), torch.from_numpy(dt),
         torch.from_numpy(A), torch.from_numpy(Bm).to(td),
         torch.from_numpy(Cm).to(td))
    js0 = None if s0 is None else jnp.asarray(s0)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    return j, js0, t, ts0


def _close(out, ref, tol):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk,hblk", SHAPES)
def test_blocked_ref_matches_reference_and_pallas_kernel(B, S, H, P, N, chunk,
                                                         hblk, dtype):
    j, _, t, _ = _both(_inputs(B, S, H, P, N, 1), dtype)
    yr, fr = R.ssd_scan_ref(*j, chunk)
    yk, fk = ssd_scan_kernel(*j, chunk=chunk, hblk=hblk, interpret=True)
    y, fin = TR.ssd_scan_blocked_ref(*t, chunk)
    assert y.dtype == t[0].dtype and fin.dtype == torch.float32
    for ry, rf in ((yr, fr), (yk, fk)):
        _close(y, ry, TOL[dtype])
        _close(fin, rf, STATE_TOL)


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
def test_blocked_ref_with_two_groups_and_a_ragged_chunk(init):
    """G = 2 (the Pallas kernel takes G = 1 only, so the JAX reference
    alone), S not a multiple of the chunk, with and without a state."""
    j, js0, t, ts0 = _both(_inputs(2, 50, 8, 16, 32, 2, init=init),
                           "float32")
    yr, fr = R.ssd_scan_ref(*j, 16, init_state=js0)
    y, fin = TR.ssd_scan_blocked_ref(*t, 16, init_state=ts0)
    _close(y, yr, TOL["float32"])
    _close(fin, fr, STATE_TOL)


def _mamba2_tile(terms):
    B, S, H, P, N, chunk = MAMBA2_TILE
    j, js0, t, ts0 = _both(_inputs(B, S, H, P, N, 1, seed=3, init=True),
                           "float32")
    yr, fr = R.ssd_scan_ref(*j, chunk, init_state=js0)
    y, fin = TR.ssd_scan_blocked_ref(*t, chunk, init_state=ts0,
                                     tf32_terms=terms)
    yr, fr = np.asarray(yr), np.asarray(fr)
    err = np.abs(y.numpy() - yr).max() / np.abs(yr).max()
    return err, fin, fr


def test_blocked_ref_3xtf32_holds_the_normwise_tolerance_at_mamba2_widths():
    err, fin, fr = _mamba2_tile(terms=3)
    assert err <= NORMWISE, err
    _close(fin, fr, STATE_TOL)


def test_plain_tf32_misses_the_normwise_tolerance_at_mamba2_widths():
    """Why the kernel pays three products a term: one TF32 product keeps
    ~11 bits, and y's 128- and 256-term sums then lie past 1e-4 of max|y|
    from the reference."""
    err, _, _ = _mamba2_tile(terms=1)
    assert err > NORMWISE, err


def test_round_tf32_is_round_to_nearest_ties_away():
    one = 1.0
    vals = torch.tensor([one + 2 ** -11, one + 2 ** -12, one + 3 * 2 ** -12,
                         -(one + 2 ** -11), 0.0, 2.5, -1e-30],
                        dtype=torch.float32)
    want = torch.tensor([one + 2 ** -10, one, one + 2 ** -10,
                         -(one + 2 ** -10), 0.0, 2.5, -1e-30],
                        dtype=torch.float32)
    out = TR.round_tf32(vals)
    assert torch.equal(out[:6], want[:6])
    assert abs(out[6].item() + 1e-30) <= 1e-30 * 2 ** -10
    # bf16 values are exact in TF32: their low halves vanish
    b = torch.randn(1000, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16).float()
    assert torch.equal(TR.round_tf32(b), b)


def test_matmul_tf32_error_by_term_count():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(64, 128, generator=g), torch.randn(128, 64, generator=g)
    exact = (a.double() @ b.double())
    scale = exact.abs().max().item()
    e3 = (TR.matmul_tf32(a, b, 3).double() - exact).abs().max().item()
    e1 = (TR.matmul_tf32(a, b, 1).double() - exact).abs().max().item()
    assert e3 <= 1e-6 * scale
    assert e1 >= 1e-4 * scale
