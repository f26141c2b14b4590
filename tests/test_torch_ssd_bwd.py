"""The ``ssd_scan`` gradient on the CPU: ``ssd_scan_bwd_ref`` (autograd
through the port's ``ssd_scan_ref``, the plain version of the
``ssd_scan_bwd`` kernel) against ``jax.vjp`` of the JAX package's
``ssd_scan_ref``, which is how the reference trains a Mamba layer; and
``ssd_scan_bwd_blocked_ref`` (the kernel's passes, sums and 3xTF32
products in plain PyTorch) against it.  The same numpy inputs, made from a seed, go to
both packages.  The kernel itself runs in ``test_torch_cuda.py`` on the
card.

Every gradient is held normwise: max |got - ref| <= tol x max |ref|.  The
two versions compute the same function with their sums in other orders
(f32, on these cases: the plain version up to 3.1e-6 of the largest
entry from the reference, the blocked one up to 9.5e-6 from the plain,
dA the worst, whose sum over every step and chunk cancels); in bf16 the
gradients dx, dB and dC are rounded to 8 bits (2^-9 of an entry), so a
tie broken the other way is ~4e-3 of the entry (measured up to 1.0e-3
of the largest).  At a mamba2 head block (its widths and chunk) the
gradients are held as the card holds the kernel, normwise within
``SSD_BWD_TOL`` of ``test_torch_cuda.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro_torch.kernels import ref as TR
from repro_torch.kernels.ssd_scan import head_block

# tests/test_kernels.py:70-75 (B, S, H, P, N, chunk)
SHAPES = [(1, 32, 4, 8, 16, 8), (2, 48, 8, 16, 32, 16),
          (1, 40, 2, 8, 16, 16), (2, 64, 8, 16, 16, 32)]
TOL = {"float32": 2e-5, "bfloat16": 1e-2}
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")


def _inputs(B, S, H, P, N, G, seed=0, init=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(B, S, H, P)
    dt = np.logaddexp(f(B, S, H), 0.0).astype(np.float32)   # softplus
    A = -np.exp(f(H) * 0.5).astype(np.float32)
    Bm, Cm = f(B, S, G, N) * 0.3, f(B, S, G, N) * 0.3
    s0 = f(B, H, P, N) * 0.1 if init else None
    dy, dfinal = f(B, S, H, P), f(B, H, P, N)
    return x, dt, A, Bm, Cm, s0, dy, dfinal


def _torch(arrays, dtype, dfinal):
    """The port's arguments: x, B, C and dy in ``dtype``, the rest f32."""
    x, dt, A, Bm, Cm, s0, dy, df = arrays
    td = getattr(torch, dtype)
    t = lambda a, d=torch.float32: None if a is None else \
        torch.from_numpy(a).to(d)
    return (t(x, td), t(dt), t(A), t(Bm, td), t(Cm, td)), dict(
        dy=t(dy, td), dfinal=t(df) if dfinal else None, init_state=t(s0))


def _jax_grads(arrays, dtype, chunk, dfinal):
    """``jax.vjp`` of the reference's ``ssd_scan_ref`` at the same inputs
    and cotangents (a zero ``dfinal`` when it is unused)."""
    x, dt, A, Bm, Cm, s0, dy, df = arrays
    jd = getattr(jnp, dtype)
    args = [jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(Bm, jd), jnp.asarray(Cm, jd)]
    if s0 is not None:
        args.append(jnp.asarray(s0))

    def f(*a):
        return R.ssd_scan_ref(*a[:5], chunk,
                              init_state=a[5] if len(a) > 5 else None)

    @jax.jit
    def grads(cot, *a):
        return jax.vjp(f, *a)[1](cot)
    fin = np.zeros((x.shape[0], x.shape[2], x.shape[3], Bm.shape[3]),
                   np.float32)
    cot = (jnp.asarray(dy, jd), jnp.asarray(df if dfinal else fin))
    grads = [np.asarray(g, np.float32) for g in grads(cot, *args)]
    return grads + [None] * (6 - len(grads))


def _close(got, ref, tol, what):
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * max(scale, 1e-30), \
        f"{what}: max err {err} > {tol} x {scale}"


def _check(got, ref, dtype, tol=TOL):
    """Each gradient against the reference's, with the dtypes the kernel
    returns: dx, dB, dC in x's dtype, the rest f32."""
    tdt = getattr(torch, dtype)
    for name, g, r in zip(NAMES, got, ref):
        if r is None:
            assert g is None, name
            continue
        want = tdt if name in ("dx", "dB", "dC") else torch.float32
        assert g.dtype == want, (name, g.dtype)
        _close(g, r, tol[dtype], name)


CASES = [(shape, 1, False, df) for shape in SHAPES for df in (False, True)]
CASES += [((2, 50, 8, 16, 32, 16), 2, True, True),     # G = 2, ragged, init
          ((1, 37, 6, 8, 16, 16), 3, False, True),     # G = 3, ragged
          ((2, 40, 4, 8, 16, 16), 1, True, False)]     # ragged, init
IDS = [f"B{s[0]}-S{s[1]}-H{s[2]}-P{s[3]}-N{s[4]}-Q{s[5]}-G{g}"
       f"{'-init' if i else ''}{'-dfinal' if d else ''}"
       for s, g, i, d in CASES]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,G,init,dfinal", CASES, ids=IDS)
def test_plain_gradient_matches_the_reference(shape, G, init, dfinal, dtype):
    B, S, H, P, N, chunk = shape
    arrays = _inputs(B, S, H, P, N, G, init=init)
    args, kw = _torch(arrays, dtype, dfinal)
    got = TR.ssd_scan_bwd_ref(*args, chunk, **kw)
    _check(got, _jax_grads(arrays, dtype, chunk, dfinal), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,G,init,dfinal", CASES, ids=IDS)
def test_blocked_gradient_matches_the_plain_one(shape, G, init, dfinal,
                                                dtype):
    B, S, H, P, N, chunk = shape
    args, kw = _torch(_inputs(B, S, H, P, N, G, seed=1, init=init), dtype,
                      dfinal)
    got = TR.ssd_scan_bwd_blocked_ref(*args, chunk, **kw)
    ref = TR.ssd_scan_bwd_ref(*args, chunk, **kw)
    _check(got, [None if r is None else r.float().numpy() for r in ref],
           dtype)


def test_padded_steps_contribute_nothing():
    """A ragged last chunk: the gradients of the first S steps equal
    those of the same steps padded by hand to a whole chunk with dt = x =
    B = C = dy = 0 (the padded steps' own gradients are not returned)."""
    B, S, H, P, N, G, chunk = 1, 40, 4, 8, 16, 1, 16
    args, kw = _torch(_inputs(B, S, H, P, N, G, seed=2, init=True),
                      "float32", True)
    pad = lambda t: torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 2) + (0, 48 - S))
    padded = [pad(a) if a.dim() > 1 else a for a in args]
    got = TR.ssd_scan_bwd_blocked_ref(*args, chunk, **kw)
    full = TR.ssd_scan_bwd_blocked_ref(*padded, chunk, **{**kw,
                                                          "dy": pad(kw["dy"])})
    for name, g, f in zip(NAMES, got, full):
        f = f[:, :S] if name in ("dx", "ddt", "dB", "dC") else f
        torch.testing.assert_close(g, f, rtol=1e-6, atol=1e-6,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("fn", ["plain", "blocked"])
def test_gradients_do_not_depend_on_the_chunk(fn):
    """The twin of ``test_kernels.py::test_ssd_scan_chunk_invariance``
    for the gradient: the chunk is a tiling choice."""
    f = TR.ssd_scan_bwd_ref if fn == "plain" else TR.ssd_scan_bwd_blocked_ref
    args, kw = _torch(_inputs(1, 64, 4, 8, 16, 1, seed=4, init=True),
                      "float32", True)
    a = f(*args, 8, **kw)
    b = f(*args, 32, **kw)
    for name, x, y in zip(NAMES, a, b):
        _close(x, y.numpy(), TOL["float32"], name)


# a mamba2-1.3b head block: its P, N and chunk, 8 heads (one block of the
# kernel's), two chunks, an initial state and a final-state cotangent (as
# test_torch_ssd_blocked.py's MAMBA2_TILE for the forward)
MAMBA2_BLOCK = (1, 512, 8, 64, 128, 256)
# SSD_BWD_TOL of test_torch_cuda.py and chip_smoke.py: at these widths
# the running sums of dt A reach -342 over a chunk, and the two plain f32
# versions (PyTorch's and XLA's on the CPU) already differ by 2.3e-5 of
# the largest entry (ddt), past the small shapes' 2e-5
MAMBA2_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


@functools.lru_cache(maxsize=None)
def _mamba2_block(dtype):
    """The case's arguments, ``jax.vjp`` of the reference's
    ``ssd_scan_ref`` and the plain gradient, computed once per dtype."""
    B, S, H, P, N, chunk = MAMBA2_BLOCK
    arrays = _inputs(B, S, H, P, N, 1, seed=3, init=True)
    args, kw = _torch(arrays, dtype, True)
    plain = TR.ssd_scan_bwd_ref(*args, chunk, **kw)
    return args, kw, _jax_grads(arrays, dtype, chunk, True), plain


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gradient_at_a_mamba2_head_block(dtype):
    _, _, jax_grads, plain = _mamba2_block(dtype)
    _check(plain, jax_grads, dtype, MAMBA2_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("against", ["plain", "jax"])
def test_blocked_gradient_at_a_mamba2_head_block(dtype, against):
    """The kernel's arithmetic (3xTF32 products, C.B^T once for the 8
    heads, dB and dC summed over the head block) against the plain
    gradient and the reference's."""
    args, kw, jax_grads, plain = _mamba2_block(dtype)
    got = TR.ssd_scan_bwd_blocked_ref(*args, MAMBA2_BLOCK[-1], **kw,
                                      hblk=head_block(MAMBA2_BLOCK[2]))
    ref = jax_grads if against == "jax" else [r.float().numpy()
                                              for r in plain]
    _check(got, ref, dtype, MAMBA2_TOL)


def test_plain_tf32_misses_the_tolerance_at_a_mamba2_head_block():
    """Why the kernel splits its f32 operands: with one TF32 product a
    term (~11 bits) every gradient lies past 1e-4 of its largest entry
    from the plain version (measured 3.6e-4 to 8.5e-3, dA the worst)."""
    args, kw, _, plain = _mamba2_block("float32")
    got = TR.ssd_scan_bwd_blocked_ref(*args, MAMBA2_BLOCK[-1], **kw,
                                      hblk=head_block(MAMBA2_BLOCK[2]),
                                      tf32_terms=1)
    for name, g, r in zip(NAMES, got, plain):
        err = (g - r).abs().max() / r.abs().max()
        assert err > MAMBA2_TOL["float32"], (name, float(err))


@pytest.mark.parametrize("rep,hblk", [(1, 1), (2, 2), (3, 3), (6, 6),
                                      (7, 7), (9, 3), (12, 6), (16, 8),
                                      (64, 8), (128, 8)])
def test_head_block_is_the_largest_divisor_up_to_8(rep, hblk):
    """The heads a block of the kernel's triangle covers (the forward's
    rule, ``ssd_scan.cu``), which also sizes the dB / dC share scratch."""
    assert head_block(rep) == hblk


def test_blocked_gradient_sums_by_any_head_block_and_rejects_others():
    """dB and dC summed by blocks of 1, 2 or 4 of a group's 4 heads agree
    within f32 rounding (only the order of the sums differs); a block
    that does not divide H/G is refused."""
    args, kw = _torch(_inputs(1, 48, 8, 16, 32, 2, seed=5, init=True),
                      "float32", True)
    one = TR.ssd_scan_bwd_blocked_ref(*args, 16, **kw)
    for hblk in (2, 4):
        got = TR.ssd_scan_bwd_blocked_ref(*args, 16, **kw, hblk=hblk)
        for name, g, r in zip(NAMES, got, one):
            _close(g, r.numpy(), TOL["float32"], name)
    with pytest.raises(ValueError):
        TR.ssd_scan_bwd_blocked_ref(*args, 16, **kw, hblk=3)
