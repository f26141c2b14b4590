"""Tests of the port that need a CUDA card (the CUDA kernels have no CPU
mode); they skip without one.  This file imports no JAX, so it also runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR

SHAPES = [(64, 16, 4, 32), (512, 64, 8, 100), (128, 32, 1, 7),
          (32064, 4096, 32, 512),
          # every access width: 12-byte f32 rows, 10-byte bf16 rows
          (40, 3, 5, 64), (40, 5, 5, 64),
          # a hot set of many ballot steps
          (8192, 8, 4000, 300),
          (16, 8, 2, 0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(V, D, Hn, T, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(
        np.float32)).to(device=device, dtype=dtype)
    hot_ids = torch.from_numpy(rng.choice(V, Hn, replace=False).astype(
        np.int32)).to(device)
    idx = torch.from_numpy(rng.integers(0, V, T).astype(np.int32)).to(device)
    return table, hot_ids, idx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V,D,Hn,T", SHAPES)
def test_hot_gather_kernel_equals_plain_and_index_select(cuda, V, D, Hn, T,
                                                         dtype):
    table, hot_ids, idx = _inputs(V, D, Hn, T, dtype, cuda)
    rows = table.index_select(0, hot_ids)
    before = ops.launches().get("hot_gather", 0)
    out = ops.hot_gather(table, rows, hot_ids, idx)
    torch.cuda.synchronize()
    assert ops.launches().get("hot_gather", 0) == before + (T > 0)
    assert torch.equal(out, TR.hot_gather_ref(table, rows, hot_ids, idx))
    assert torch.equal(out, table.index_select(0, idx))


@pytest.mark.cuda
def test_hot_gather_kernel_clamps_out_of_range_ids(cuda):
    table, hot_ids, _ = _inputs(16, 8, 2, 0, torch.float32, cuda)
    idx = torch.tensor([-4, 16, 40, 0, 15], dtype=torch.int32, device=cuda)
    rows = table.index_select(0, hot_ids)
    out = ops.hot_gather(table, rows, hot_ids, idx)
    assert torch.equal(out, table[idx.clamp(0, 15).long()])
    assert torch.equal(out, TR.hot_gather_ref(table, rows, hot_ids, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V,D,Hn,T", [(64, 16, 40, 200),
                                      (32064, 4096, 32, 512),
                                      (512, 33, 2, 64)])
def test_hot_gather_kernel_duplicate_hot_ids_and_half_cold(cuda, V, D, Hn, T,
                                                           dtype):
    """Each of Hn / 2 hot ids appears twice (the first position wins, and
    the rows at the two positions differ), Hn = 40 past one 32-id ballot
    step, and half the tokens cold: equal to the plain version and
    index_select."""
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(
        np.float32)).to(device=cuda, dtype=dtype)
    ids = rng.choice(V, Hn // 2, replace=False).astype(np.int32)
    hot_ids = np.concatenate([ids, ids[::-1]])
    cold = np.setdiff1d(np.arange(V), ids)
    idx = np.where(rng.random(T) < 0.5, rng.choice(ids, T),
                   rng.choice(cold, T)).astype(np.int32)
    hot_ids, idx = (torch.from_numpy(a).to(cuda) for a in (hot_ids, idx))
    rows = table.index_select(0, hot_ids).clone()
    rows[Hn // 2:] = -rows[Hn // 2:]     # a later duplicate would show
    out = ops.hot_gather(table, rows, hot_ids, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, TR.hot_gather_ref(table, rows, hot_ids, idx))
    assert torch.equal(out, table.index_select(0, idx))


@pytest.mark.cuda
def test_hot_gather_kernel_rejects_what_it_does_not_take(cuda):
    table, hot_ids, idx = _inputs(64, 16, 4, 32, torch.float32, cuda)
    rows = table.index_select(0, hot_ids)
    with pytest.raises(TypeError):
        ops.hot_gather(table.half(), rows.half(), hot_ids, idx)
    with pytest.raises(TypeError):
        ops.hot_gather(table, rows, hot_ids, idx.long())
    with pytest.raises(ValueError):
        ops.hot_gather(table.t(), rows, hot_ids, idx)


@pytest.mark.cuda
def test_serving_runtime_on_the_card_specializes_through_the_kernel(cuda):
    from repro_torch.core import EngineConfig, MorpheusRuntime, SketchConfig
    from repro_torch.serving import ServeConfig, build_params, \
        build_tables, make_serve_step, make_synthetic_batch
    cfg = ServeConfig()
    params = build_params(cfg, 0)
    for lp in params["layers"]:
        with torch.no_grad():
            lp["moe"]["b_router"][:3] = 6.0
    rt = MorpheusRuntime(
        make_serve_step(cfg), build_tables(cfg), params,
        make_synthetic_batch(cfg, 0),
        cfg=EngineConfig(sketch=SketchConfig(sample_every=2, max_hot=32,
                                             hot_coverage=0.8),
                         features={"vision_enabled": False,
                                   "track_sessions": True},
                         moe_router_table="router"))
    try:
        for i in range(8):
            rt.step(make_synthetic_batch(cfg, 10 + i))
        rt.recompile(block=True)
        assert dict(rt.plan.sites)["vocab_embed#0"].impl == "hot_cache"
        assert rt.hot_experts() is not None
        ops.reset_launches()
        for i in range(4):
            b = make_synthetic_batch(cfg, 100 + i)
            assert torch.equal(rt.step(b), rt.run_generic(b))
        assert ops.launches()["hot_gather"] == 4
    finally:
        rt.close()


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------

# the reference's test shapes (B, S, H, P, N, chunk, G), a G = 2 case, a
# ragged S, and the mamba2-1.3b serving shape cut to one batch row
SSD_SHAPES = [(1, 32, 4, 8, 16, 8, 1), (2, 48, 8, 16, 32, 16, 1),
              (1, 40, 2, 8, 16, 16, 1), (2, 64, 8, 16, 16, 32, 1),
              (2, 50, 8, 16, 32, 16, 2), (1, 300, 4, 64, 128, 256, 1)]


def _ssd_tol(dtype, N, chunk):
    """The reference kernel test's tolerances; at the serving widths
    (128-term dot products over 256-step chunks) f32 rounding of sums
    taken in another order grows past 2e-5, and y is held at 1e-4."""
    if dtype == torch.bfloat16:
        return dict(rtol=2e-2, atol=2e-2)
    tol = 1e-4 if N * chunk >= 128 * 256 else 2e-5
    return dict(rtol=tol, atol=tol)


def _ssd_inputs(B, S, H, P, N, G, dtype, device, seed=0, init=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x = f(B, S, H, P).to(device=device, dtype=dtype)
    dt = torch.nn.functional.softplus(f(B, S, H)).to(device)
    A = -torch.exp(f(H) * 0.5).to(device)
    Bm = (f(B, S, G, N) * 0.3).to(device=device, dtype=dtype)
    Cm = (f(B, S, G, N) * 0.3).to(device=device, dtype=dtype)
    s0 = (f(B, H, P, N) * 0.1).to(device) if init else None
    return x, dt, A, Bm, Cm, s0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk,G", SSD_SHAPES)
def test_ssd_scan_kernel_equals_plain(cuda, B, S, H, P, N, chunk, G, dtype):
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(B, S, H, P, N, G, dtype, cuda,
                                       init=True)
    before = ops.launches().get("ssd_scan", 0)
    y, fin = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0)
    torch.cuda.synchronize()
    assert ops.launches()["ssd_scan"] == before + 1
    yr, finr = TR.ssd_scan_ref(x, dt, A, Bm, Cm, chunk, init_state=s0)
    assert y.dtype == dtype and fin.dtype == torch.float32
    torch.testing.assert_close(y.float(), yr.float(),
                               **_ssd_tol(dtype, N, chunk))
    torch.testing.assert_close(fin, finr, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_ssd_scan_kernel_is_deterministic_and_zero_init_is_none(cuda):
    x, dt, A, Bm, Cm, _ = _ssd_inputs(2, 100, 8, 16, 32, 2, torch.float32,
                                      cuda)
    y0, f0 = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    y1, f1 = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32,
                          init_state=torch.zeros_like(f0))
    y2, f2 = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    assert torch.equal(y0, y1) and torch.equal(f0, f1)
    assert torch.equal(y0, y2) and torch.equal(f0, f2)


# head blocks (B, S, H, P, N, chunk, G): H/G = 1, 2, 8 and 6 heads a group
# (the kernel takes hblk = the largest divisor of H/G up to 8: 1, 2, 8,
# 6), S ragged against the chunk; then chunks past the 256 source steps
# whose C.B^T a block keeps (the scores are recomputed per head there)
SSD_HEAD_BLOCKS = [(2, 200, 4, 32, 64, 64, 4), (2, 200, 8, 32, 64, 64, 4),
                   (1, 300, 16, 64, 128, 128, 2), (1, 150, 12, 16, 32, 64, 2)]
SSD_LONG_CHUNKS = [(1, 700, 4, 32, 64, 512, 2), (1, 1100, 2, 16, 32, 1024, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk,G",
                         SSD_HEAD_BLOCKS + SSD_LONG_CHUNKS)
def test_ssd_scan_kernel_head_blocks_and_long_chunks(cuda, B, S, H, P, N,
                                                      chunk, G, dtype):
    """y within SSD_TOL of chip_smoke.py: f32 at the serving widths
    (N = 128, a carried state) normwise, 1e-4 * max|y_plain|, since there
    y sums 128-term products of both signs over chunks whose running
    sums of dt*A reach ~100, and the order of that running sum alone (the
    kernel's 32 fixed runs against torch.cumsum) moves single elements
    past an elementwise 2e-5; the other shapes elementwise as above."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(B, S, H, P, N, G, dtype, cuda,
                                       seed=5, init=True)
    y, fin = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0)
    yr, finr = TR.ssd_scan_ref(x, dt, A, Bm, Cm, chunk, init_state=s0)
    if dtype == torch.float32 and N == 128:
        err = (y - yr).abs().max().item()
        assert err <= 1e-4 * yr.abs().max().item(), err
    else:
        torch.testing.assert_close(y.float(), yr.float(),
                                   **_ssd_tol(dtype, N, chunk))
    torch.testing.assert_close(fin, finr, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_head_blocks_repeat_bits(cuda, dtype):
    """8 heads a block and two blocks a group, a ragged last chunk: the
    same bits call to call, and a None init equal to a zero one."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(2, 600, 32, 64, 128, 2, dtype, cuda,
                                      seed=6)
    y0, f0 = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    y1, f1 = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=256,
                          init_state=torch.zeros_like(f0))
    y2, f2 = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    assert torch.equal(y0, y1) and torch.equal(f0, f1)
    assert torch.equal(y0, y2) and torch.equal(f0, f2)


@pytest.mark.cuda
def test_ssd_scan_kernel_reads_strided_projections(cuda):
    """x, B and C as slices of one (B, S, C) projection, as the Mamba2
    block hands them over: no copies, the same result."""
    B, S, H, P, G, N = 2, 40, 4, 8, 1, 16
    xBC = torch.randn(B, S, H * P + 2 * G * N, device=cuda)
    x = xBC[..., :H * P].reshape(B, S, H, P)
    Bm = xBC[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cm = xBC[..., H * P + G * N:].reshape(B, S, G, N)
    dt = torch.rand(B, S, H, device=cuda)
    A = -torch.rand(H, device=cuda)
    y, fin = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    yc, finc = ops.ssd_scan(x.contiguous(), dt, A, Bm.contiguous(),
                            Cm.contiguous(), chunk=16)
    assert torch.equal(y, yc) and torch.equal(fin, finc)


@pytest.mark.cuda
def test_ssd_scan_kernel_rejects_what_it_does_not_take(cuda):
    x, dt, A, Bm, Cm, _ = _ssd_inputs(1, 32, 4, 8, 16, 1, torch.float32,
                                      cuda)
    with pytest.raises(TypeError):              # half precision
        ops.ssd_scan(x.half(), dt, A, Bm.half(), Cm.half(), chunk=8)
    with pytest.raises(TypeError):              # dt not float32
        ops.ssd_scan(x, dt.double(), A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError):             # G does not divide H
        ops.ssd_scan(x, dt, A, Bm.expand(1, 32, 3, 16),
                     Cm.expand(1, 32, 3, 16), chunk=8)
    with pytest.raises(ValueError):             # P beyond the tiles
        big = torch.zeros(1, 32, 4, 128, device=cuda)
        ops.ssd_scan(big, dt, A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError):             # chunk beyond the scan
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=2048)
    with pytest.raises(ValueError):             # x's heads not dense
        ops.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                     Bm, Cm, chunk=8)


# ssd_scan_bwd against its plain version (autograd through ssd_scan_ref on
# the same inputs), normwise: max |kernel - plain| <= tol * max |plain|.
# f32: the two sum in other orders (measured up to 4.9e-5 of the largest
# entry on these shapes, dA the worst); bf16: dx, dB and dC are rounded
# to 8 bits on both sides, a tie broken the other way ~4e-3 of an entry.
SSD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")


def _ssd_bwd_case(B, S, H, P, N, G, dtype, device, seed=0, init=True):
    """Inputs, the forward's scratch and the cotangents of both outputs."""
    from repro_torch.kernels import ssd_scan as ssd_mod
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(B, S, H, P, N, G, dtype, device,
                                       seed=seed, init=init)
    g = torch.Generator().manual_seed(seed + 1)
    dy = torch.randn(B, S, H, P, generator=g).to(device=device, dtype=dtype)
    dfin = torch.randn(B, H, P, N, generator=g).to(device)
    return ssd_mod, (x, dt, A, Bm, Cm), s0, dy, dfin


def _ssd_bwd(ssd_mod, args, s0, dy, dfin, chunk):
    y, fin, dacs, states = ssd_mod.ssd_scan_cuda(
        *args, chunk=chunk, init_state=s0, return_scratch=True)
    return ssd_mod.ssd_scan_bwd_cuda(*args, dacs, states, fin, dy, dfin,
                                     chunk=chunk)


def _assert_ssd_bwd_close(got, ref, init, skip=()):
    """Each gradient normwise within SSD_BWD_TOL of its own dtype: dx, dB
    and dC in x's, ddt, dA and dinit f32 in a bf16 call too."""
    for name, a, r in zip(SSD_BWD_NAMES, got, ref):
        if (name == "dinit" and not init) or name in skip:
            continue
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert torch.isfinite(a).all(), name
        err = _normwise(a, r)
        assert err <= SSD_BWD_TOL[a.dtype] * float(r.float().abs().max()), \
            (name, err)


def _ssd_bwd_blocked(args, chunk, dy, **kw):
    """The blocked version, its dB / dC summed by the kernel's head
    blocks."""
    from repro_torch.kernels.ssd_scan import head_block
    hblk = head_block(args[0].shape[2] // args[3].shape[2])
    return TR.ssd_scan_bwd_blocked_ref(*args, chunk, dy, **kw, hblk=hblk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk,G", SSD_SHAPES)
def test_ssd_scan_bwd_kernel_equals_plain(cuda, B, S, H, P, N, chunk, G,
                                          dtype):
    """Every gradient against the plain version and the blocked one (the
    kernel's passes in plain PyTorch), with an initial state and a
    cotangent of the final state; one launch counted."""
    ssd_mod, args, s0, dy, dfin = _ssd_bwd_case(B, S, H, P, N, G, dtype,
                                                cuda)
    before = ops.launches().get("ssd_scan_bwd", 0)
    got = _ssd_bwd(ssd_mod, args, s0, dy, dfin, chunk)
    torch.cuda.synchronize()
    assert ops.launches()["ssd_scan_bwd"] == before + 1
    kw = dict(dfinal=dfin, init_state=s0)
    _assert_ssd_bwd_close(got, TR.ssd_scan_bwd_ref(*args, chunk, dy, **kw),
                          True)
    _assert_ssd_bwd_close(got, _ssd_bwd_blocked(args, chunk, dy, **kw), True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_bwd_kernel_repeats_its_bits(cuda, dtype):
    """No atomics: 16 heads a group summed into dB and dC, a ragged last
    chunk, no final-state cotangent; two calls give the same bits."""
    ssd_mod, args, s0, dy, _ = _ssd_bwd_case(2, 600, 32, 64, 128, 2, dtype,
                                             cuda, seed=6, init=False)
    a = _ssd_bwd(ssd_mod, args, s0, dy, None, 256)
    b = _ssd_bwd(ssd_mod, args, s0, dy, None, 256)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    ref = TR.ssd_scan_bwd_ref(*args, 256, dy)
    _assert_ssd_bwd_close(a, ref, False)


# head blocks (B, S, H, P, N, chunk, G): hblk 1 (one head a group), 2
# (H 6, G 3), 8 (H 16: two blocks a group) and mamba2's widths (P 64, N
# 128, chunk 256, 8 heads), then chunks past the 256 steps of C.B^T a
# strip keeps (formed again per head there); every S ragged
SSD_BWD_HEAD_BLOCKS = [(2, 200, 4, 32, 64, 64, 4), (1, 150, 6, 16, 32, 64, 3),
                       (1, 300, 16, 64, 128, 128, 1),
                       (1, 600, 8, 64, 128, 256, 1)]
SSD_BWD_LONG_CHUNKS = [(1, 700, 4, 32, 64, 512, 2),
                       (1, 1100, 2, 16, 32, 1024, 1)]
# dA at chunk 1024 (f32 in both dtypes), held against a float64
# evaluation instead, on seeds 9-14: dA sums d da dt over every step, d da
# a reverse running sum over the chunk of score sums that cancel, so any
# f32 evaluation's rounding grows with the chunk.  Of max|dA| from
# float64 there, read on an H100 over both dtypes: the plain f32 version
# 7.2e-6 to 2.49e-4, the kernel 1.7e-5 to 2.65e-4; at chunk 512 both stay
# under 6.1e-5 and every gradient is held to SSD_BWD_TOL.
SSD_BWD_DA_F64_TOL = 3e-4
SSD_BWD_DA_SEEDS = range(9, 15)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk,G",
                         SSD_BWD_HEAD_BLOCKS + SSD_BWD_LONG_CHUNKS)
def test_ssd_scan_bwd_kernel_head_blocks_and_long_chunks(cuda, B, S, H, P,
                                                         N, chunk, G, dtype):
    """The twin of the forward's head-block test: every gradient within
    SSD_BWD_TOL of the plain version and of the blocked one, and two calls
    equal bit for bit.  At chunk 1024 dA is held against float64 on six
    seeds, where the plain f32 version's own distance leaves
    SSD_BWD_TOL."""
    ssd_mod, args, s0, dy, dfin = _ssd_bwd_case(B, S, H, P, N, G, dtype,
                                                cuda, seed=9)
    got = _ssd_bwd(ssd_mod, args, s0, dy, dfin, chunk)
    again = _ssd_bwd(ssd_mod, args, s0, dy, dfin, chunk)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    kw = dict(dfinal=dfin, init_state=s0)
    skip = ("dA",) if chunk > 512 else ()
    _assert_ssd_bwd_close(got, TR.ssd_scan_bwd_ref(*args, chunk, dy, **kw),
                          True, skip)
    _assert_ssd_bwd_close(got, _ssd_bwd_blocked(args, chunk, dy, **kw), True,
                          skip)
    if not skip:
        return
    plain_worst = 0.0
    for seed in SSD_BWD_DA_SEEDS:
        ssd_mod, args, s0, dy, dfin = _ssd_bwd_case(B, S, H, P, N, G, dtype,
                                                    cuda, seed=seed)
        dA = _ssd_bwd(ssd_mod, args, s0, dy, dfin, chunk)[2]
        plain = TR.ssd_scan_bwd_ref(*args, chunk, dy, dfinal=dfin,
                                    init_state=s0)[2]
        d = lambda t: t.double()
        exact = TR.ssd_scan_bwd_ref(*map(d, args), chunk, d(dy),
                                    dfinal=d(dfin), init_state=d(s0))[2]
        off = lambda t: float((t.double() - exact).abs().max()
                              / exact.abs().max())
        assert off(dA) <= SSD_BWD_DA_F64_TOL, (seed, off(dA), off(plain))
        plain_worst = max(plain_worst, off(plain))
    # the conditioning: an f32 evaluation of the function itself leaves
    # SSD_BWD_TOL of float64 here
    assert plain_worst > SSD_BWD_TOL[torch.float32], plain_worst


@pytest.mark.cuda
def test_ssd_scan_bwd_kernel_reads_strided_projections(cuda):
    """x, B and C as slices of one projection, as the Mamba2 block saves
    them: the gradients equal those of contiguous copies bit for bit."""
    ssd_mod, (x, dt, A, Bm, Cm), s0, dy, dfin = _ssd_bwd_case(
        2, 70, 4, 8, 16, 1, torch.float32, cuda, seed=7)
    xBC = torch.cat([x.flatten(2), Bm.flatten(2), Cm.flatten(2)], dim=-1)
    xs = xBC[..., :32].reshape(x.shape)
    Bs = xBC[..., 32:48].reshape(Bm.shape)
    Cs = xBC[..., 48:].reshape(Cm.shape)
    assert not xs.is_contiguous()
    a = _ssd_bwd(ssd_mod, (xs, dt, A, Bs, Cs), s0, dy, dfin, 16)
    b = _ssd_bwd(ssd_mod, (x, dt, A, Bm, Cm), s0, dy, dfin, 16)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
def test_ssd_scan_bwd_kernel_rejects_what_it_does_not_take(cuda):
    ssd_mod, args, s0, dy, dfin = _ssd_bwd_case(1, 32, 4, 8, 16, 1,
                                                torch.float32, cuda)
    x, dt, A, Bm, Cm = args
    y, fin, dacs, states = ssd_mod.ssd_scan_cuda(*args, chunk=8,
                                                 return_scratch=True)
    bwd = ssd_mod.ssd_scan_bwd_cuda
    with pytest.raises(ValueError):             # dy not in x's dtype
        bwd(*args, dacs, states, fin, dy.bfloat16(), dfin, chunk=8)
    with pytest.raises(ValueError):             # dy of another shape
        bwd(*args, dacs, states, fin, dy[:, :16], dfin, chunk=8)
    with pytest.raises(ValueError):             # scratch of another chunk
        bwd(*args, dacs, states, fin, dy, dfin, chunk=16)
    with pytest.raises(ValueError):             # dfinal not float32
        bwd(*args, dacs, states, fin, dy, dfin.double(), chunk=8)
    with pytest.raises(TypeError):              # half precision
        bwd(x.half(), dt, A, Bm.half(), Cm.half(), dacs, states, fin,
            dy.half(), dfin, chunk=8)
    with pytest.raises(ValueError):             # P beyond the tiles
        big = torch.zeros(1, 32, 4, 128, device=cuda)
        bwd(big, dt, A, Bm, Cm, dacs, states, fin, big, dfin, chunk=8)


@pytest.mark.cuda
@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
def test_ssd_scan_autograd_launches_the_backward_kernel(cuda, init):
    """With grad, ``ops.ssd_scan`` runs through ``SsdScanFn``: the forward
    and the backward kernel, the gradients those of a direct
    ``ssd_scan_bwd_cuda`` call bit for bit; ``dinit`` only for an initial
    state that requires grad.  Without grad, the plain forward launch."""
    ssd_mod, args, s0, dy, dfin = _ssd_bwd_case(2, 100, 8, 16, 32, 2,
                                                torch.bfloat16, cuda,
                                                seed=8, init=init)
    ops.reset_launches()
    with torch.no_grad():
        ops.ssd_scan(*args, chunk=32, init_state=s0)
    assert ops.launches() == {"ssd_scan": 1}
    leaves = [t.clone().requires_grad_(True) for t in args]
    s0g = None if s0 is None else s0.clone().requires_grad_(True)
    y, fin = ops.ssd_scan(*leaves, chunk=32, init_state=s0g)
    torch.autograd.backward((y, fin), (dy, dfin))
    assert ops.launches() == {"ssd_scan": 2, "ssd_scan_bwd": 1}
    want = _ssd_bwd(ssd_mod, args, s0, dy, dfin, 32)
    for t, w in zip(leaves + [s0g], want):
        if t is not None:
            assert torch.equal(t.grad, w)


def test_ssd_scan_force_kernel_on_cpu_tensors_raises():
    x, dt, A, Bm, Cm, _ = _ssd_inputs(1, 16, 2, 4, 8, 1, torch.float32,
                                      "cpu")
    with pytest.raises(RuntimeError, match="force='kernel' needs CUDA"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=8, force="kernel")


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, Hkv, D, causal, window, cap): tests/test_kernels.py:28-35,
# gemma2-shaped cases (D 256, GQA 16/8, window and softcap; the second is
# chip_smoke.py's), llama's D 128 and a D that is not a multiple of 16
FA_SHAPES = [(1, 64, 64, 4, 4, 32, True, None, 0.0),
             (2, 100, 100, 4, 2, 32, True, None, 0.0),
             (1, 64, 64, 4, 1, 64, True, None, 0.0),
             (1, 96, 96, 2, 2, 32, True, 32, 50.0),
             (1, 64, 64, 4, 4, 32, False, None, 0.0),
             (2, 1, 128, 4, 2, 32, True, None, 0.0),
             (1, 300, 300, 16, 8, 256, True, 128, 50.0),
             (1, 1000, 1000, 16, 8, 256, True, 512, 50.0),
             (2, 130, 130, 8, 2, 128, True, None, 0.0),
             (1, 70, 70, 2, 1, 24, True, 16, 30.0)]


def _fa_inputs(B, Sq, Sk, H, Hkv, D, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(device=device, dtype=dtype)
    return f(B, Sq, H, D), f(B, Sk, Hkv, D), f(B, Sk, Hkv, D)


def _fa_tol(dtype):
    # tests/test_kernels.py:16-18
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else \
        dict(rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window,cap", FA_SHAPES)
def test_flash_attention_kernel_equals_plain(cuda, B, Sq, Sk, H, Hkv, D,
                                             causal, window, cap, dtype):
    q, k, v = _fa_inputs(B, Sq, Sk, H, Hkv, D, dtype, cuda)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    before = ops.launches().get("flash_attention", 0)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launches()["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = TR.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **_fa_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_reads_a_strided_cache_slice(cuda, dtype):
    """A decode reads the cache (B, cap, Hkv, D) sliced to [lo, pos] in
    place; the result equals that of a contiguous copy bit for bit, and
    the plain version within the tolerance."""
    _, ck, cv = _fa_inputs(2, 1, 200, 16, 8, 256, dtype, cuda, seed=1)
    q = _fa_inputs(2, 1, 1, 16, 8, 256, dtype, cuda, seed=2)[0]
    ks, vs = ck[:, 37:161], cv[:, 37:161]
    assert not ks.is_contiguous()
    out = ops.flash_attention(q, ks, vs, causal=False, logit_softcap=50.0)
    copy = ops.flash_attention(q, ks.contiguous(), vs.contiguous(),
                               causal=False, logit_softcap=50.0)
    assert torch.equal(out, copy)
    ref = TR.flash_attention_ref(q, ks, vs, causal=False, logit_softcap=50.0)
    torch.testing.assert_close(out.float(), ref.float(), **_fa_tol(dtype))


@pytest.mark.cuda
def test_flash_attention_kernel_fully_masked_rows_give_zero(cuda):
    q, k, v = _fa_inputs(1, 8, 8, 2, 2, 32, torch.float32, cuda)
    out = ops.flash_attention(q, k, v, window=0)
    assert torch.equal(out, torch.zeros_like(out))
    out = ops.flash_attention(q, k[:, :0], v[:, :0])
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_is_deterministic(cuda, dtype):
    q, k, v = _fa_inputs(2, 257, 257, 16, 8, 256, dtype, cuda, seed=3)
    a = ops.flash_attention(q, k, v, window=100, logit_softcap=50.0)
    b = ops.flash_attention(q, k, v, window=100, logit_softcap=50.0)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _fa_inputs(1, 16, 16, 4, 2, 32, torch.float32, cuda)
    with pytest.raises(TypeError):              # mixed dtypes
        ops.flash_attention(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(TypeError):              # half precision
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):             # D > 256
        big = torch.zeros(1, 16, 4, 264, device=cuda)
        ops.flash_attention(big, big[:, :, :2], big[:, :, :2])
    with pytest.raises(ValueError):             # D not a multiple of 8
        odd = torch.zeros(1, 16, 4, 20, device=cuda)
        ops.flash_attention(odd, odd[:, :, :2], odd[:, :, :2])
    with pytest.raises(ValueError):             # H not a multiple of Hkv
        kv3 = torch.zeros(1, 16, 3, 32, device=cuda)
        ops.flash_attention(q, kv3, kv3)
    with pytest.raises(ValueError):             # last dim not dense
        ops.flash_attention(q, k.transpose(1, 3).contiguous().transpose(1, 3),
                            v)


# split-K decode: G * Sq <= 64 rows a kv head; (B, Hkv) = (2, 2)
DEC_CASES = [(Sq, G, Sk, D) for Sq in (1, 4) for G in (1, 2, 8)
             for Sk in (1, 63, 64, 65, 1000, 6176) for D in (32, 128, 256)]
# (causal, window, cap): none, causal, window + softcap, all three
DEC_MASKS = [(False, None, 0.0), (True, None, 0.0), (False, 50, 50.0),
             (True, 700, 30.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,G,Sk,D", DEC_CASES)
def test_flash_attention_split_k_decode_equals_plain(cuda, Sq, G, Sk, D):
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _fa_inputs(2, Sq, Sk, 2 * G, 2, D, dtype, cuda, seed=Sk)
        for causal, window, cap in DEC_MASKS:
            kw = dict(causal=causal, window=window, logit_softcap=cap)
            out = ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            assert fa_mod.last_path == "split_k_decode"
            ref = TR.flash_attention_ref(q, k, v, **kw)
            torch.testing.assert_close(out.float(), ref.float(),
                                       **_fa_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", [(0, 1), (37, 161), (900, 2901),
                                   (0, 6176)])
def test_flash_attention_split_k_decode_reads_the_cache_in_place(cuda, lo,
                                                                  hi):
    """gemma2-9b's decode shape over a strided slice of a (2, 6176, 8, 256)
    cache: equal to a contiguous copy bit for bit, and call == call."""
    _, ck, cv = _fa_inputs(2, 1, 6176, 16, 8, 256, torch.bfloat16, cuda,
                           seed=4)
    q = _fa_inputs(2, 1, 1, 16, 8, 256, torch.bfloat16, cuda, seed=5)[0]
    ks, vs = ck[:, lo:hi], cv[:, lo:hi]
    kw = dict(causal=False, logit_softcap=50.0)
    out = ops.flash_attention(q, ks, vs, **kw)
    assert fa_mod.last_path == "split_k_decode"
    assert torch.equal(out, ops.flash_attention(q, ks, vs, **kw))
    assert torch.equal(out, ops.flash_attention(q, ks.contiguous(),
                                                vs.contiguous(), **kw))
    ref = TR.flash_attention_ref(q, ks, vs, **kw)
    torch.testing.assert_close(out.float(), ref.float(),
                               **_fa_tol(torch.bfloat16))


# wgmma prefill: Sq not a multiple of 128, D in {64, 128, 256}
PRE_CASES = [(Sq, D) for Sq in (130, 300, 1000) for D in (64, 128, 256)]
PRE_MASKS = [(True, None, 0.0), (True, 256, 50.0), (False, None, 30.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,D", PRE_CASES)
@pytest.mark.parametrize("causal,window,cap", PRE_MASKS)
def test_flash_attention_wgmma_prefill_equals_plain(cuda, Sq, D, causal,
                                                    window, cap):
    q, k, v = _fa_inputs(2, Sq, Sq, 8, 4, D, torch.bfloat16, cuda, seed=Sq)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_mod.last_path == "wgmma_prefill"
    ref = TR.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(),
                               **_fa_tol(torch.bfloat16))


@pytest.mark.cuda
def test_flash_attention_wgmma_prefill_reads_cache_slices_in_place(cuda):
    """k and v as the first S slots of a longer cache (the prefill's
    ``ck[:, :S]``), and more keys than queries: equal to contiguous copies
    bit for bit, call == call."""
    _, ck, cv = _fa_inputs(2, 1, 1500, 16, 8, 256, torch.bfloat16, cuda,
                           seed=6)
    for Sq, Sk, causal in ((333, 333, True), (300, 1000, False)):
        q = _fa_inputs(2, Sq, 1, 16, 8, 256, torch.bfloat16, cuda,
                       seed=7)[0]
        ks, vs = ck[:, :Sk], cv[:, :Sk]
        kw = dict(causal=causal, window=200, logit_softcap=50.0)
        out = ops.flash_attention(q, ks, vs, **kw)
        assert fa_mod.last_path == "wgmma_prefill"
        assert torch.equal(out, ops.flash_attention(q, ks, vs, **kw))
        assert torch.equal(out, ops.flash_attention(q, ks.contiguous(),
                                                    vs.contiguous(), **kw))
        ref = TR.flash_attention_ref(q, ks, vs, **kw)
        torch.testing.assert_close(out.float(), ref.float(),
                                   **_fa_tol(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,path", [
    ((2, 1, 6176, 16, 8, 256), torch.bfloat16, "split_k_decode"),
    ((1, 64, 64, 4, 4, 32), torch.float32, "split_k_decode"),
    ((2, 300, 300, 16, 8, 256), torch.bfloat16, "wgmma_prefill"),
    ((1, 64, 64, 4, 1, 64), torch.bfloat16, "wgmma_prefill"),
    ((1, 70, 70, 2, 1, 24), torch.bfloat16, "mma_sync"),
    ((2, 100, 100, 4, 2, 32), torch.float32, "f32")])
def test_flash_attention_takes_the_path_its_rule_names(cuda, shape, dtype,
                                                       path):
    B, Sq, Sk, H, Hkv, D = shape
    q, k, v = _fa_inputs(B, Sq, Sk, H, Hkv, D, dtype, cuda)
    assert fa_mod.choose_path(Sq, H, Hkv, D, dtype) == path
    ops.flash_attention(q, k, v)
    assert fa_mod.last_path == path


# every forward path (shape, dtype, path) with the logsumexp asked for;
# the logsumexp within LSE_TOL (log2 units, absolute) of the plain one:
# the sums run in another order, and ex2.approx errs by ~2^-22 relative
LSE_CASES = [((2, 1, 300, 16, 8, 256), torch.bfloat16, "split_k_decode"),
             ((2, 4, 1000, 8, 2, 64), torch.float32, "split_k_decode"),
             ((2, 300, 300, 16, 8, 256), torch.bfloat16, "wgmma_prefill"),
             ((1, 130, 130, 24, 2, 128), torch.bfloat16, "wgmma_prefill"),
             ((2, 200, 200, 4, 4, 64), torch.bfloat16, "wgmma_prefill"),
             ((1, 70, 70, 2, 1, 24), torch.bfloat16, "mma_sync"),
             ((2, 100, 100, 4, 2, 32), torch.float32, "f32")]
LSE_MASKS = [(True, None, 0.0), (True, 64, 50.0), (False, None, 30.0),
             (True, 0, 0.0)]
LSE_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window,cap", LSE_MASKS)
@pytest.mark.parametrize("shape,dtype,path", LSE_CASES)
def test_flash_attention_writes_the_logsumexp_on_every_path(
        cuda, shape, dtype, path, causal, window, cap):
    """With ``return_lse`` the output is the same bits as without it, and
    the logsumexp (log2 units) equals the plain one; a row that sees no
    key (window 0) gets NEG_INF exactly."""
    B, Sq, Sk, H, Hkv, D = shape
    q, k, v = _fa_inputs(B, Sq, Sk, H, Hkv, D, dtype, cuda, seed=Sk)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    plain_out = fa_mod.flash_attention_cuda(q, k, v, **kw)
    out, lse = fa_mod.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert fa_mod.last_path == path
    assert torch.equal(out, plain_out)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    ref = TR.flash_attention_lse_ref(q, k, **kw)
    assert torch.equal(lse == TR.NEG_INF, ref == TR.NEG_INF)
    torch.testing.assert_close(lse, ref, rtol=0, atol=LSE_TOL)


@pytest.mark.cuda
def test_model_prefill_and_decode_on_the_card_go_through_the_kernel(cuda):
    """gemma2-9b at smoke scale in bf16: every attention layer launches
    the kernel once per prefill and once per decode step, and the card's
    logits lie no farther from the host's (the plain version, the same
    weights) than the host's bf16 logits lie from its own f32 ones (the
    rule of ``test_torch_model.py``)."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.model import Model
    cfg = get_config("gemma2-9b").smoke()
    model = Model(cfg)
    host = model.init(0, device="cpu")
    host32 = copy.deepcopy(host).float()
    card = copy.deepcopy(host).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32))
    prefill, decode = make_prefill_step(model), make_decode_step(model)

    def serve(params, device):
        cache = model.init_cache(2, 48, device=device)
        ops.reset_launches()
        outs = [prefill(params, cache, {"tokens": toks.to(device)})[0]]
        counts = [ops.launches().get("flash_attention", 0)]
        nxt = toks[:, :1]
        for step in range(3):
            ops.reset_launches()
            out, cache = decode(params, cache, nxt.to(device), 40 + step)
            counts.append(ops.launches().get("flash_attention", 0))
            outs.append(out)
            nxt = toks[:, step + 1:step + 2]
        return [o.float().cpu() for o in outs], counts

    on_card, counts = serve(card, cuda)
    assert counts == [cfg.n_layers] * 4
    on_host, host_counts = serve(host, "cpu")
    assert host_counts == [0] * 4
    on_host32, _ = serve(host32, "cpu")
    for a, b, c in zip(on_card, on_host, on_host32):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= (b - c).abs().max()


@pytest.mark.cuda
def test_moe_model_prefill_and_decode_on_the_card(cuda):
    """phi3.5-MoE at smoke scale (every layer attention + a 4-expert MoE
    FFN), f32 params and an f32 cache on the card and on the host: a
    prefill and three decode steps launch the kernel once per layer per
    call, read the host once per MoE layer per decode step (the group
    sizes; sync debug mode), give equal bits from run to run, and lie
    within ``test_torch_model.py``'s f32 tolerance (1e-4 normwise) of the
    host's run, with equal expert counts."""
    import copy
    import warnings
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.model import Model
    cfg = get_config("phi3.5-moe-42b-a6.6b").smoke()
    model = Model(cfg)
    host = model.init(0, device="cpu").float()
    card = copy.deepcopy(host).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32))
    prefill, decode = make_prefill_step(model), make_decode_step(model)

    def serve(params, device):
        cache = model.init_cache(2, 48, device=device)
        for blk in cache["blocks"].values():
            for n in ("k", "v"):
                blk["kv"][n] = blk["kv"][n].float()
        ops.reset_launches()
        outs = [prefill(params, cache, {"tokens": toks.to(device)})[0]]
        counts, syncs = [ops.launches().get("flash_attention", 0)], []
        for step in range(3):
            ops.reset_launches()
            nxt = toks[:, step:step + 1].to(device)   # before counting
            on_card = torch.device(device).type == "cuda"
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    out, cache = decode(params, cache, nxt, 40 + step)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode("default")
            syncs.append(sum("synchroniz" in str(w.message)
                             for w in caught))
            counts.append(ops.launches().get("flash_attention", 0))
            outs.append(out)
        with torch.no_grad():
            _, _, met = model.forward(params, {"tokens": toks.to(device)})
        return ([o.cpu() for o in outs], counts, syncs,
                met["expert_counts"].cpu())

    a, counts, syncs, expert = serve(card, cuda)
    assert counts == [cfg.n_layers] * 4
    assert syncs == [cfg.n_layers] * 3
    b, _, _, expert_b = serve(card, cuda)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(expert, expert_b)
    h, host_counts, _, host_expert = serve(host, "cpu")
    assert host_counts == [0] * 4
    assert torch.equal(expert, host_expert)
    for x, y in zip(a, h):
        assert torch.isfinite(x).all()
        assert (x - y).abs().max() <= 1e-4 * y.abs().max()


@pytest.mark.cuda
def test_mamba_model_prefill_and_decode_on_the_card(cuda):
    """mamba2-1.3b at smoke scale in bf16 (2 Mamba layers, no FFN): a
    prefill launches ``ssd_scan`` once per layer and a decode step never
    (the single-token update is plain PyTorch), and the card's logits
    lie within the scan's bf16 tolerance, normwise (2e-2 of max|host|),
    of the host's run of the same weights through the plain version."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.model import Model
    cfg = get_config("mamba2-1.3b").smoke()
    model = Model(cfg)
    host = model.init(0, device="cpu")
    card = copy.deepcopy(host).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32))
    prefill, decode = make_prefill_step(model), make_decode_step(model)

    def serve(params, device):
        cache = model.init_cache(2, 48, device=device)
        ops.reset_launches()
        outs = [prefill(params, cache, {"tokens": toks.to(device)})[0]]
        counts = [ops.launches().get("ssd_scan", 0)]
        for step in range(3):
            ops.reset_launches()
            out, cache = decode(params, cache,
                                toks[:, step:step + 1].to(device), 40 + step)
            counts.append(ops.launches().get("ssd_scan", 0))
            outs.append(out)
        assert cache["filled"] == 43
        return [o.float().cpu() for o in outs], counts

    on_card, counts = serve(card, cuda)
    assert counts == [cfg.n_layers, 0, 0, 0]
    on_host, host_counts = serve(host, "cpu")
    assert host_counts == [0] * 4
    for a, b in zip(on_card, on_host):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 2e-2 * b.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_mla_model_prefill_and_decode_on_the_card(cuda, dtype, monkeypatch):
    """deepseek-v2 at smoke scale (MLA in every layer, a dense prefix
    layer, two MoE layers with a shared expert): a 600-token prefill (the
    naive form over two 512-key blocks) and three decode steps (the
    absorbed form) launch no kernel (MLA attends in plain PyTorch).  In
    bf16 the card's logits lie within 2e-2 of max|host|, normwise, of
    the host's run of the same weights, on the rows no routing flip
    between the two runs reaches (a token whose top-2 router logits
    nearly tie may route otherwise after a last-bit difference; it and,
    through attention, the later rows of its sequence are left out, and
    at most 5 % of the (token, MoE layer) pairs may flip).  In f32
    (params and cache) the routing is the same everywhere and the logits
    lie within 1e-4."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import Model
    cfg = get_config("deepseek-v2-236b").smoke()
    model = Model(cfg)
    host = model.init(0, device="cpu")
    f32 = dtype == "f32"
    if f32:
        host = host.float()
    card = copy.deepcopy(host).to(cuda)
    B, S, N = 2, 600, 3
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S + N)).astype(np.int32))
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    routes, real_route = [], moe_mod.route

    def tap(*a, **kw):
        out = real_route(*a, **kw)
        routes.append(out[1].sort(-1).values.cpu())
        return out
    monkeypatch.setattr(moe_mod, "route", tap)

    def serve(params, device):
        routes.clear()
        cache = model.init_cache(B, S + N, device=device)
        if f32:
            for layer in [cache["prefix0"]] + list(cache["blocks"].values()):
                for n in ("ckv", "k_rope"):
                    layer["kv"][n] = layer["kv"][n].float()
        ops.reset_launches()
        outs = [prefill(params, cache, {"tokens": toks[:, :S].to(device)})[0]]
        for j in range(N):
            out, cache = decode(params, cache,
                                toks[:, S + j:S + j + 1].to(device), S + j)
            outs.append(out)
        assert cache["filled"] == S + N
        return [o.float().cpu() for o in outs], dict(ops.launches()), \
            list(routes)

    on_card, launches, card_routes = serve(card, cuda)
    assert launches.get("flash_attention", 0) == 0
    assert launches.get("ssd_scan", 0) == 0
    on_host, _, host_routes = serve(host, "cpu")
    n_moe = cfg.n_layers - cfg.first_k_dense         # the last is the last
    assert len(card_routes) == len(host_routes) == n_moe * (N + 1)
    hit, flips = torch.zeros((B, S + N), dtype=torch.bool), []
    for c, (a, b) in enumerate(zip(card_routes, host_routes)):
        step, layer = divmod(c, n_moe)
        f = (a != b).any(-1)
        flips.append(f)
        m = torch.zeros((B, S + N), dtype=torch.bool)
        if step == 0:
            m[:, :S] = f.view(B, S)
        else:
            m[:, S + step - 1] = f
        hit |= m
        if layer < n_moe - 1:                 # reaches the later rows
            hit |= m.cumsum(1) > 0
    share = torch.cat(flips).float().mean().item()
    assert share == 0 if f32 else share <= 0.05, share
    tol = 1e-4 if f32 else 2e-2
    rows = [~hit[:, :S]] + [~hit[:, S + j] for j in range(N)]
    for a, b, keep in zip(on_card, on_host, rows):
        assert torch.isfinite(a).all()
        a, b = a.view(B, -1, a.shape[-1]), b.view(B, -1, b.shape[-1])
        keep = keep.view(B, -1)
        assert keep.any()
        assert (a[keep] - b[keep]).abs().max() <= tol * b.abs().max()


# seamless-m4t-medium's attention (D 64, H = Hkv = 16, no mask): the
# encoder's Sq = Sk, the cross-attention prefill's Sq > Sk, the decode's
# Sq = 1 (G * Sq = 1) over a slice of the cross cache
XATTN_CASES = [(300, 100, "wgmma_prefill"), (1000, 256, "wgmma_prefill"),
               (1024, 1024, "wgmma_prefill"), (1, 1000, "split_k_decode")]


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,path", XATTN_CASES)
def test_flash_attention_cross_attention_shapes_equal_plain(cuda, Sq, Sk,
                                                            path):
    """Non-causal, no window or softcap, k and v the first Sk of 1100
    slots of a cache (read in place: equal to contiguous copies bit for
    bit)."""
    q = _fa_inputs(2, Sq, 1, 16, 16, 64, torch.bfloat16, cuda, seed=Sq)[0]
    _, ck, cv = _fa_inputs(2, 1, 1100, 16, 16, 64, torch.bfloat16, cuda,
                           seed=Sk)
    k, v = ck[:, :Sk], cv[:, :Sk]
    kw = dict(causal=False, window=None, logit_softcap=0.0)
    out = ops.flash_attention(q, k, v, **kw)
    assert fa_mod.last_path == path
    assert torch.equal(out, ops.flash_attention(q, k.contiguous(),
                                                v.contiguous(), **kw))
    ref = TR.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(),
                               **_fa_tol(torch.bfloat16))


def _host(tree, f32=False):
    """A host copy of a nested dict of tensors (floats cast to f32 with
    ``f32``); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _host(v, f32) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    t = tree.cpu().clone()
    return t.float() if f32 and t.is_floating_point() else t


@pytest.mark.cuda
def test_encdec_model_prefill_and_decode_on_the_card(cuda, monkeypatch):
    """seamless-m4t-medium at smoke scale with heads of 64 (2 encoder and
    2 decoder layers, 4 / 4 heads), bf16: a prefill of 300 tokens and 75
    frames (the wgmma prefill in the encoder and in both attentions of
    each decoder layer) and three decode steps over a cache of 80
    cross-attention slots (the split-K decode over ``enc_len`` = 75 of
    them).  Each prefill launches ``flash_attention`` 2 + 2 x 2 times and
    each decode step 2 x 2, and two runs are equal bit for bit.

    Random-weight seamless is chaotic in depth (its attention is close to
    an argmax: ``tools/encdec_depth_witness.py``), so the card's logits
    are not held to the host's after four layers.  Every layer call is
    held instead, against the same layer run by the plain path on the
    host from a host copy of the card's input, cache and encoder output:
    its output no farther from the host's bf16 output than that lies from
    the host's f32 run of the layer (weights, input, cache and encoder
    output cast up), ``test_torch_model.py``'s bf16 rule with
    ``BF16_REL`` 1 (bf16 rounding alone moves a layer by several % here),
    and every cache leaf it writes within 2e-2 of max|host|, normwise."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import encdec as encdec_mod
    from repro_torch.models import transformer as tf_mod
    from repro_torch.models.model import Model
    cfg = get_config("seamless-m4t-medium").smoke().replace(head_dim=64)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    card = copy.deepcopy(params).to(cuda)
    rng = np.random.default_rng(0)
    B, S, N, S_ENC = 2, 300, 3, 75
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + N)).astype(
        np.int32)).to(cuda)
    frames = torch.from_numpy(rng.standard_normal(
        (B, S_ENC, cfg.d_model)).astype(np.float32)).to(cuda, torch.bfloat16)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    real = tf_mod.layer_forward
    errs = []

    def twin(p, cfg_, spec, x, start=0, cache=None, enc_out=None, **kw):
        h_cache, h32_cache = _host(cache), _host(cache, f32=True)
        args = (start, h_cache, _host(enc_out))
        h16 = real(_host(p), cfg_, spec, _host(x), *args, **kw)[0].float()
        h32 = real(_host(p, True), cfg_, spec, _host(x, True), start,
                   h32_cache, _host(enc_out, True), **kw)[0]
        out = real(p, cfg_, spec, x, start, cache, enc_out, **kw)
        errs.append(("layer", ((out[0].float().cpu() - h16).abs().max()
                               / (h16 - h32).abs().max()).item()))
        if cache is not None:
            for kind, leaves in cache.items():
                for n, t in leaves.items():
                    if n != "pos":
                        b = h_cache[kind][n].float()
                        errs.append((f"{kind} {n}", (
                            (t.float().cpu() - b).abs().max()
                            / b.abs().max() / 2e-2).item()))
        return out

    def serve(tap):
        if tap:
            monkeypatch.setattr(tf_mod, "layer_forward", twin)
            monkeypatch.setattr(encdec_mod, "layer_forward", twin)
        cache = model.init_cache(B, S + N, device=cuda, enc_cap=80)
        ops.reset_launches()
        outs = [prefill(card, cache, {"tokens": toks[:, :S],
                                      "frames": frames})[0]]
        counts = [ops.launches().get("flash_attention", 0)]
        paths = [fa_mod.last_path]
        for j in range(N):
            ops.reset_launches()
            out, cache = decode(card, cache, toks[:, S + j:S + j + 1], S + j)
            counts.append(ops.launches().get("flash_attention", 0))
            paths.append(fa_mod.last_path)
            outs.append(out)
        monkeypatch.undo()
        assert cache["filled"] == S + N and cache["enc_len"] == S_ENC
        return outs, counts, paths

    outs, counts, paths = serve(tap=False)
    assert counts == [cfg.n_enc_layers + 2 * cfg.n_layers] + \
        [2 * cfg.n_layers] * N
    assert paths == ["wgmma_prefill"] + ["split_k_decode"] * N
    assert all(torch.isfinite(o).all() for o in outs)
    again, _, _ = serve(tap=True)
    assert all(torch.equal(a, b) for a, b in zip(outs, again))
    n_calls = sum(what == "layer" for what, _ in errs)
    assert n_calls == cfg.n_enc_layers + cfg.n_layers * (N + 1)
    # each entry is an error over its bound
    worst = max(errs, key=lambda e: e[1])
    assert worst[1] <= 1.0, worst




@pytest.mark.cuda
def test_media_model_prefill_and_decode_on_the_card(cuda, monkeypatch):
    """pixtral-12b at smoke scale with pixtral's heads of 128 (2 layers,
    4 / 1 heads: GQA 4), bf16: a prefill of 100 media embeddings and 200
    text tokens (the wgmma prefill over 300 positions) and three decode
    steps from position 300 (the split-K decode over the media's slots
    and the text's).  Each call launches ``flash_attention`` once per
    layer, the logits cover all 300 positions, and two runs are equal
    bit for bit.

    Random-weight pixtral is chaotic in depth (its attention is close to
    an argmax: ``tools/vlm_depth_witness.py``), so the card's logits are
    not held to the host's.  Every layer call is held instead, against
    the same layer run by the plain path on the host from a host copy of
    the card's input and cache: its output no farther from the host's
    bf16 output than that lies from the host's f32 run of the layer,
    ``test_torch_model.py``'s bf16 rule with ``BF16_REL`` 1, and every
    cache leaf it writes within 2e-2 of max|host|, normwise."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as tf_mod
    from repro_torch.models.model import Model
    cfg = get_config("pixtral-12b").smoke().replace(head_dim=128,
                                                    n_kv_heads=1)
    model = Model(cfg)
    card = copy.deepcopy(model.init(0, device="cpu")).to(cuda)
    rng = np.random.default_rng(0)
    B, M, S, N = 2, 100, 200, 3
    P = M + S
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + N)).astype(
        np.int32)).to(cuda)
    media = torch.from_numpy(rng.standard_normal(
        (B, M, cfg.d_model)).astype(np.float32)).to(cuda, torch.bfloat16)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    real = tf_mod.layer_forward
    errs = []

    def twin(p, cfg_, spec, x, start=0, cache=None, *a, **kw):
        h_cache = _host(cache)
        h16 = real(_host(p), cfg_, spec, _host(x), start, h_cache, *a,
                   **kw)[0].float()
        h32 = real(_host(p, True), cfg_, spec, _host(x, True), start,
                   _host(cache, True), *a, **kw)[0]
        out = real(p, cfg_, spec, x, start, cache, *a, **kw)
        errs.append(("layer", ((out[0].float().cpu() - h16).abs().max()
                               / (h16 - h32).abs().max()).item()))
        for n in ("k", "v"):
            b = h_cache["kv"][n].float()
            errs.append((f"kv {n}", ((cache["kv"][n].float().cpu() - b)
                                     .abs().max() / b.abs().max()
                                     / 2e-2).item()))
        return out

    def serve(tap):
        if tap:
            monkeypatch.setattr(tf_mod, "layer_forward", twin)
        cache = model.init_cache(B, P + N, device=cuda)
        ops.reset_launches()
        outs = [prefill(card, cache, {"tokens": toks[:, :S],
                                      "media": media})[0]]
        counts = [ops.launches().get("flash_attention", 0)]
        paths = [fa_mod.last_path]
        assert cache["filled"] == P
        for j in range(N):
            ops.reset_launches()
            out, cache = decode(card, cache, toks[:, S + j:S + j + 1], P + j)
            counts.append(ops.launches().get("flash_attention", 0))
            paths.append(fa_mod.last_path)
            outs.append(out)
        monkeypatch.undo()
        assert cache["filled"] == P + N
        return outs, counts, paths

    outs, counts, paths = serve(tap=False)
    assert counts == [cfg.n_layers] * (N + 1)
    assert paths == ["wgmma_prefill"] + ["split_k_decode"] * N
    assert outs[0].shape == (B, P, cfg.padded_vocab)
    assert all(torch.isfinite(o).all() for o in outs)
    again, _, _ = serve(tap=True)
    assert all(torch.equal(a, b) for a, b in zip(outs, again))
    assert sum(what == "layer" for what, _ in errs) == cfg.n_layers * (N + 1)
    # each entry is an error over its bound
    worst = max(errs, key=lambda e: e[1])
    assert worst[1] <= 1.0, worst


@pytest.mark.cuda
def test_hybrid_model_prefill_and_decode_on_the_card(cuda, monkeypatch):
    """jamba at smoke scale in bf16 (16 layers, two periods of 8: an
    attention layer at position 2, Mamba layers elsewhere, a 4-expert MoE
    FFN on the odd positions): a 300-token prefill and three decode
    steps launch ``flash_attention`` once per attention layer per call
    and ``ssd_scan`` once per Mamba layer per prefill and never at a
    decode step; two runs on the card are equal bit for bit; and the
    card's routing parts from the host's run of the same weights (the
    plain versions) at no more than 5 % of the (token, MoE layer) pairs
    (a token whose top-2 router logits nearly tie may route otherwise
    after a last-bit difference; random-weight jamba in bf16 is chaotic
    in depth, ``test_torch_model.py``, so its logits are not held to the
    host's)."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import Model
    cfg = get_config("jamba-v0.1-52b").smoke()
    model = Model(cfg)
    host = model.init(0, device="cpu")
    card = copy.deepcopy(host).to(cuda)
    B, S, N = 2, 300, 3
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S + N)).astype(np.int32))
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    n_attn = cfg.n_periods * sum(s.kind == "attn" for s in cfg.pattern)
    n_mamba = cfg.n_layers - n_attn
    n_moe = cfg.n_periods * sum(s.ffn == "moe" for s in cfg.pattern)
    routes, real_route = [], moe_mod.route

    def tap(*a, **kw):
        out = real_route(*a, **kw)
        routes.append(out[1].sort(-1).values.cpu())
        return out
    monkeypatch.setattr(moe_mod, "route", tap)

    def serve(params, device):
        routes.clear()
        cache = model.init_cache(B, S + N, device=device)
        ops.reset_launches()
        outs = [prefill(params, cache, {"tokens": toks[:, :S].to(device)})[0]]
        counts = [dict(ops.launches())]
        for j in range(N):
            ops.reset_launches()
            out, cache = decode(params, cache,
                                toks[:, S + j:S + j + 1].to(device), S + j)
            counts.append(dict(ops.launches()))
            outs.append(out)
        assert cache["filled"] == S + N
        return [o.float().cpu() for o in outs], counts, list(routes)

    on_card, counts, card_routes = serve(card, cuda)
    assert [c.get("flash_attention", 0) for c in counts] == \
        [n_attn] * (N + 1)
    assert [c.get("ssd_scan", 0) for c in counts] == [n_mamba] + [0] * N
    assert all(torch.isfinite(o).all() for o in on_card)
    again, _, again_routes = serve(card, cuda)
    assert all(torch.equal(a, b) for a, b in zip(on_card, again))
    assert all(torch.equal(a, b) for a, b in zip(card_routes, again_routes))
    _, host_counts, host_routes = serve(host, "cpu")
    assert all(not c for c in host_counts)
    assert len(card_routes) == len(host_routes) == n_moe * (N + 1)
    flips = torch.cat([(a != b).any(-1) for a, b in
                       zip(card_routes, host_routes)])
    assert flips.float().mean().item() <= 0.05, flips.float().mean()


def _serving_runtime(device, cfg, controller=None):
    from repro_torch.core import EngineConfig, MorpheusRuntime, SketchConfig
    from repro_torch.serving import build_params, build_tables, \
        make_serve_step, make_synthetic_batch
    params = build_params(cfg, seed=0, device=device)
    for lp in params["layers"]:                  # a domain-skewed router
        with torch.no_grad():
            lp["moe"]["b_router"][:3] = 6.0
    return MorpheusRuntime(
        make_serve_step(cfg), build_tables(cfg), params,
        make_synthetic_batch(cfg, seed=0, device=device),
        cfg=EngineConfig(sketch=SketchConfig(sample_every=2, max_hot=32,
                                             hot_coverage=0.8),
                         features={"vision_enabled": False,
                                   "track_sessions": True},
                         moe_router_table="router", device=device),
        controller=controller)


@pytest.mark.cuda
def test_step_many_equals_k_steps_on_the_card(cuda):
    """A fused window on the card equals K single steps on a twin
    runtime bit for bit (outputs and the sessions table), on the
    generic plan and on the specialized one, whose windows launch
    hot_gather."""
    from repro_torch.serving import ServeConfig, make_request_windows
    cfg = ServeConfig()
    rt1, rt2 = _serving_runtime(cuda, cfg), _serving_runtime(cuda, cfg)
    try:
        for rt in (rt1, rt2):
            rt.sampler.pin(1)      # every step and window records traffic
        for seed in (0, 1):
            windows = make_request_windows(cfg, seed, 4, device=cuda)
            singles = [rt1.step(b) for b in windows]
            fused = rt2.step_many(windows)
            for i, out in enumerate(singles):
                assert torch.equal(out, fused[i])
            for name in ("count", "last_token"):
                assert torch.equal(rt1.state.tables["sessions"][name],
                                   rt2.state.tables["sessions"][name])
            if seed == 0:
                rt1.recompile(block=True)
                rt2.recompile(block=True)
                assert dict(rt2.plan.sites)["vocab_embed#0"].impl == \
                    "hot_cache"
                ops.reset_launches()
        assert ops.launches().get("hot_gather", 0) > 0
    finally:
        rt1.close()
        rt2.close()


@pytest.mark.cuda
def test_frontend_pump_on_the_card(cuda):
    """Requests through the frontend on the card: each window retires on
    its own CUDA event, outputs come back on the host and equal the
    generic oracle's rows bit for bit."""
    from repro_torch.serving import ServeConfig, make_request_batch, \
        make_request_rows
    from repro_torch.serving.frontend import FrontendConfig, \
        ServingFrontend
    cfg = ServeConfig()
    rt = _serving_runtime(cuda, cfg)
    try:
        fe = ServingFrontend(rt, FrontendConfig(capacity=32, max_batch=8,
                                                max_wait_s=0.0,
                                                inflight=2))
        rows = make_request_rows(cfg, 3, 11)
        reqs = [fe.submit(r) for r in rows]
        assert fe.pump() == 8
        assert fe.batcher.inflight == 1        # retired later
        assert fe.drain(timeout=60.0)
        assert [r.status for r in reqs] == ["ok"] * 11
        for chunk in (reqs[:8], reqs[8:]):
            bucket = 8 if len(chunk) == 8 else 4
            ref = rt.run_generic(make_request_batch(
                [r.payload for r in chunk], bucket)).cpu()
            for i, r in enumerate(chunk):
                assert r.output.device.type == "cpu"
                assert torch.equal(r.output, ref[i])
        assert rt.stats.requests_completed == 11
        assert rt.stats.hist("request_execute_s").count == 11
    finally:
        rt.close()


def _warm_serving(rt, cfg, device, n=6):
    from repro_torch.serving import make_synthetic_batch
    for i in range(n):
        rt.step(make_synthetic_batch(cfg, seed=100 + i, device=device))
    rt.recompile(block=True)
    assert dict(rt.plan.sites)["vocab_embed#0"].impl == "hot_cache"


@pytest.mark.cuda
def test_step_fault_on_the_card_retries_bit_for_bit(cuda):
    """A step fault on the card: the step is aborted with nothing
    committed (work already queued for it is dropped with its state),
    the plane degrades, and the retried batch and the sessions table
    equal a fault-free twin's bit for bit; the recompile recovers."""
    from repro_torch.distributed.fault import FailureInjector, \
        SimulatedFailure
    from repro_torch.serving import ServeConfig, make_synthetic_batch
    cfg = ServeConfig()
    rt, twin = _serving_runtime(cuda, cfg), _serving_runtime(cuda, cfg)
    try:
        _warm_serving(rt, cfg, cuda)
        _warm_serving(twin, cfg, cuda)
        inj = FailureInjector()
        rt.set_fault_injector(inj)
        b = make_synthetic_batch(cfg, seed=500, device=cuda)
        inj.arm_next(SimulatedFailure("injected"))
        with pytest.raises(SimulatedFailure):
            rt.step(b)
        assert rt.degraded and rt.stats.faults == 1
        assert torch.equal(rt.step(b), twin.step(b))
        for f in ("count", "last_token"):
            assert torch.equal(rt.state.tables["sessions"][f],
                               twin.state.tables["sessions"][f])
        assert rt.stats.degraded_steps == 1
        assert rt.recompile(block=True)["recovered"] is True
        b2 = make_synthetic_batch(cfg, seed=501, device=cuda)
        assert torch.equal(rt.step(b2), twin.step(b2))
    finally:
        rt.close()
        twin.close()


@pytest.mark.cuda
def test_fault_after_enqueue_on_the_card_commits_nothing(cuda):
    """An executable that raises after its kernels were enqueued on the
    card (hot_gather among them): that work still runs, its outputs are
    dropped, nothing reaches the state, and the retried batch and the
    sessions table equal a fault-free twin's bit for bit."""
    from repro_torch.serving import ServeConfig, make_synthetic_batch
    cfg = ServeConfig()
    rt, twin = _serving_runtime(cuda, cfg), _serving_runtime(cuda, cfg)
    try:
        _warm_serving(rt, cfg, cuda)
        _warm_serving(twin, cfg, cuda)
        rt.sampler.pin(1000)
        twin.sampler.pin(1000)
        plan, spec, instr, gen = rt._active

        def run_then_raise(params, state, batch):
            spec(params, state, batch)
            raise RuntimeError("fault after enqueue")

        rt._active = (plan, run_then_raise, run_then_raise, gen)
        pre = rt.state
        b = make_synthetic_batch(cfg, seed=550, device=cuda)
        ops.reset_launches()
        with pytest.raises(RuntimeError, match="after enqueue"):
            rt.step(b)
        assert ops.launches().get("hot_gather", 0) > 0
        assert rt.state is pre and rt.degraded
        assert torch.equal(rt.step(b), twin.step(b))
        for f in ("count", "last_token"):
            assert torch.equal(rt.state.tables["sessions"][f],
                               twin.state.tables["sessions"][f])
        rt._active = (plan, spec, instr, gen)
        assert rt.recompile(block=True)["recovered"] is True
    finally:
        rt.close()
        twin.close()


@pytest.mark.cuda
def test_degraded_steps_launch_no_hot_gather(cuda):
    """The generic plan has no hot_cache site: degraded steps launch no
    hot_gather, and steps after the recovery launch it again."""
    from repro_torch.serving import ServeConfig, make_synthetic_batch
    cfg = ServeConfig()
    rt = _serving_runtime(cuda, cfg)
    try:
        _warm_serving(rt, cfg, cuda)
        rt.sampler.pin(1000)
        rt.degrade_to_generic("injected")
        ops.reset_launches()
        for i in range(4):
            rt.step(make_synthetic_batch(cfg, seed=600 + i, device=cuda))
        torch.cuda.synchronize()
        assert ops.launches().get("hot_gather", 0) == 0
        assert rt.stats.degraded_steps == 4
        assert rt.recompile(block=True)["recovered"] is True
        ops.reset_launches()
        for i in range(4):
            rt.step(make_synthetic_batch(cfg, seed=700 + i, device=cuda))
        torch.cuda.synchronize()
        assert ops.launches().get("hot_gather", 0) > 0
    finally:
        rt.close()


@pytest.mark.cuda
def test_window_fault_on_the_card_fails_its_requests_and_serves_on(cuda):
    """A window whose step_many raised leaves no event for the retire
    loop: its requests end failed with PLANE_FAULT, the degraded plane
    rejects new ones with PLANE_DEGRADED, and after the recovery the
    batcher thread serves requests to completion."""
    from repro_torch.core.controller import ControllerConfig, \
        MorpheusController
    from repro_torch.distributed.fault import FailureInjector, \
        SimulatedFailure
    from repro_torch.serving import ServeConfig, make_request_rows
    from repro_torch.serving.frontend import FrontendConfig, \
        ServingFrontend
    from repro_torch.testing.chaos import chaos_health_config
    cfg = ServeConfig()
    ctl = MorpheusController(ControllerConfig(
        health=chaos_health_config("frontend")))
    rt = _serving_runtime(cuda, cfg, controller=ctl)
    fe = None
    try:
        _warm_serving(rt, cfg, cuda)
        fe = ServingFrontend(rt, FrontendConfig(capacity=64, max_batch=8,
                                                max_wait_s=0.0,
                                                inflight=2))
        inj = FailureInjector()
        rt.set_fault_injector(inj)
        inj.arm_next(SimulatedFailure("window fault"))
        rows = make_request_rows(cfg, 9, 24)
        failed = [fe.submit(r) for r in rows[:8]]
        assert fe.pump() == 8
        assert fe.batcher.inflight == 0
        assert [(r.status, r.reason) for r in failed] == \
            [("failed", "PLANE_FAULT")] * 8
        assert rt.degraded
        r = fe.submit(rows[8])
        assert (r.status, r.reason) == ("rejected", "PLANE_DEGRADED")
        ctl.schedule(rt)
        assert ctl.drain(timeout=120.0)
        assert not rt.degraded
        fe.start()
        ok = []
        for row in rows[9:]:
            ok.append(fe.submit(row))
            time.sleep(0.01)      # inside the admission ramp's rate
        # stop joins the batcher thread after its last window, so no
        # window taken from the queue is still being dispatched
        fe.stop()
        fe = None
        assert [x.status for x in ok] == ["ok"] * len(ok)
        s = rt.stats
        assert s.requests_failed == 8
        assert s.requests_submitted == (s.requests_completed
                                        + s.requests_rejected
                                        + s.requests_shed
                                        + s.requests_failed)
    finally:
        if fe is not None:
            fe.stop(drain=False)
        rt.close()
        ctl.close()


# ---------------------------------------------------------------------------
# flash_attention's backward (csrc/flash_attention_bwd.cu) and training
# ---------------------------------------------------------------------------

# FA_SHAPES, then the train-kernel phase's shapes at a test's size:
# starcoder2-3b's layer (GQA 24/2, D 128, causal), gemma2-9b's local
# layer (D 256, window, softcap 50) and seamless's encoder (D 64, MHA,
# not causal)
BWD_SHAPES = FA_SHAPES + [(1, 512, 512, 24, 2, 128, True, None, 0.0),
                          (1, 300, 300, 16, 8, 256, True, 128, 50.0),
                          (2, 200, 200, 16, 16, 64, False, None, 0.0),
                          # GQA 12, causal, Sk not a multiple of the
                          # wgmma path's 128-key blocks
                          (1, 300, 300, 24, 2, 128, True, None, 0.0)]
BWD_F32_TOL = 1e-4     # normwise, f32 kernel vs f32 plain: sums reordered
BWD_BF16_REL = 2.0     # x the plain version's own bf16 distance from f32


def _bwd_inputs(B, Sq, Sk, H, Hkv, D, dtype, device, seed=0):
    q, k, v = _fa_inputs(B, Sq, Sk, H, Hkv, D, dtype, device, seed)
    rng = np.random.default_rng(seed + 1)
    do = torch.from_numpy(rng.standard_normal((B, Sq, H, D)).astype(
        np.float32)).to(device=device, dtype=dtype)
    return q, k, v, do


def _normwise(got, ref):
    return float((got.float() - ref.float()).abs().max())


def _fwd(q, k, v, **kw):
    """The forward's output and logsumexp, which the backward takes."""
    return fa_mod.flash_attention_cuda(q, k, v, return_lse=True, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window,cap", BWD_SHAPES)
def test_flash_attention_bwd_kernel_equals_plain(cuda, B, Sq, Sk, H, Hkv, D,
                                                 causal, window, cap):
    """Normwise over the three gradients together (a decode-shaped row
    that sees one key has dq = 0 exactly, which no relative error of its
    own can hold): f32, each gradient within ``BWD_F32_TOL`` times the
    largest entry of the plain backward's f32 grads; bf16, within
    ``BWD_BF16_REL`` times the plain version's own largest bf16 distance
    from those f32 grads."""
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    q, k, v, do = _bwd_inputs(B, Sq, Sk, H, Hkv, D, torch.float32, cuda)
    ref32 = TR.flash_attention_bwd_ref(q, k, v, do, **kw)
    o, lse = _fwd(q, k, v, **kw)
    before = ops.launches().get("flash_attention_bwd", 0)
    got = fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert ops.launches()["flash_attention_bwd"] == before + 1
    scale = max(float(r.abs().max()) for r in ref32)
    for name, g, r in zip("qkv", got, ref32):
        assert g.dtype == torch.float32 and g.shape == r.shape
        assert _normwise(g, r) <= BWD_F32_TOL * scale, name
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    ob, lseb = _fwd(qb, kb, vb, **kw)
    got = fa_mod.flash_attention_bwd_cuda(qb, kb, vb, ob, lseb, dob, **kw)
    assert fa_mod.last_bwd_path == fa_mod.bwd_path(D, torch.bfloat16) == (
        "wgmma" if D in (64, 128) else "cuda_cores")
    plain = TR.flash_attention_bwd_ref(qb, kb, vb, dob, **kw)
    noise = max(_normwise(p, r) for p, r in zip(plain, ref32))
    for name, g, r in zip("qkv", got, ref32):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
        assert _normwise(g, r) <= BWD_BF16_REL * noise, (name, noise)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [(torch.float32, 256),
                                     (torch.bfloat16, 256),
                                     (torch.bfloat16, 128)])
def test_flash_attention_bwd_kernel_is_deterministic(cuda, dtype, D):
    """Both paths: two calls give the same bits."""
    q, k, v, do = _bwd_inputs(2, 300, 300, 16, 8, D, dtype, cuda, seed=3)
    kw = dict(window=100, logit_softcap=50.0)
    o, lse = _fwd(q, k, v, **kw)
    a = fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    b = fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 2, 3, 12])
def test_flash_attention_bwd_head_groups_sum_in_order(cuda, groups,
                                                      monkeypatch):
    """The wgmma path at GQA 12 with the kv head's query heads cut into
    1, 2, 3 or 12 groups (the group count forced): each within
    ``BWD_BF16_REL`` of the plain version's own bf16 noise, call == call
    bit for bit, and dq the same bits whatever the groups (they cut only
    dk / dv's sum)."""
    kw = dict(causal=True)
    q, k, v, do = _bwd_inputs(2, 300, 300, 24, 2, 128, torch.float32, cuda,
                              seed=9)
    ref32 = TR.flash_attention_bwd_ref(q, k, v, do, **kw)
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    noise = max(_normwise(p, r) for p, r in zip(
        TR.flash_attention_bwd_ref(qb, kb, vb, dob, **kw), ref32))
    ob, lseb = _fwd(qb, kb, vb, **kw)
    want_dq = fa_mod.flash_attention_bwd_cuda(qb, kb, vb, ob, lseb, dob,
                                              **kw)[0]
    monkeypatch.setattr(fa_mod, "bwd_head_groups", lambda *a: groups)
    got = fa_mod.flash_attention_bwd_cuda(qb, kb, vb, ob, lseb, dob, **kw)
    again = fa_mod.flash_attention_bwd_cuda(qb, kb, vb, ob, lseb, dob, **kw)
    assert fa_mod.last_bwd_path == "wgmma"
    assert torch.equal(got[0], want_dq)
    for name, g, a, r in zip("qkv", got, again, ref32):
        assert torch.equal(g, a), name
        assert _normwise(g, r) <= BWD_BF16_REL * noise, (name, noise)


@pytest.mark.cuda
def test_flash_attention_bwd_kernel_reads_unaligned_and_strided_operands(
        cuda):
    """A view that is not dense or starts off a 16-byte boundary is copied
    first: the gradient equals the one of a dense copy bit for bit."""
    q, k, v, do = _bwd_inputs(1, 130, 130, 8, 2, 128, torch.bfloat16, cuda)
    o, lse = _fwd(q, k, v)
    want = fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    big = torch.zeros(q.numel() + 1, dtype=q.dtype, device=cuda)
    q_off = big[1:].view(q.shape)
    q_off.copy_(q)
    assert q_off.data_ptr() % 16
    k_t = k.transpose(1, 2).contiguous().transpose(1, 2)
    lse_t = lse.transpose(1, 2).contiguous().transpose(1, 2)
    assert not lse_t.is_contiguous()
    got = fa_mod.flash_attention_bwd_cuda(q_off, k_t, v, o, lse_t, do)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_flash_attention_bwd_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, do = _bwd_inputs(1, 16, 16, 4, 2, 32, torch.float32, cuda)
    lse = torch.zeros(1, 4, 16, device=cuda)
    bwd = fa_mod.flash_attention_bwd_cuda
    with pytest.raises(TypeError):              # mixed dtypes
        bwd(q, k.bfloat16(), v.bfloat16(), q, lse, do)
    with pytest.raises(TypeError):              # half precision
        bwd(*(t.half() for t in (q, k, v, q)), lse, do.half())
    with pytest.raises(ValueError):             # D not a multiple of 8
        odd = torch.zeros(1, 16, 4, 20, device=cuda)
        bwd(odd, odd[:, :, :2], odd[:, :, :2], odd, lse, odd)
    with pytest.raises(ValueError):             # H not a multiple of Hkv
        kv3 = torch.zeros(1, 16, 3, 32, device=cuda)
        bwd(q, kv3, kv3, q, lse, do)
    with pytest.raises(ValueError):             # do's shape
        bwd(q, k, v, q, lse, do[:, :8])
    with pytest.raises(ValueError):             # lse's shape
        bwd(q, k, v, q, lse[:, :, :8], do)
    with pytest.raises(ValueError):             # lse's dtype
        bwd(q, k, v, q, lse.double(), do)
    with pytest.raises(ValueError):             # host tensors
        bwd(*(t.cpu() for t in (q, k, v, q, lse, do)))


@pytest.mark.cuda
def test_flash_attention_autograd_takes_the_backward_kernel(cuda):
    """With grad, ``ops.flash_attention`` launches the forward and the
    backward kernel; without it, the plain forward launch only."""
    q, k, v, do = _bwd_inputs(1, 130, 130, 8, 2, 128, torch.bfloat16, cuda)
    ops.reset_launches()
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    assert ops.launches() == {"flash_attention": 1}
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ops.flash_attention(qg, kg, vg)
    out.backward(do)
    assert ops.launches() == {"flash_attention": 2, "flash_attention_bwd": 1}
    want = fa_mod.flash_attention_bwd_cuda(q, k, v, *_fwd(q, k, v), do)
    for t, w in zip((qg, kg, vg), want):
        assert torch.equal(t.grad, w)


@pytest.mark.cuda
def test_mamba_training_on_the_card_goes_through_the_kernels(cuda):
    """mamba2's loss and every gradient in f32 on the card (each layer's
    scan through ``SsdScanFn``: the ``ssd_scan`` kernel forward and again
    in the remat recompute, ``ssd_scan_bwd`` backward) against the
    host's (the plain version), from the same params and batch, at
    ``test_torch_train.py``'s ``GRAD_TOL``."""
    arch = "mamba2-1.3b"
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models.model import Model
    from repro_torch.models.params import flat_tree, trainable
    cfg = get_config(arch).smoke()
    model = Model(cfg)
    host = trainable(model.init(0, "cpu").float())
    card = trainable(model.init(0, "cpu").float().to(cuda))
    dcfg = DataConfig(vocab=cfg.vocab, seq=80, global_batch=2, seed=0)
    bh = TokenPipeline(dcfg, "cpu").next_batch()
    bc = TokenPipeline(dcfg, cuda).next_batch()
    mamba = cfg.n_periods * sum(spec.kind == "mamba"
                                for spec in cfg.pattern)
    ops.reset_launches()
    lh, _ = model.loss(host, bh)
    lc, _ = model.loss(card, bc)
    lh.backward()
    lc.backward()
    n = ops.launches()
    assert n["ssd_scan_bwd"] == mamba and n["ssd_scan"] == 2 * mamba, n
    assert abs(float(lc) - float(lh)) <= 1e-5 * abs(float(lh))
    for (name, ph), pc in zip(flat_tree(host).items(),
                              flat_tree(card).values()):
        gh, gc = ph.grad, pc.grad.cpu()
        assert _normwise(gc, gh) <= 1e-4 * float(gh.abs().max()), name


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_host(cuda):
    """One starcoder2 smoke step in f32 from the same params and batch:
    the loss and every gradient on the card (the flash_attention kernels
    forward and backward) against the host's (the plain version), then a
    whole ``make_train_step`` step's loss and gradient norm."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.models.params import flat_tree, trainable
    from repro_torch.optim import AdamWConfig, init_opt_state
    cfg = get_config("starcoder2-3b").smoke()
    model = Model(cfg)
    host = model.init(0, "cpu").float()
    card = trainable(model.init(0, "cpu").float().to(cuda))
    host = trainable(host)
    dcfg = DataConfig(vocab=cfg.vocab, seq=64, global_batch=2, seed=0)
    bh = TokenPipeline(dcfg, "cpu").next_batch()
    bc = TokenPipeline(dcfg, cuda).next_batch()
    ops.reset_launches()
    lh, _ = model.loss(host, bh)
    lc, _ = model.loss(card, bc)
    lh.backward()
    lc.backward()
    assert ops.launches()["flash_attention_bwd"] == cfg.n_layers
    assert abs(float(lc) - float(lh)) <= 1e-5 * abs(float(lh))
    for (name, ph), pc in zip(flat_tree(host).items(),
                              flat_tree(card).values()):
        gh, gc = ph.grad, pc.grad.cpu()
        assert _normwise(gc, gh) <= 1e-4 * float(gh.abs().max()), name
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    outs = []
    for params, batch in ((host, bh), (card, bc)):
        state = {"params": params, "opt": init_opt_state(params)}
        _, m = make_train_step(model, opt)(state, batch)
        outs.append((float(m["loss"]), float(m["grad_norm"])))
    assert outs[1][0] == pytest.approx(outs[0][0], rel=1e-5)
    assert outs[1][1] == pytest.approx(outs[0][1], rel=1e-4)


# ---------------------------------------------------------------------------
# the executable cache on the card (the seqlock and system twins run on
# the card as the [cuda] cases of test_torch_fused.py / test_torch_system.py)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_exec_cache_deduplicates_inflight_builds_on_the_card(cuda):
    """Two threads ask one cache for the specialized executable while
    its build (device constants materialized on the card) is in flight:
    it is built once, both get it, and it serves through hot_gather,
    equal to the generic oracle."""
    from repro_torch.core import ExecutableCache
    from repro_torch.serving import ServeConfig, make_synthetic_batch
    cfg = ServeConfig()
    rt = _serving_runtime(cuda, cfg)
    try:
        _warm_serving(rt, cfg, cuda)
        plan = rt.plan
        c = ExecutableCache(capacity=8)
        started, gate = threading.Event(), threading.Event()
        builds, out = [], []

        def build():
            started.set()
            assert gate.wait(timeout=30)
            builds.append(1)
            return rt.engine.compile(plan, rt.state)

        key = ("card", plan.signature)
        t1 = threading.Thread(
            target=lambda: out.append(c.get_or_compile(key, build)))
        t1.start()
        assert started.wait(timeout=30)
        t2 = threading.Thread(
            target=lambda: out.append(c.get_or_compile(key, build)))
        t2.start()
        time.sleep(0.05)
        gate.set()
        t1.join(30)
        t2.join(30)
        assert len(builds) == 1 and len(out) == 2
        assert out[0][0] is out[1][0]
        assert sorted(p[1] is None for p in out) == [False, True]
        assert c.stats.inflight_waits == 1 and c.stats.inserts == 1
        b = make_synthetic_batch(cfg, seed=500, device=cuda)
        want = rt.run_generic(b)
        ops.reset_launches()
        got, _ = out[0][0](rt.params, rt.state, b)
        assert ops.launches().get("hot_gather", 0) > 0
        assert torch.equal(got, want)
    finally:
        rt.close()


# ---------------------------------------------------------------------------
# the mesh on one card: return_lse through ops, the sequence-parallel
# decode, a 4 x cuda:0 serving runtime
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_flash_attention_return_lse_is_the_kernels(cuda, dtype):
    g = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn(2, 1, 8, 128, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, 300, 2, 128, generator=g, device=cuda).to(dtype)
    v = torch.randn(2, 300, 2, 128, generator=g, device=cuda).to(dtype)
    out, lse = ops.flash_attention(q, k, v, causal=False, logit_softcap=30.0,
                                   return_lse=True)
    want_out, want_lse = fa_mod.flash_attention_cuda(
        q, k, v, causal=False, logit_softcap=30.0, return_lse=True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    # and the output is the call without the logsumexp, bit for bit
    assert torch.equal(out, ops.flash_attention(q, k, v, causal=False,
                                                logit_softcap=30.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,start,window", [
    (torch.float32, 2, 700, None), (torch.bfloat16, 2, 700, 200),
    (torch.bfloat16, 1, 90, None)])
def test_seq_parallel_decode_kernel_equals_plain(cuda, dtype, B, start,
                                                 window):
    """The sequence-parallel GQA decode over a (2, 2) mesh of cuda:0,
    each KV shard through the kernel, against the same decode on the
    CPU's plain path: within the kernel's own tolerances (``FA_TOL``)."""
    from repro_torch.distributed.meshctx import MeshPolicy
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import attention as TA
    g = torch.Generator().manual_seed(12)
    cap = 1024
    q = torch.randn(B, 1, 16, 64, generator=g)
    k = torch.randn(B, cap, 4, 64, generator=g)
    v = torch.randn(B, cap, 4, 64, generator=g)
    pols = {d: MeshPolicy(mesh=make_debug_mesh(2, 2, device=d))
            for d in ("cpu", "cuda")}
    want = TA._gqa_decode_seq_parallel(
        pols["cpu"], q.to(dtype).float(), k.to(dtype).float(),
        v.to(dtype).float(), start, window=window, logit_softcap=50.0)
    before = ops.launches().get("flash_attention", 0)
    out = TA._gqa_decode_seq_parallel(
        pols["cuda"], q.to(cuda, dtype), k.to(cuda, dtype),
        v.to(cuda, dtype), start, window=window, logit_softcap=50.0)
    n = len(list(TA._seq_shards(pols["cuda"], B, cap,
                                0 if window is None else start + 1 - window,
                                start + 1, False)))
    assert ops.launches()["flash_attention"] == before + n
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    err = (out.float().cpu() - want).abs().max().item()
    assert err <= tol * max(1.0, want.abs().max().item()), err


@pytest.mark.cuda
def test_mesh_serving_runtime_specialized_equals_generic_on_the_card(cuda):
    from repro_torch.core import EngineConfig, MorpheusRuntime, SketchConfig
    from repro_torch.distributed.meshctx import Mesh
    from repro_torch.serving import ServeConfig, build_params, \
        build_tables, make_serve_step, make_synthetic_batch
    cfg = ServeConfig()
    params = build_params(cfg, 0, "cuda")
    for lp in params["layers"]:
        with torch.no_grad():
            lp["moe"]["b_router"][:3] = 6.0
    rt = MorpheusRuntime(
        make_serve_step(cfg), build_tables(cfg), params,
        make_synthetic_batch(cfg, 0, device="cuda"),
        cfg=EngineConfig(sketch=SketchConfig(sample_every=2, max_hot=32,
                                             hot_coverage=0.8),
                         features={"vision_enabled": False,
                                   "track_sessions": True},
                         moe_router_table="router",
                         mesh=Mesh(["cuda"] * 4, ("data",))))
    try:
        for i in range(12):
            rt.step(make_synthetic_batch(cfg, 100 + i, 8, device="cuda"))
        rt.recompile(block=True)
        assert dict(rt.plan.sites)["vocab_embed#0"].impl == "hot_cache"
        b = make_synthetic_batch(cfg, 999, 8, device="cuda")
        want = rt.run_generic(b)
        before = ops.launches().get("hot_gather", 0)
        out = rt.step(b)
        assert ops.launches()["hot_gather"] == before + 4   # one a shard
        assert torch.equal(out, want)
    finally:
        rt.close()


@pytest.mark.cuda
def test_partitioned_moe_stack_on_the_card_is_call_equal(cuda):
    """phi3.5-MoE smoke in f32 partitioned by the serving rules over a
    (data 2, model 2) mesh of cuda:0 (the expert body on each data
    shard's tokens and placed expert blocks): a prefill of 4 x 40 (the
    all-to-all body) and two decode steps (the psum body), twice, equal
    bit for bit, metrics included; ``flash_attention`` launched on every
    coordinate; the logits within 1e-4 of the same partitioned run on
    the CPU, and the same drops."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed.meshctx import MeshPolicy, use_policy
    from repro_torch.distributed.sharding import make_rules, place_cache, \
        place_params
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import Model
    cfg = get_config("phi3.5-moe-42b-a6.6b").smoke()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    model = Model(cfg)
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 40)).astype(np.int32))

    def run(dev):
        pol = MeshPolicy(mesh=make_debug_mesh(2, 2, device=dev),
                         rules=make_rules(False, fsdp=False))
        params = place_params(_f32_tree(model.init(0, "cpu")), pol.mesh,
                              pol.rules)
        cache = place_cache(_f32_tree(model.init_cache(4, 48, dev)),
                            pol.mesh, pol.rules)
        out = []
        with use_policy(pol):
            logits, cache, m = model.prefill(params, cache,
                                             {"tokens": tok.to(dev)},
                                             with_metrics=True)
            out.append((logits.gather("cpu"), m))
            for j in range(2):
                logits, cache, m = model.decode_step(
                    params, cache, tok[:, j:j + 1].to(dev), 40 + j,
                    with_metrics=True)
                out.append((logits.gather("cpu"), m))
        return out

    before = ops.launches().get("flash_attention", 0)
    first = run("cuda")
    assert ops.launches()["flash_attention"] > before + 4 * cfg.n_layers
    again, host = run("cuda"), run("cpu")
    for (a, am), (b, bm), (h, hm) in zip(first, again, host):
        assert torch.equal(a, b)
        assert all(torch.equal(am[k], bm[k]) for k in am)
        err = (a - h).abs().max() / h.abs().max()
        assert err <= 1e-4, err
        assert float(am["dropped"]) == float(hm["dropped"]) == 0.0


def _f32_tree(tree):
    """A params or cache tree with its bf16 leaves cast to f32."""
    from repro_torch.models.params import flat_tree, unflat_tree
    out = {k: v.float() if isinstance(v, torch.Tensor)
           and v.dtype == torch.bfloat16 else v
           for k, v in flat_tree(tree).items()}
    return unflat_tree(out)


# ---------------------------------------------------------------------------
# training on a mesh of one card (ZeRO-sliced state, resized restores)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_mesh_train_step_on_the_card_is_call_equal_and_uses_the_kernels(
        cuda):
    """phi3.5-MoE smoke in bf16 on a (data 2, model 2) mesh of cuda:0,
    fsdp rules, ZeRO-sliced: two runs of two steps from the same params
    give the same bits, and every step launches flash_attention forward
    and backward."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed.meshctx import MeshPolicy
    from repro_torch.distributed.sharding import gather_to_host, \
        make_rules, place_train_state, train_state_shardings
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import build_state
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig
    cfg = get_config("phi3.5-moe-42b-a6.6b").smoke()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=2.0))
    model = Model(cfg)
    mesh = make_debug_mesh(2, 2, device=cuda)
    dcfg = DataConfig(vocab=cfg.vocab, seq=64, global_batch=4, seed=0)
    runs = []
    for _ in range(2):
        state = build_state(model, 0, cuda)
        sh = train_state_shardings(state["params"], mesh,
                                   make_rules(False, fsdp=True))
        state = place_train_state(state, sh)
        step = make_train_step(model, AdamWConfig(lr=1e-3),
                               grad_shardings=sh["opt"]["master"],
                               policy=MeshPolicy(mesh=mesh))
        pipe = TokenPipeline(dcfg, cuda)
        losses = []
        for _ in range(2):
            ops.reset_launches()
            state, m = step(state, pipe.next_batch())
            n = ops.launches()
            assert n.get("flash_attention", 0) >= cfg.n_layers, n
            assert n.get("flash_attention_bwd", 0) == cfg.n_layers, n
            assert float(m["dropped"]) == 0.0
            losses.append(float(m["loss"]))
        runs.append((losses, gather_to_host(state)))
    (l1, h1), (l2, h2) = runs
    assert l1 == l2 and all(np.isfinite(l1))
    assert all(torch.equal(h1[k], h2[k]) for k in h1)


@pytest.mark.cuda
def test_restore_onto_a_mesh_of_three_on_the_card_is_bit_equal(cuda,
                                                                 tmp_path):
    """A train state ZeRO-sliced over 4 entries of cuda:0, saved, and
    restored with ``shardings=`` onto 3 entries: every leaf bit-equal,
    the split leaves in 3 blocks, those that do not divide by 3
    replicated."""
    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import get_config
    from repro_torch.distributed.compat import Sharded
    from repro_torch.distributed.meshctx import Mesh
    from repro_torch.distributed.sharding import gather_to_host, \
        make_rules, place_train_state, train_state_shardings
    from repro_torch.launch.train import build_state
    from repro_torch.models.model import Model
    from repro_torch.models.params import flat_tree
    cfg = get_config("starcoder2-3b").smoke().replace(d_model=96)
    rules = make_rules(False, fsdp=True)
    state = build_state(Model(cfg), 0, cuda)
    params = state["params"]
    state = place_train_state(state, train_state_shardings(
        params, Mesh([cuda] * 4, ("data",)), rules))
    host = gather_to_host(state)
    save(str(tmp_path), 1, state)
    sh3 = train_state_shardings(params, Mesh([cuda] * 3, ("data",)), rules)
    out, meta = restore(str(tmp_path), None, state, shardings=sh3)
    assert meta["step"] == 1
    got = gather_to_host(out)
    assert all(torch.equal(got[k], host[k]) for k in host)
    split = 0
    for key, s in flat_tree(sh3["opt"]["master"]).items():
        leaf = flat_tree(out["opt"]["master"])[key]
        assert s.holds(leaf), key
        split += isinstance(leaf, Sharded) and len(leaf.shards) == 3
    assert split > 0


# ---------------------------------------------------------------------------
# the kernels' shape functions (the dry run's route) against the kernels
# ---------------------------------------------------------------------------

def _meta(t):
    """``t`` as a meta tensor of its shape, strides and dtype."""
    return None if t is None else torch.empty_strided(
        t.shape, t.stride(), dtype=t.dtype, device="meta")


def _same_layout(a, b):
    return (tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype
            and a.device.type == "meta")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,lse", [
    (2, 64, 64, 8, 2, 64, False), (2, 1, 300, 8, 1, 128, True),
    (1, 200, 200, 4, 4, 256, True), (2, 16, 40, 6, 3, 40, False)])
def test_flash_attention_shape_function_matches_the_kernel(
        cuda, B, Sq, Sk, H, Hkv, D, lse, dtype):
    q, k, v = _fa_inputs(B, Sq, Sk, H, Hkv, D, dtype, cuda)
    got = fa_mod.flash_attention_cuda(q, k, v, return_lse=lse)
    want = fa_mod.flash_attention_meta(_meta(q), _meta(k), _meta(v),
                                       return_lse=lse)
    for g, w in zip(got if lse else (got,), want if lse else (want,)):
        assert _same_layout(w, g)
    out, lse_t = fa_mod.flash_attention_cuda(q, k, v, return_lse=True)
    dout = torch.randn_like(out)
    grads = fa_mod.flash_attention_bwd_cuda(q, k, v, out, lse_t, dout)
    mgrads = fa_mod.flash_attention_bwd_meta(*(_meta(t) for t in (
        q, k, v, out, lse_t, dout)))
    for g, w in zip(grads, mgrads):
        assert _same_layout(w, g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_scan_shape_function_matches_the_kernel(cuda, dtype, init):
    from repro_torch.kernels import ssd_scan as ssd_mod
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(2, 100, 8, 16, 32, 2, dtype, cuda,
                                       init=init)
    got = ssd_mod.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=32, init_state=s0,
                                return_scratch=True)
    want = ssd_mod.ssd_scan_meta(*(_meta(t) for t in (x, dt, A, Bm, Cm)),
                                 chunk=32, init_state=_meta(s0),
                                 return_scratch=True)
    for g, w in zip(got, want):
        assert _same_layout(w, g)
    y, final, dacs, states = got
    dy = torch.randn_like(y)
    grads = ssd_mod.ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, dacs, states, final,
                                      dy, None, chunk=32)
    mgrads = ssd_mod.ssd_scan_bwd_meta(
        *(_meta(t) for t in (x, dt, A, Bm, Cm, dacs, states, final, dy)),
        None, chunk=32)
    for g, w in zip(grads, mgrads):
        assert _same_layout(w, g)


@pytest.mark.cuda
def test_hot_gather_shape_function_matches_the_kernel(cuda):
    from repro_torch.kernels.hot_gather import hot_gather_meta
    table, hot_ids, idx = _inputs(512, 64, 8, 100, torch.bfloat16, cuda)
    rows = table.index_select(0, hot_ids)
    got = ops.hot_gather(table, rows, hot_ids, idx)
    assert _same_layout(hot_gather_meta(*(_meta(t) for t in (
        table, rows, hot_ids, idx))), got)


@pytest.mark.cuda
def test_shape_functions_raise_where_the_kernels_raise(cuda):
    """Each case raises on the card, and its shape function raises the
    same error type on meta tensors of the same layout."""
    from repro_torch.kernels import hot_gather as hg_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    q, k, v = _fa_inputs(1, 8, 8, 4, 2, 64, torch.bfloat16, cuda)
    x, dt, A, Bm, Cm, _ = _ssd_inputs(1, 16, 4, 8, 8, 1, torch.float32,
                                      cuda)
    table, hot_ids, idx = _inputs(64, 8, 4, 16, torch.float32, cuda)
    rows = table.index_select(0, hot_ids)
    cases = [
        (fa_mod.flash_attention_cuda, fa_mod.flash_attention_meta,
         (q, k.float(), v), {}),                            # mixed dtypes
        (fa_mod.flash_attention_cuda, fa_mod.flash_attention_meta,
         (q[..., :60], k[..., :60], v[..., :60]), {}),      # D % 8
        (fa_mod.flash_attention_cuda, fa_mod.flash_attention_meta,
         (q[:, :, :3], k, v), {}),                          # H % Hkv
        (ssd_mod.ssd_scan_cuda, ssd_mod.ssd_scan_meta,
         (x, dt, A, Bm, Cm), {"chunk": 2048}),              # chunk > 1024
        (ssd_mod.ssd_scan_cuda, ssd_mod.ssd_scan_meta,
         (x, dt.bfloat16(), A, Bm, Cm), {"chunk": 8}),      # dt not f32
        (hg_mod.hot_gather_cuda, hg_mod.hot_gather_meta,
         (table, rows, hot_ids, idx.long()), {}),           # int64 ids
    ]
    for kern, shape_fn, args, kw in cases:
        with pytest.raises((TypeError, ValueError)) as on_card:
            kern(*args, **kw)
        with pytest.raises(on_card.type):
            shape_fn(*(_meta(t) for t in args), **kw)
