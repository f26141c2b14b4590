"""Tests of the port that need a CUDA card (the CUDA kernels have no CPU
mode); they skip without one.  This file imports no JAX, so it also runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR

SHAPES = [(64, 16, 4, 32), (512, 64, 8, 100), (128, 32, 1, 7),
          (32064, 4096, 32, 512),
          # every access width: 12-byte f32 rows, 10-byte bf16 rows
          (40, 3, 5, 64), (40, 5, 5, 64),
          # a hot set too large to stage in shared memory
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


def test_ssd_scan_force_kernel_on_cpu_tensors_raises():
    x, dt, A, Bm, Cm, _ = _ssd_inputs(1, 16, 2, 4, 8, 1, torch.float32,
                                      "cpu")
    with pytest.raises(RuntimeError, match="force='kernel' needs CUDA"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=8, force="kernel")
