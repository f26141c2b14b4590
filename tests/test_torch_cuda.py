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
