"""The port's SSD layer against the reference's, on the same numpy inputs:
the plain ``ssd_scan_ref`` / ``ssd_decode_ref`` against the Pallas
kernel in interpret mode and the jnp oracles (the reference kernel
test's tolerances: y 2e-5 f32 / 2e-2 bf16, the state 1e-3), the
dispatcher's CPU rule, the Mamba2 block with the reference's weights
carried across (atol=rtol=1e-5 in f32: the same arithmetic summed in
other orders), the SSD fast path's injected branch, and the configs.
The CUDA kernel itself is tested on the card by ``test_torch_cuda.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS, get_config as j_get_config
from repro.kernels import ref as R
from repro.kernels.ssd_scan import ssd_scan_kernel
from repro.models import ssd as JS
from repro.models.params import Initializer as JInitializer, unzip
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.passes.ssd_fastpath import ssd_init_state_hotpath
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.models import ssd as TS
from repro_torch.models.params import Initializer, tree_from_numpy

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
# tests/test_kernels.py's sweep (B, S, H, P, N, chunk) with G = 1, and
# G = 2 cases (the reference kernel takes G = 1 only: those go to the
# oracle alone)
SHAPES = [(1, 32, 4, 8, 16, 8, 1), (2, 48, 8, 16, 32, 16, 1),
          (1, 40, 2, 8, 16, 16, 1), (2, 64, 8, 16, 16, 32, 1),
          (2, 50, 8, 16, 32, 16, 2), (1, 24, 4, 8, 8, 8, 4)]


def _tol(tdt):
    return dict(rtol=2e-2, atol=2e-2) if tdt == torch.bfloat16 else \
        dict(rtol=2e-5, atol=2e-5)


def _inputs(B, S, H, P, N, G, seed=0, init=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(B, S, H, P)
    dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32)     # softplus
    A = (-np.exp(f(H) * 0.5)).astype(np.float32)
    Bm = f(B, S, G, N) * np.float32(0.3)
    Cm = f(B, S, G, N) * np.float32(0.3)
    s0 = f(B, H, P, N) * np.float32(0.1) if init else None
    return x, dt, A, Bm, Cm, s0


def _jax(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _torch(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk,G", SHAPES)
def test_ssd_scan_plain_matches_reference(B, S, H, P, N, chunk, G, jdt,
                                          tdt):
    x, dt, A, Bm, Cm, _ = _inputs(B, S, H, P, N, G)
    jargs = (_jax(x, jdt), _jax(dt), _jax(A), _jax(Bm, jdt), _jax(Cm, jdt))
    y, fin = TR.ssd_scan_ref(_torch(x, tdt), _torch(dt), _torch(A),
                             _torch(Bm, tdt), _torch(Cm, tdt), chunk)
    assert y.dtype == tdt and fin.dtype == torch.float32
    yr, finr = R.ssd_scan_ref(*jargs, chunk)
    np.testing.assert_allclose(_np(y), _np(yr), **_tol(tdt))
    np.testing.assert_allclose(_np(fin), _np(finr), rtol=1e-3, atol=1e-3)
    if G == 1:
        hblk = 4 if H % 4 == 0 else H
        yk, fink = ssd_scan_kernel(*jargs, chunk=chunk, hblk=hblk,
                                   interpret=True)
        np.testing.assert_allclose(_np(y), _np(yk), **_tol(tdt))
        np.testing.assert_allclose(_np(fin), _np(fink), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("B,S,H,P,N,chunk,G", SHAPES[:2] + SHAPES[4:5])
def test_ssd_scan_plain_with_initial_state_matches_reference(
        B, S, H, P, N, chunk, G):
    x, dt, A, Bm, Cm, s0 = _inputs(B, S, H, P, N, G, seed=3, init=True)
    y, fin = TR.ssd_scan_ref(*map(_torch, (x, dt, A, Bm, Cm)), chunk,
                             init_state=_torch(s0))
    yr, finr = R.ssd_scan_ref(*map(_jax, (x, dt, A, Bm, Cm)), chunk,
                              init_state=_jax(s0))
    np.testing.assert_allclose(_np(y), _np(yr), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(fin), _np(finr), rtol=1e-3, atol=1e-3)


def test_ssd_scan_none_init_is_bitwise_zero_init():
    x, dt, A, Bm, Cm, _ = _inputs(2, 40, 4, 8, 16, 2)
    args = tuple(map(_torch, (x, dt, A, Bm, Cm)))
    y0, f0 = TR.ssd_scan_ref(*args, 16)
    y1, f1 = TR.ssd_scan_ref(*args, 16, init_state=torch.zeros_like(f0))
    assert torch.equal(y0, y1) and torch.equal(f0, f1)


def test_ssd_scan_chunk_invariance():
    """The chunk size is a tiling choice — results must not depend on it."""
    x, dt, A, Bm, Cm, _ = _inputs(1, 64, 4, 8, 16, 1, seed=5)
    args = tuple(map(_torch, (x, dt, A, Bm, Cm)))
    y8, f8 = TR.ssd_scan_ref(*args, 8)
    y32, f32_ = TR.ssd_scan_ref(*args, 32)
    torch.testing.assert_close(y8, y32, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(f8, f32_, rtol=1e-4, atol=1e-4)


def test_ssd_decode_matches_scan_and_the_reference():
    """Step-by-step decode tracks the chunked scan state, and each step
    matches the reference's decode."""
    x, dt, A, Bm, Cm, _ = _inputs(1, 16, 2, 4, 8, 1, seed=7)
    tx, tdt_, tA, tB, tC = map(_torch, (x, dt, A, Bm, Cm))
    y_scan, fin = TR.ssd_scan_ref(tx, tdt_, tA, tB, tC, 8)
    state = torch.zeros(1, 2, 4, 8)
    jstate = jnp.zeros((1, 2, 4, 8))
    ys = []
    for t in range(16):
        y_t, state = ops.ssd_decode(tx[:, t], tdt_[:, t], tA, tB[:, t],
                                    tC[:, t], state)
        jy, jstate = R.ssd_decode_ref(_jax(x[:, t]), _jax(dt[:, t]),
                                      _jax(A), _jax(Bm[:, t]),
                                      _jax(Cm[:, t]), jstate)
        np.testing.assert_allclose(_np(y_t), _np(jy), rtol=1e-5, atol=1e-5)
        ys.append(y_t)
    torch.testing.assert_close(torch.stack(ys, dim=1), y_scan, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(state, fin, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(state), _np(jstate), rtol=1e-5,
                               atol=1e-5)


def test_ops_ssd_scan_takes_the_plain_version_on_cpu():
    x, dt, A, Bm, Cm, s0 = _inputs(2, 40, 4, 8, 16, 2, init=True)
    args = tuple(map(_torch, (x, dt, A, Bm, Cm)))
    y, fin = ops.ssd_scan(*args, chunk=16, init_state=_torch(s0))
    yr, finr = TR.ssd_scan_ref(*args, 16, init_state=_torch(s0))
    assert torch.equal(y, yr) and torch.equal(fin, finr)
    assert "ssd_scan" not in ops.launches()


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

MAMBA_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def mamba():
    """mamba2-1.3b's smoke config (d_model 64, 16 heads x P 8, N 16,
    chunk 16) and the reference's f32 weights in both packages."""
    cfg = j_get_config("mamba2-1.3b").smoke()
    ini = JInitializer(jax.random.PRNGKey(3), dtype=jnp.float32)
    jp, _ = unzip(JS.init_mamba(ini, cfg))
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, get_config("mamba2-1.3b").smoke(), jp, tp


def _x(B, S, d, seed=11):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def test_mamba_forward_with_state_matches_reference(mamba):
    jcfg, tcfg, jp, tp = mamba
    x = _x(2, 40, jcfg.d_model)                   # S not a chunk multiple
    s0 = (np.random.default_rng(2).standard_normal((2, 16, 8, 16))
          * 0.1).astype(np.float32)
    for init in (None, s0):
        out, fin = TS.mamba_forward_with_state(tp, tcfg, _torch(x),
                                               init_state=_torch(init))
        jout, jfin = JS.mamba_forward_with_state(jp, jcfg, _jax(x),
                                                 init_state=_jax(init))
        np.testing.assert_allclose(_np(out), _np(jout), **MAMBA_TOL)
        np.testing.assert_allclose(_np(fin), _np(jfin), **MAMBA_TOL)


def test_mamba_forward_and_decode_match_reference(mamba):
    jcfg, tcfg, jp, tp = mamba
    B = 2
    x = _x(B, 32, jcfg.d_model, seed=12)
    cache = TS.init_mamba_cache(tcfg, B, device="cpu")
    jcache = JS.init_mamba_cache(jcfg, B)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    out, cache = TS.mamba_forward(tp, tcfg, _torch(x[:, :24]), cache=cache)
    jout, jcache = JS.mamba_forward(jp, jcfg, _jax(x[:, :24]),
                                    cache=jcache)
    np.testing.assert_allclose(_np(out), _np(jout), **MAMBA_TOL)
    for k in cache:
        np.testing.assert_allclose(_np(cache[k]), _np(jcache[k]),
                                   **MAMBA_TOL)
    for t in range(24, 32):
        out, cache = TS.mamba_decode(tp, tcfg, _torch(x[:, t:t + 1]), cache)
        jout, jcache = JS.mamba_decode(jp, jcfg, _jax(x[:, t:t + 1]),
                                       jcache)
        np.testing.assert_allclose(_np(out), _np(jout), **MAMBA_TOL)
        np.testing.assert_allclose(_np(cache["ssm"]), _np(jcache["ssm"]),
                                   **MAMBA_TOL)


def test_softplus_is_logaddexp_above_torch_threshold(mamba):
    """``jax.nn.softplus`` is log(1 + e^x) everywhere; torch's softplus
    returns x above 20.  The port's dt must follow the reference."""
    jcfg, tcfg, jp, tp = mamba
    xBC = torch.zeros(1, 1, 64 * 2 + 2 * 16)
    dt = torch.full((1, 1, 16), 20.5)
    *_, dt_sp, _ = TS._ssd_inputs(tp, tcfg, xBC, dt)
    ref = jax.nn.softplus(jnp.full((16,), 20.5) + jp["dt_bias"])
    np.testing.assert_array_equal(_np(dt_sp[0, 0]), _np(ref))


def test_init_mamba_shapes_and_constants_match_reference(mamba):
    jcfg, tcfg, jp, _ = mamba
    tp = TS.init_mamba(Initializer(0, "cpu"), tcfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    for k in ("D", "dt_bias", "norm_scale", "conv_b"):
        np.testing.assert_array_equal(_np(tp[k]), _np(jp[k]))
    # numpy's log and XLA's differ by an ulp on some inputs
    np.testing.assert_allclose(_np(tp["A_log"]), _np(jp["A_log"]),
                               rtol=1e-6, atol=0)
    assert tp["A_log"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the SSD fast path's injected branch, configs
# ---------------------------------------------------------------------------

def test_ssd_init_state_hotpath_fresh_batch_never_gathers():
    def gather():
        raise AssertionError("the fast branch touched the state table")
    init = ssd_init_state_hotpath(torch.zeros(3, dtype=torch.int32), gather,
                                  (3, 2, 4, 8))
    assert init.dtype == torch.float32 and init.shape == (3, 2, 4, 8)
    assert not init.any()


def test_ssd_init_state_hotpath_warm_batch_gathers_saved_rows():
    table = torch.arange(5 * 64, dtype=torch.float32).reshape(5, 64)
    slot = torch.tensor([4, 1, 2], dtype=torch.int32)
    counts = torch.tensor([0, 3, 0], dtype=torch.int32)
    init = ssd_init_state_hotpath(
        counts, lambda: table.index_select(0, slot), (3, 2, 4, 8))
    assert torch.equal(init, table[slot.long()].reshape(3, 2, 4, 8))


def test_ctx_table_array_reads_without_registering_a_site():
    from repro_torch.core import GENERIC_PLAN, PlaneState, SketchConfig
    from repro_torch.core.ctx import DataPlaneCtx
    from repro_torch.core.tables import analysis_sites, analyzing
    state = torch.ones(4, 8)
    ctx = DataPlaneCtx(GENERIC_PLAN, PlaneState(
        {"ssm_state": {"state": state}}, {}, {}), SketchConfig())
    with analyzing():
        assert ctx.table_array("ssm_state", "state") is state
        assert analysis_sites() == []


def test_initializer_constant_copies_value_in_dtype():
    v = np.log(np.linspace(1.0, 16.0, 5, dtype=np.float32))
    t = Initializer(0, "cpu").constant(v, dtype=torch.float32)
    np.testing.assert_array_equal(t.numpy(), v)
    v[0] = 7.0
    assert t[0].item() != 7.0


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_configs_and_smoke_reduction_equal_the_reference(arch):
    assert ARCH_IDS == J_ARCH_IDS
    for t, j in ((get_config(arch), j_get_config(arch)),
                 (get_config(arch).smoke(), j_get_config(arch).smoke())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
