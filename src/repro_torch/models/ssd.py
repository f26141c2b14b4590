"""Mamba2 (SSD — state-space duality) block.

Ported from ``repro.models.ssd``.  A single input projection produces
(z, xBC, dt); xBC passes through a short causal depthwise conv; the SSD
chunked scan runs per head; the output is gated-RMSNormed and projected
back.  Sequence compute goes to ``kernels.ops.ssd_scan`` (the CUDA
kernel on the card, the plain version on the CPU); decode is an O(1)
state update in plain PyTorch.

The scan reads x, B and C as strided views of the conv output (no
copies); ``softplus`` is ``logaddexp(x, 0)`` as ``jax.nn.softplus`` is
(``torch.nn.functional.softplus`` switches to ``x`` above 20).

Partitioned (:func:`mamba_forward_tp`, the
tensor-parallel layout of ``distributed/tensor_parallel.py``): by the
reference's rules ``in_proj``'s columns, the conv weights and state
(``ssm_in``) and the heads (``ssm_heads``) split over the model axis,
each leaf by its own spec, so a coordinate's column block, conv block
and heads need not line up; two exchanges over the model group carry
each piece where it is used, the gated RMSNorm sums its squares over the
group, and ``out_proj`` is row-parallel.  Each state block is written at
its own coordinate.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..kernels import ops as kops
from .config import ModelConfig, SSMConfig
from .layers import rmsnorm
from .params import Initializer

f32 = torch.float32


def _dims(cfg: ModelConfig):
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return s, d_inner, H, conv_ch


def init_mamba(ini: Initializer, cfg: ModelConfig):
    s, d_inner, H, conv_ch = _dims(cfg)
    d = cfg.d_model
    in_dim = 2 * d_inner + 2 * s.n_groups * s.d_state + H
    return {
        "in_proj": ini.normal((d, in_dim)),
        "conv_w": ini.normal((s.conv_width, conv_ch), fan_in=s.conv_width),
        "conv_b": ini.zeros((conv_ch,)),
        "A_log": ini.constant(
            np.log(np.linspace(1.0, 16.0, H, dtype=np.float32)), dtype=f32),
        "D": ini.ones((H,), dtype=f32),
        "dt_bias": ini.zeros((H,), dtype=f32),
        "norm_scale": ini.ones((d_inner,), dtype=f32),
        "out_proj": ini.normal((d_inner, d), fan_in=d_inner),
    }


def _split(params, cfg: ModelConfig, x: torch.Tensor):
    s, d_inner, H, conv_ch = _dims(cfg)
    zxbcdt = x @ params["in_proj"]
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_ch]
    dt = zxbcdt[..., d_inner + conv_ch:]
    return z, xBC, dt


def _conv_full(params, xBC: torch.Tensor, width: int) -> torch.Tensor:
    """Causal depthwise conv over (B, S, C)."""
    pad = F.pad(xBC, (0, 0, width - 1, 0))
    S = xBC.shape[1]
    acc = torch.zeros(xBC.shape, dtype=f32, device=xBC.device) \
        + params["conv_b"].to(f32)
    for i in range(width):                       # static small width
        acc = acc + (params["conv_w"][i].to(f32) * pad[:, i:i + S].to(f32))
    return F.silu(acc).to(xBC.dtype)


def _conv_step(params, xBC_t: torch.Tensor, conv_state: torch.Tensor,
               width: int):
    """xBC_t: (B, C) new input; conv_state: (B, width-1, C) past inputs."""
    hist = torch.cat([conv_state, xBC_t[:, None, :]], dim=1)
    out = torch.einsum("wc,bwc->bc", params["conv_w"].to(f32),
                       hist.to(f32)) + params["conv_b"].to(f32)
    return F.silu(out).to(xBC_t.dtype), hist[:, 1:, :]


def _ssd_inputs(params, cfg: ModelConfig, xBC: torch.Tensor,
                dt: torch.Tensor):
    s, d_inner, H, _ = _dims(cfg)
    G, N, P = s.n_groups, s.d_state, s.head_dim
    lead = xBC.shape[:-1]
    x_in = xBC[..., :d_inner].reshape(*lead, H, P)
    Bm = xBC[..., d_inner:d_inner + G * N].reshape(*lead, G, N)
    Cm = xBC[..., d_inner + G * N:].reshape(*lead, G, N)
    return x_in, Bm, Cm, _softplus_dt(params, dt), _decay(params)


def _softplus_dt(params, dt: torch.Tensor) -> torch.Tensor:
    """``softplus(dt + dt_bias)`` in f32 (``dt_bias`` of dt's heads)."""
    v = dt.to(f32) + params["dt_bias"].to(f32)
    return torch.logaddexp(v, torch.zeros((), dtype=f32, device=v.device))


def _decay(params) -> torch.Tensor:
    """``A = -exp(A_log)`` in f32."""
    return -torch.exp(params["A_log"].to(f32))


def _gate_out(params, cfg: ModelConfig, y, x_in, z, shape):
    """Skip term, gated RMSNorm and the output projection."""
    y = y + (params["D"].to(f32)[:, None] * x_in.to(f32)).to(y.dtype)
    y = y.reshape(shape)
    y = rmsnorm({"scale": params["norm_scale"]},
                y * F.silu(z.to(f32)).to(y.dtype), cfg.rms_eps)
    return y @ params["out_proj"]


def mamba_forward_with_state(params, cfg: ModelConfig, x: torch.Tensor, *,
                             init_state: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward threading the SSD recurrent state:
    ``init_state`` (B, H, P, N) float32 seeds the scan (None = the zero
    state, bitwise the same as explicit zeros) and the final state is
    returned with the output.  The serving entry point for per-slot
    session state kept in an RW table: gather saved state -> forward ->
    write final state back."""
    s, d_inner, H, _ = _dims(cfg)
    B, S, _ = x.shape
    z, xBC, dt = _split(params, cfg, x)
    xBC_conv = _conv_full(params, xBC, s.conv_width)
    x_in, Bm, Cm, dt_sp, A = _ssd_inputs(params, cfg, xBC_conv, dt)
    y, final_state = kops.ssd_scan(x_in, dt_sp, A, Bm, Cm, chunk=s.chunk,
                                   init_state=init_state)
    return _gate_out(params, cfg, y, x_in, z, (B, S, d_inner)), final_state


def mamba_forward(params, cfg: ModelConfig, x: torch.Tensor, *,
                  cache=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence forward from the zero state.  With ``cache`` (only
    its dtypes are read) it also returns the final (conv, ssm) state for
    subsequent decode, as new tensors."""
    s, d_inner, H, _ = _dims(cfg)
    B, S, _ = x.shape
    z, xBC, dt = _split(params, cfg, x)
    xBC_conv = _conv_full(params, xBC, s.conv_width)
    x_in, Bm, Cm, dt_sp, A = _ssd_inputs(params, cfg, xBC_conv, dt)
    y, final_state = kops.ssd_scan(x_in, dt_sp, A, Bm, Cm, chunk=s.chunk)
    out = _gate_out(params, cfg, y, x_in, z, (B, S, d_inner))
    new_cache = None
    if cache is not None:
        # the last width-1 raw conv inputs, left-padded with the zeros the
        # causal conv saw when the prompt is shorter (the reference keeps
        # fewer rows then, and its next decode step raises)
        w1 = s.conv_width - 1
        conv_state = F.pad(xBC[:, max(0, S - w1):, :],
                           (0, 0, max(0, w1 - S), 0))
        new_cache = {"conv": conv_state.to(cache["conv"].dtype),
                     "ssm": final_state.to(cache["ssm"].dtype)}
    return out, new_cache


def mamba_decode(params, cfg: ModelConfig, x: torch.Tensor, cache: dict
                 ) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, D); cache: {"conv": (B, w-1, C), "ssm": (B, H, P, N)}."""
    s, d_inner, H, _ = _dims(cfg)
    B = x.shape[0]
    z, xBC, dt = _split(params, cfg, x)
    xBC_t, new_conv = _conv_step(params, xBC[:, 0, :],
                                 cache["conv"].to(xBC.dtype), s.conv_width)
    x_in, Bm, Cm, dt_sp, A = _ssd_inputs(params, cfg, xBC_t[:, None, :], dt)
    y, new_ssm = kops.ssd_decode(x_in[:, 0], dt_sp[:, 0], A, Bm[:, 0],
                                 Cm[:, 0], cache["ssm"].to(f32))
    out = _gate_out(params, cfg, y, x_in[:, 0], z, (B, 1, d_inner))
    return out, {"conv": new_conv.to(cache["conv"].dtype),
                 "ssm": new_ssm.to(cache["ssm"].dtype)}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=f32,
                     device="cuda"):
    s, d_inner, H, conv_ch = _dims(cfg)
    dev = resolve_device(device)
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_ch), dtype=dtype,
                            device=dev),
        "ssm": torch.zeros((batch, H, s.head_dim, s.d_state), dtype=f32,
                           device=dev),
    }


# ---------------------------------------------------------------------------
# The partitioned layout (distributed/tensor_parallel.py)
# ---------------------------------------------------------------------------

def _tp_ranges(run, cfg: ModelConfig, sh, state_sh) -> dict:
    """``{c: ranges}`` of each traced coordinate, by the stacked leaves'
    shardings ``sh`` (params) and ``state_sh`` (its ``conv`` / ``ssm``
    cache): ``heads`` [h0, h1) (``A_log``'s block, split over the model
    axis: ``TPRun`` checks it), ``ch`` their d_inner channels, ``conv``
    its conv block's channels (``conv_w``'s, which ``conv_b`` and the
    conv state must share), ``cols`` its ``in_proj`` columns and
    ``groups`` the B / C groups its heads read.  ``norm_scale`` and
    ``out_proj`` must be whole or split with the heads; the ssm state's
    heads must be the coordinate's.  Anything else raises."""
    s, d_inner, H, conv_ch = _dims(cfg)
    P, G = s.head_dim, s.n_groups
    in_dim = 2 * d_inner + 2 * G * s.d_state + H
    per_group = H // G
    out = {}
    for c in run.coords:
        h0, h1 = sh["A_log"].range_at(c, 1, H)
        ch = (h0 * P, h1 * P)
        conv = sh["conv_w"].range_at(c, 2, conv_ch)
        for what, got in (("conv_b", sh["conv_b"].range_at(c, 1, conv_ch)),
                          ("the conv state",
                           state_sh["conv"].range_at(c, 3, conv_ch))):
            if got != conv:
                raise ValueError(
                    f"{what}'s block at {c} holds conv channels {got}, "
                    f"conv_w's {conv}")
        if state_sh["ssm"].range_at(c, 2, H) != (h0, h1):
            raise ValueError(
                f"the ssm state's block at {c} holds heads "
                f"{state_sh['ssm'].range_at(c, 2, H)}, A_log's {(h0, h1)}")
        for name in ("norm_scale", "out_proj"):
            got = sh[name].range_at(c, 1, d_inner)
            if got not in ((0, d_inner), ch):
                raise ValueError(
                    f"{name}'s block at {c} holds channels {got}; its heads "
                    f"{h0}..{h1 - 1} own {ch}")
        n = h1 - h0
        if n % per_group and per_group % n:
            raise NotImplementedError(
                f"heads {h0}..{h1 - 1} straddle B / C groups of {per_group} "
                f"unevenly")
        out[c] = {"heads": (h0, h1), "ch": ch, "conv": conv,
                  "cols": sh["in_proj"].range_at(c, 2, in_dim),
                  "groups": (h0 // per_group, (h1 - 1) // per_group + 1)}
    return out


def mamba_forward_tp(run, cfg: ModelConfig, p: dict, sh, h: dict, mc: dict,
                     state_sh, write) -> dict:
    """:func:`mamba_forward` (:func:`mamba_decode` for one token, as
    :func:`transformer.layer_forward` branches) over a cache, partitioned
    (``distributed/tensor_parallel.py``) by the reference's rules
    (``ssm_in`` and ``ssm_heads`` over the model axis): ``h[c]`` is
    coordinate c's rows (B_l, S, D), ``p[c]`` its blocks of the layer's
    params, ``sh`` their stacked shardings, ``mc[c]`` its blocks of the
    layer's ``conv`` / ``ssm`` state, ``state_sh`` their stacked
    shardings, ``write(name, {c: value})`` the writer of a state leaf's
    placed blocks (each at its own coordinate).  Returns ``{c: (B_l, S,
    D)}``.  Coordinate c:

    1. multiplies its rows by its block of ``in_proj``'s columns
       ``[z | x | B | C | dt]`` (blocks that need not line up with the
       heads; a whole leaf is read whole);
    2. receives over its model group the raw xBC channels of its conv
       block and the z and dt columns of its heads (``TPRun.exchange``);
    3. runs the causal conv + SiLU on its conv block in f32, where its
       conv weights and state lie (one token: ``_conv_step`` over the
       block's state), then receives its heads' x channels, and B and C
       all-gathered;
    4. runs ``ops.ssd_scan`` on its H / n_model heads (one token:
       ``ops.ssd_decode`` over its ssm block), the skip term and the gate
       ``y * silu(z)``;
    5. normalises over the whole d_inner: its sum of squares, summed over
       the model group in model order (one all-reduce), over d_inner;
    6. multiplies by its rows of ``out_proj``, one all-reduce;
    7. writes the new state of its heads and the last width-1 raw inputs
       of its conv block (left-padded with zeros for a prompt shorter
       than that) to the placed blocks.

    The arithmetic is :func:`mamba_forward`'s; only the norm's sum and
    the projections' sums run in another order."""
    s, d_inner, H, conv_ch = _dims(cfg)
    P, N, G, w = s.head_dim, s.d_state, s.n_groups, s.conv_width
    GN = G * N
    R = _tp_ranges(run, cfg, sh, state_sh)
    decode = next(iter(h.values())).shape[1] == 1

    # 1. in_proj column-parallel; 2. each coordinate receives the raw xBC
    # channels of its conv block and the z and dt columns of its heads
    zx = run.each(lambda c: h[c] @ p[c]["in_proj"])

    def cols(span):
        return lambda c, g: run.pieces(c, g, *span(c),
                                       lambda m: R[m]["cols"],
                                       lambda m, i, j: zx[m][..., i:j])
    dt0 = d_inner + conv_ch
    xbc = run.exchange(cols(lambda c: (d_inner + R[c]["conv"][0],
                                       d_inner + R[c]["conv"][1])), 2)
    z = run.exchange(cols(lambda c: R[c]["ch"]), 2)
    dt = run.exchange(cols(lambda c: (dt0 + R[c]["heads"][0],
                                      dt0 + R[c]["heads"][1])), 2)

    # 3. the causal conv + SiLU on the conv block, where its weights and
    # state lie; then the x channels of each coordinate's heads, and B
    # and C gathered (every head reads them)
    conv_p = {c: {"conv_w": p[c]["conv_w"], "conv_b": p[c]["conv_b"]}
              for c in run.coords}
    if decode:
        step = run.each(lambda c: _conv_step(
            conv_p[c], xbc[c][:, 0], mc[c]["conv"].to(xbc[c].dtype), w))
        xc = run.each(lambda c: step[c][0][:, None, :])
        new_conv = {c: step[c][1] for c in run.coords}
    else:
        xc = run.each(lambda c: _conv_full(conv_p[c], xbc[c], w))
        w1 = w - 1

        def last_inputs(c):
            # the last width-1 raw inputs, left-padded as mamba_forward's
            S = xbc[c].shape[1]
            return F.pad(xbc[c][:, max(0, S - w1):, :],
                         (0, 0, max(0, w1 - S), 0))
        new_conv = run.each(last_inputs)

    def chans(span, kind="all-to-all"):
        return run.exchange(lambda c, g: run.pieces(
            c, g, *span(c), lambda m: R[m]["conv"],
            lambda m, i, j: xc[m][..., i:j]), 2, kind)
    x_h = chans(lambda c: R[c]["ch"])
    bc = chans(lambda c: (d_inner, d_inner + 2 * GN), "all-gather")

    # 4. the scan (or the one-token update) on the coordinate's heads,
    # the skip term and the gate
    def scan(c):
        (h0, h1), (g0, g1) = R[c]["heads"], R[c]["groups"]
        lead = x_h[c].shape[:-1]
        x_in = x_h[c].reshape(*lead, h1 - h0, P)
        Bm = bc[c][..., :GN].reshape(*lead, G, N)
        Cm = bc[c][..., GN:].reshape(*lead, G, N)
        if (g0, g1) != (0, G):
            Bm, Cm = Bm[..., g0:g1, :], Cm[..., g0:g1, :]
        dt_sp, A = _softplus_dt(p[c], dt[c]), _decay(p[c])
        if decode:
            y, new = kops.ssd_decode(x_in[:, 0], dt_sp[:, 0], A, Bm[:, 0],
                                     Cm[:, 0], mc[c]["ssm"].to(f32))
            x_in = x_in[:, 0]
        else:
            y, new = kops.ssd_scan(x_in, dt_sp, A, Bm, Cm, chunk=s.chunk)
        y = y + (p[c]["D"].to(f32)[:, None] * x_in.to(f32)).to(y.dtype)
        y = y.reshape(*lead, (h1 - h0) * P)
        return y * F.silu(z[c].to(f32)).to(y.dtype), new
    gated = run.each(scan)

    # 5. the gated RMSNorm over the whole d_inner: each coordinate's sum
    # of squares summed over the model group, divided by d_inner;
    # 6. out_proj row-parallel over the coordinate's channels
    sq = run.all_reduce(run.each(lambda c: gated[c][0].to(f32).square().sum(
        dim=-1, keepdim=True)))

    def project(c):
        g = gated[c][0]
        lo, hi = R[c]["ch"]
        scale, wout = p[c]["norm_scale"], p[c]["out_proj"]
        if scale.shape[0] != hi - lo:           # whole: its heads' rows
            scale = scale[lo:hi]
        if wout.shape[0] != hi - lo:
            wout = wout[lo:hi]
        xn = g.to(f32) * torch.rsqrt(sq[c] / d_inner + cfg.rms_eps)
        return (xn * scale).to(g.dtype) @ wout
    out = run.all_reduce(run.each(project))

    # 7. the new state, each block written at its own coordinate
    write("conv", new_conv)
    write("ssm", {c: gated[c][1] for c in run.coords})
    return out
