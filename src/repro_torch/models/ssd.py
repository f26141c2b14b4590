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
    v = dt.to(f32) + params["dt_bias"].to(f32)
    dt = torch.logaddexp(v, torch.zeros((), dtype=f32, device=v.device))
    A = -torch.exp(params["A_log"].to(f32))
    return x_in, Bm, Cm, dt, A


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
