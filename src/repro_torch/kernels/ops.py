"""Public kernel entry points.

Each op dispatches by where its tensors lie: a CUDA tensor always takes
the hand-written kernel (which raises on what it does not take — there
is no fallback), a CPU tensor takes the plain PyTorch version from
``ref.py`` (bitwise the same semantics), and a ``meta`` tensor the
kernel's shape function (``*_meta`` beside each wrapper: the wrapper's
checks, then empty outputs of its shapes and dtypes; it computes
nothing), so a step traced on ``meta`` raises where the card would.
``force="kernel"`` asserts the kernel path and raises on CPU tensors.

Under a recorder (``launch/op_analysis.py``) every call, on any device,
is one call of its kernel with the work ``kernels/work.py`` gives it,
and nothing that runs inside it is counted.  On the host with grad,
the plain version then runs inside an autograd function whose backward
is the plain gradient (``flash_attention_bwd_ref``,
``ssd_scan_bwd_ref``), so that the backward too is one kernel call, as
on the card; without a recorder autograd runs through the plain version
as ever.

Under autograd on the card, ``flash_attention`` and ``ssd_scan`` go
through ``FlashAttentionFn`` and ``SsdScanFn``, whose backwards are the
hand-written ``flash_attention_bwd`` and ``ssd_scan_bwd`` kernels; so a
model trains on the card through the same kernels it serves with.

``launches()`` / ``reset_launches()`` read and zero the per-kernel
launch counts, so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import ref as _ref
from . import work
from .flash_attention import (FlashAttentionFn, flash_attention_cuda,
                              flash_attention_meta)
from .hot_gather import LAUNCHES, hot_gather_cuda, hot_gather_meta
from .ssd_scan import SsdScanFn, ssd_scan_cuda, ssd_scan_meta


def _route(t: torch.Tensor, force: Optional[str]) -> str:
    """``"kernel"`` (a CUDA tensor), ``"meta"`` (the shape function) or
    ``"plain"`` (a host tensor)."""
    if force not in (None, "kernel"):
        raise ValueError(f"force must be None or 'kernel', got {force!r}")
    if t.device.type == "cuda":
        return "kernel"
    if t.device.type == "meta":
        return "meta"
    if force == "kernel":
        raise RuntimeError(
            f"force='kernel' needs CUDA tensors; got a tensor on {t.device} "
            f"(the CUDA kernels do not run on the host)")
    return "plain"


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _dense(x):
    """A plain version's outputs laid out as the kernel writes its own
    (dense), so that what follows them dispatches the same operations."""
    if isinstance(x, (tuple, list)):
        return type(x)(_dense(t) for t in x)
    return None if x is None else x.contiguous()


class _PlainFlashFn(torch.autograd.Function):
    """The plain attention with its plain gradient as one backward call:
    the host's path under a recorder (the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_softcap, block):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window,
                        logit_softcap=logit_softcap)
        ctx.block = block
        return _dense(_ref.flash_attention_ref(q, k, v, block=block,
                                               **ctx.opts))

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        o = ctx.opts
        with work.kernel_call("flash_attention_bwd",
                              lambda: work.flash_attention_bwd_work(
                                  q, k, causal=o["causal"],
                                  window=o["window"])) as outs:
            grads = _dense(_ref.flash_attention_bwd_ref(
                q, k, v, dout, block=ctx.block, **o))
            outs.append(grads)
        return (*grads, None, None, None, None)


class _PlainSsdFn(torch.autograd.Function):
    """The plain scan with its plain gradient as one backward call: the
    host's path under a recorder (the module docstring)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        ctx.chunk = chunk
        return _dense(_ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk,
                                        init_state=init_state))

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm, s0 = ctx.saved_tensors
        with work.kernel_call("ssd_scan_bwd", lambda: work.ssd_scan_bwd_work(
                x, Bm, chunk=ctx.chunk)) as outs:
            grads = _dense(_ref.ssd_scan_bwd_ref(
                x, dt, A, Bm, Cm, ctx.chunk,
                torch.zeros_like(x) if dy is None else dy, dfinal,
                init_state=s0))
            outs.append(grads)
        return (*grads, None)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, logit_softcap: float = 0.0,
                    block: int = 512, force: Optional[str] = None,
                    return_lse: bool = False):
    """Attention over the implicit positions ``arange(Sq)`` /
    ``arange(Sk)``.  On the card always the CUDA kernel, which raises on
    a shape, dtype or stride it does not take (``block`` sizes only the
    plain version's key blocks).  With grad enabled and an input that
    requires it, the kernel goes through ``FlashAttentionFn``, whose
    backward is the ``flash_attention_bwd`` kernel; every other call is
    the plain launch.  On the host autograd runs through the plain
    version.

    ``return_lse=True`` returns ``(out, lse)``: lse is each row's
    logsumexp, f32 (B, H, Sq) in log2 units, ``NEG_INF`` for a row that
    sees no key — what the kernel writes beside its output (the output is
    the same bits either way), and on the host the plain
    ``attend_blocked``'s from its own running max and sum.  Partials over
    disjoint key ranges combine with weights ``exp2(lse - max)`` (the
    sequence-parallel decode).  No autograd on this form."""
    route = _route(q, force)
    grad = not return_lse and _needs_grad(q, k, v)
    opts = dict(causal=causal, window=window, logit_softcap=logit_softcap)
    with work.kernel_call("flash_attention",
                          lambda: work.flash_attention_work(
                              q, k, causal=causal, window=window,
                              return_lse=return_lse or grad)) as outs:
        if route == "plain" and work.RECORDER is not None:
            res = (_PlainFlashFn.apply(q, k, v, causal, window,
                                       logit_softcap, block) if grad
                   else _dense(_ref.flash_attention_ref(
                       q, k, v, block=block, return_lse=return_lse, **opts)))
        elif route == "plain":
            res = _ref.flash_attention_ref(q, k, v, block=block,
                                           return_lse=return_lse, **opts)
        elif grad:
            res = FlashAttentionFn.apply(q, k, v, causal, window,
                                         logit_softcap)
        else:
            fn = (flash_attention_cuda if route == "kernel"
                  else flash_attention_meta)
            res = fn(q, k, v, return_lse=return_lse, **opts)
        outs.append(res)
    return res


def hot_gather(table, hot_rows, hot_ids, idx, *,
               force: Optional[str] = None) -> torch.Tensor:
    route = _route(table, force)
    fn = {"kernel": hot_gather_cuda, "meta": hot_gather_meta,
          "plain": _ref.hot_gather_ref}[route]
    with work.kernel_call("hot_gather", lambda: work.hot_gather_work(
            table, hot_rows, hot_ids, idx)) as outs:
        out = fn(table, hot_rows, hot_ids, idx)
        outs.append(out)
    return out


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int, init_state=None,
             force: Optional[str] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD chunked scan: ``(y, final_state)``.  On the card always
    the CUDA kernel, which raises on a shape or dtype it does not take
    (the reference's dispatcher silently takes its oracle instead).  With
    grad enabled and an input that requires it, the kernel goes through
    ``SsdScanFn``, whose backward is the ``ssd_scan_bwd`` kernel; every
    other call is the plain launch.  On the host autograd runs through the
    plain version."""
    route = _route(x, force)
    grad = _needs_grad(x, dt, A, Bm, Cm, init_state)
    with work.kernel_call("ssd_scan", lambda: work.ssd_scan_work(
            x, Bm, chunk=chunk, init=init_state is not None,
            scratch=grad)) as outs:
        if route == "plain" and work.RECORDER is not None:
            res = (_PlainSsdFn.apply(x, dt, A, Bm, Cm, init_state, chunk)
                   if grad else _dense(_ref.ssd_scan_ref(
                       x, dt, A, Bm, Cm, chunk, init_state=init_state)))
        elif route == "plain":
            res = _ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk,
                                    init_state=init_state)
        elif grad:
            res = SsdScanFn.apply(x, dt, A, Bm, Cm, init_state, chunk)
        else:
            fn = ssd_scan_cuda if route == "kernel" else ssd_scan_meta
            res = fn(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state)
        outs.append(res)
    return res


def ssd_decode(x, dt, A, Bm, Cm, state, *, force: Optional[str] = None):
    # no kernel: the single-token update is tiny and plain PyTorch on
    # every device, as it is plain jnp in the reference
    return _ref.ssd_decode_ref(x, dt, A, Bm, Cm, state)


def onehot_lookup(table, idx, *, force: Optional[str] = None):
    # no kernel: the one-hot matmul is plain PyTorch on every device,
    # as it is plain jnp in the reference
    return _ref.onehot_lookup_ref(table, idx)


def launches() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launches`."""
    return dict(LAUNCHES)


def reset_launches() -> None:
    LAUNCHES.clear()
