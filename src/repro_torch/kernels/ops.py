"""Public kernel entry points.

Each op dispatches by where its tensors lie: a CUDA tensor always takes
the hand-written kernel (which raises on what it does not take — there
is no fallback), a CPU tensor takes the plain PyTorch version from
``ref.py`` (bitwise the same semantics).  ``force="kernel"`` asserts the
kernel path and raises on CPU tensors.

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
from .flash_attention import FlashAttentionFn, flash_attention_cuda
from .hot_gather import LAUNCHES, hot_gather_cuda
from .ssd_scan import SsdScanFn, ssd_scan_cuda


def _use_kernel(t: torch.Tensor, force: Optional[str]) -> bool:
    if force not in (None, "kernel"):
        raise ValueError(f"force must be None or 'kernel', got {force!r}")
    if t.device.type == "cuda":
        return True
    if force == "kernel":
        raise RuntimeError(
            f"force='kernel' needs CUDA tensors; got a tensor on {t.device} "
            f"(the CUDA kernels do not run on the host)")
    return False


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, logit_softcap: float = 0.0,
                    block: int = 512,
                    force: Optional[str] = None) -> torch.Tensor:
    """Attention over the implicit positions ``arange(Sq)`` /
    ``arange(Sk)``.  On the card always the CUDA kernel, which raises on
    a shape, dtype or stride it does not take (``block`` sizes only the
    plain version's key blocks).  With grad enabled and an input that
    requires it, the kernel goes through ``FlashAttentionFn``, whose
    backward is the ``flash_attention_bwd`` kernel; every other call is
    the plain launch.  On the host autograd runs through the plain
    version."""
    if _use_kernel(q, force):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionFn.apply(q, k, v, causal, window,
                                          logit_softcap)
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    logit_softcap=logit_softcap)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    logit_softcap=logit_softcap, block=block)


def hot_gather(table, hot_rows, hot_ids, idx, *,
               force: Optional[str] = None) -> torch.Tensor:
    if _use_kernel(table, force):
        return hot_gather_cuda(table, hot_rows, hot_ids, idx)
    return _ref.hot_gather_ref(table, hot_rows, hot_ids, idx)


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
    if _use_kernel(x, force):
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (x, dt, A, Bm, Cm, init_state)):
            return SsdScanFn.apply(x, dt, A, Bm, Cm, init_state, chunk)
        return ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk,
                             init_state=init_state)
    return _ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk, init_state=init_state)


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
