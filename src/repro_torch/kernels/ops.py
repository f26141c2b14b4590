"""Public kernel entry points.

Each op dispatches by where its tensors lie: a CUDA tensor always takes
the hand-written kernel (which raises on what it does not take — there
is no fallback), a CPU tensor takes the plain PyTorch version from
``ref.py`` (bitwise the same semantics).  ``force="kernel"`` asserts the
kernel path and raises on CPU tensors.

``launches()`` / ``reset_launches()`` read and zero the per-kernel
launch counts, so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import ref as _ref
from .hot_gather import LAUNCHES, hot_gather_cuda
from .ssd_scan import ssd_scan_cuda


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
    (the reference's dispatcher silently takes its oracle instead)."""
    if _use_kernel(x, force):
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
