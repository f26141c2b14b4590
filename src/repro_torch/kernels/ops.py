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

from typing import Dict, Optional

import torch

from . import ref as _ref
from .hot_gather import LAUNCHES, hot_gather_cuda


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


def onehot_lookup(table, idx, *, force: Optional[str] = None):
    # no kernel: the one-hot matmul is plain PyTorch on every device,
    # as it is plain jnp in the reference
    return _ref.onehot_lookup_ref(table, idx)


def launches() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launches`."""
    return dict(LAUNCHES)


def reset_launches() -> None:
    LAUNCHES.clear()
