"""hot_gather — Morpheus' fast-path table cache as a CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/hot_gather.py``
(``hot_gather_kernel``).  The source is ``csrc/hot_gather.cu``; its
header says how the design follows from the card (the hot set is staged
in shared memory per D-tile; cold rows come from device memory).  The
function is bound by bytes moved: it copies rows and computes nothing.

:func:`hot_gather_cuda` is the wrapper: it checks its inputs, allocates
the output, launches on the current stream and counts the launch in
``LAUNCHES``.  The plain PyTorch version of the same function is
:func:`hot_gather_ref` (``kernels/ref.py``); ``kernels/ops.py`` chooses
between them by the tensors' device.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from . import build
from .ref import hot_gather_ref  # noqa: F401  (the plain version)

# kernel name -> launches since the last reset (``ops.reset_launches``)
LAUNCHES: Counter = Counter()

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = build.load("hot_gather")
    fn = lib.hot_gather_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
        lib.hot_gather_error_string.argtypes = [ctypes.c_int]
        lib.hot_gather_error_string.restype = ctypes.c_char_p
    return lib


def hot_gather_cuda(table: torch.Tensor, hot_rows: torch.Tensor,
                    hot_ids: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (V, D) f32/bf16; hot_rows: (Hn, D) of the same dtype;
    hot_ids: (Hn,) int32; idx: (T,) int32; all contiguous on one CUDA
    device.  Returns (T, D) equal to ``hot_gather_ref`` bit for bit."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"hot_gather_cuda needs CUDA tensors, got {dev}")
    if table.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"hot_gather: unsupported dtype {table.dtype} "
                        f"(kernel takes {SUPPORTED_DTYPES})")
    if table.dim() != 2 or hot_rows.dim() != 2 or \
            hot_rows.shape[1] != table.shape[1]:
        raise ValueError(f"hot_gather: table {tuple(table.shape)} and "
                         f"hot_rows {tuple(hot_rows.shape)} must be (V, D) "
                         f"and (Hn, D)")
    if hot_rows.dtype != table.dtype:
        raise TypeError("hot_gather: hot_rows dtype differs from table's")
    if hot_ids.shape != (hot_rows.shape[0],) or idx.dim() != 1:
        raise ValueError("hot_gather: hot_ids must be (Hn,), idx (T,)")
    if hot_ids.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError("hot_gather: hot_ids and idx must be int32")
    for name, t in (("table", table), ("hot_rows", hot_rows),
                    ("hot_ids", hot_ids), ("idx", idx)):
        if t.device != dev:
            raise ValueError(f"hot_gather: {name} on {t.device}, "
                             f"table on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"hot_gather: {name} is not contiguous")
    V, D = table.shape
    if V == 0:
        raise ValueError("hot_gather: empty table")
    T = idx.shape[0]
    out = torch.empty((T, D), dtype=table.dtype, device=dev)
    if T == 0 or D == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hot_gather_launch(
            table.data_ptr(), hot_rows.data_ptr(), hot_ids.data_ptr(),
            idx.data_ptr(), out.data_ptr(), V, hot_rows.shape[0], T,
            D * table.element_size(), stream)
    if err != 0:
        msg = lib.hot_gather_error_string(err).decode()
        raise RuntimeError(f"hot_gather launch failed: {msg} ({err})")
    LAUNCHES["hot_gather"] += 1
    return out
