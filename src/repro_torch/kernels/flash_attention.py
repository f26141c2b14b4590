"""flash_attention — blocked online-softmax attention as CUDA kernels.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention_kernel``).  The source is ``csrc/flash_attention.cu``;
its header says how each kernel follows from the card.  What bounds each
path on the H100, and which one :func:`flash_attention_cuda` takes, by
shape and dtype alone (:func:`choose_path`):

1. ``"split_k_decode"`` when ``G * Sq <= 64`` (``G = H / Hkv``), f32 or
   bf16, any D: bound by bytes (a decode reads the cache slice once at ~4
   flops a byte).  One block per (batch, kv head, split) holds all G x Sq
   rows of its kv head, so k and v are read once; the keys are cut into
   contiguous splits by :func:`decode_splits` so that the grid fills the
   card, and a second kernel combines the splits' f32 partials in a fixed
   order.  Both launches count as one.
2. ``"wgmma_prefill"`` for bf16 with D in {64, 128, 256} and more rows:
   bound by operations.  128 query rows a block in two warpgroups, k and v
   tiles brought by TMA into a two-stage ring, ``wgmma`` products.
3. ``"mma_sync"`` for bf16 with another D: ``mma.sync`` m16n8k16.
4. ``"f32"`` for float32 with more rows: CUDA cores, no TF32.

The wrapper checks its inputs, allocates the output (and the decode's
scratch), launches on the current stream, records the path in
``last_path`` and counts the call in ``LAUNCHES``.  It pads nothing (the
kernels mask the ragged edge themselves) and reads k and v strided along
batch, sequence and head, so a decode attends over a slice of the cache
in place.  What it does not take raises; nothing falls back.  The plain
PyTorch version of the same function is :func:`flash_attention_ref`
(``kernels/ref.py``); ``kernels/ops.py`` chooses between them by the
tensors' device.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build
from .hot_gather import LAUNCHES
from .ref import flash_attention_ref  # noqa: F401  (the plain version)
from .ref import SPLIT_TILE, split_keys

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 256                        # the kernel's register accumulators
INT32_MAX = 2**31 - 1
DECODE_ROWS = 64                   # G * Sq rows a kv head, at most, at decode
WGMMA_HEAD_DIMS = (64, 128, 256)
SMS = 132                          # the H100's SMs: the decode grid's target
PATHS = {"split_k_decode": 0, "wgmma_prefill": 1, "mma_sync": 2, "f32": 3}
last_path: Optional[str] = None    # the path of the last launch


def choose_path(Sq: int, H: int, Hkv: int, D: int,
                dtype: torch.dtype) -> str:
    """The kernel a call takes, by shape and dtype alone (the module
    docstring's rule)."""
    if (H // Hkv) * Sq <= DECODE_ROWS:
        return "split_k_decode"
    if dtype == torch.float32:
        return "f32"
    return "wgmma_prefill" if D in WGMMA_HEAD_DIMS else "mma_sync"


def decode_splits(B: int, Hkv: int, Sk: int) -> Tuple[int, int]:
    """``(splits, keys a split)`` of the split-K decode: enough splits of
    whole 64-key tiles that ``B * Hkv * splits`` blocks give every SM at
    least two, no more splits than tiles, and none past ``Sk``.  Split
    ``s`` covers keys ``[s * n, min((s + 1) * n, Sk))``.  A pure function,
    importable without CUDA."""
    tiles = max(1, -(-Sk // SPLIT_TILE))
    want = -(-2 * SMS // max(1, B * Hkv))
    n = split_keys(Sk, max(1, min(tiles, want)))
    return max(1, -(-Sk // n)), n


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        fn.argtypes = ([p] * 4 + [i] * 6 + [ll] * 9 + [i] * 3 + [f, f, i, i]
                       + [p, p, i, i, p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _strides(name: str, t: torch.Tensor):
    """(batch, seq, head) strides of a (B, S, H, D) operand whose last dim
    is dense and whose rows start on 16-byte boundaries (the kernel reads
    16-byte vectors)."""
    if t.shape[3] > 1 and t.stride(3) != 1:
        raise ValueError(f"flash_attention: {name}'s last dim is not dense "
                         f"(strides {t.stride()})")
    vec = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
        raise ValueError(f"flash_attention: {name} rows are not 16-byte "
                         f"aligned (strides {t.stride()}, pointer "
                         f"{t.data_ptr():#x})")
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         logit_softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D); one dtype, f32 or bf16,
    on one CUDA device; D a multiple of 8 up to 256, H a multiple of Hkv;
    any Sq and Sk.  Positions are the implicit aranges, so ``causal`` is
    top-left aligned.  Returns (B, Sq, H, D) in q's dtype, the function
    of ``flash_attention_ref`` (its sums in another order).  The kernel is
    :func:`choose_path`'s; ``last_path`` records it."""
    global last_path
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    if q.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype} "
                        f"(kernel takes {SUPPORTED_DTYPES})")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q {q.dtype}, k {k.dtype} and v "
                        f"{v.dtype} must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q (B,Sq,H,D), k/v (B,Sk,Hkv,D) "
                         "expected")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != D or v.shape != k.shape):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} disagree")
    if D % 8 or not 8 <= D <= MAX_D:
        raise ValueError(f"flash_attention: head dim {D} must be a multiple "
                         f"of 8 in [8, {MAX_D}]")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"Hkv={Hkv}")
    if k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention: k on {k.device}, v on "
                         f"{v.device}, q on {dev}")
    if window is not None and not -INT32_MAX <= int(window) <= INT32_MAX:
        raise ValueError(f"flash_attention: window {window} beyond int32")
    if not (math.isfinite(logit_softcap) and logit_softcap >= 0):
        raise ValueError(f"flash_attention: logit_softcap {logit_softcap} "
                         f"must be finite and >= 0")
    if max(B, Sq, Sk, H) > INT32_MAX or max(B, H) > 65535:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} / "
                         f"{tuple(k.shape)} beyond the kernel's grid")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    if B == 0 or Sq == 0 or H == 0:
        return out
    qs, ks, vs = (_strides(n, t) for n, t in (("q", q), ("k", k), ("v", v)))
    path = choose_path(Sq, H, Hkv, D, q.dtype)
    part_ml = part_acc = None
    splits = kps = 0
    if path == "split_k_decode":
        splits, kps = decode_splits(B, Hkv, Sk)
        rows = (H // Hkv) * Sq
        part_ml = torch.empty((B, Hkv, splits, rows, 2), dtype=torch.float32,
                              device=dev)
        part_acc = torch.empty((B, Hkv, splits, rows, D),
                               dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, Hkv, D, *qs, *ks, *vs, int(bool(causal)),
            int(window is not None), 0 if window is None else int(window),
            1.0 / math.sqrt(D), float(logit_softcap),
            0 if q.dtype == torch.float32 else 1, PATHS[path],
            None if part_ml is None else part_ml.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            splits, kps, stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed ({path}): {msg} "
                           f"({err})")
    last_path = path
    LAUNCHES["flash_attention"] += 1
    return out
