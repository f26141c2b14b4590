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
tensors' device.  :func:`flash_attention_meta` and
:func:`flash_attention_bwd_meta` are the two kernels' shape functions
for ``meta`` tensors (a dry run's trace): the wrappers' checks, then
empty outputs of their shapes and dtypes.

Asked with ``return_lse=True``, :func:`flash_attention_cuda` also
returns each row's logsumexp, an f32 (B, H, Sq) in log2 units
(``log2 sum 2^(s log2 e)`` over the row's visible keys, ``NEG_INF`` for
a row that sees none; :func:`~.ref.flash_attention_lse_ref` is its
plain version), written by every path from the running max and sum it
already holds; the output is the same bits either way.

The gradient is a second library, ``csrc/flash_attention_bwd.cu``
(its header gives the design): :func:`flash_attention_bwd_cuda` takes
q, k, v, the forward's output, its logsumexp and the cotangent and
returns dq, dk and dv in q's dtype, in three or four launches that count
as one ``flash_attention_bwd``: ``wgmma`` products fed by TMA for bf16
at D 64 or 128, the CUDA cores otherwise (:func:`bwd_path`).  On the
``wgmma`` path a kv head's G query heads form :func:`bwd_head_groups`
groups, whose dk / dv shares are summed in order.
:class:`FlashAttentionFn` ties the two for autograd: its forward is
:func:`flash_attention_cuda` with the logsumexp, saved with q, k, v and
the output, and its backward the kernel.  Its plain version is
:func:`flash_attention_bwd_ref` (autograd through
``flash_attention_ref``), which the tests and the smoke run compare it
with and no card path takes.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build, work
from .hot_gather import LAUNCHES
from .ref import flash_attention_bwd_ref  # noqa: F401  (the plain versions)
from .ref import flash_attention_lse_ref  # noqa: F401
from .ref import flash_attention_ref  # noqa: F401
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
                       + [p, p, i, i, p, p])
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


def _check(q, k, v, window, logit_softcap):
    """The forward's input checks, on any device: ``(B, Sq, H, D, Sk,
    Hkv)`` or a raise."""
    dev = q.device
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
    return B, Sq, H, D, Sk, Hkv


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         logit_softcap: float = 0.0,
                         return_lse: bool = False):
    """q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D); one dtype, f32 or bf16,
    on one CUDA device; D a multiple of 8 up to 256, H a multiple of Hkv;
    any Sq and Sk.  Positions are the implicit aranges, so ``causal`` is
    top-left aligned.  Returns (B, Sq, H, D) in q's dtype, the function
    of ``flash_attention_ref`` (its sums in another order), and with
    ``return_lse`` also the rows' logsumexp (the module docstring's,
    :func:`~.ref.flash_attention_lse_ref`'s).  The kernel is
    :func:`choose_path`'s; ``last_path`` records it."""
    global last_path
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    B, Sq, H, D, Sk, Hkv = _check(q, k, v, window, logit_softcap)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    if B == 0 or Sq == 0 or H == 0:
        return (out, lse) if return_lse else out
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
            splits, kps, None if lse is None else lse.data_ptr(), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed ({path}): {msg} "
                           f"({err})")
    last_path = path
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         logit_softcap: float = 0.0,
                         return_lse: bool = False):
    """The kernel's shape function, for ``meta`` tensors: the checks
    :func:`flash_attention_cuda` makes (so what raises on the card raises
    here) and empty outputs of its shapes and dtypes, the f32 (B, H, Sq)
    logsumexp included.  Computes nothing and launches nothing."""
    if q.device.type != "meta":
        raise ValueError(f"flash_attention_meta needs meta tensors, got "
                         f"{q.device}")
    B, Sq, H, D, Sk, Hkv = _check(q, k, v, window, logit_softcap)
    out = q.new_empty((B, Sq, H, D))
    lse = (q.new_empty((B, H, Sq), dtype=torch.float32) if return_lse
           else None)
    if B and Sq and H:
        for n, t in (("q", q), ("k", k), ("v", v)):
            _strides(n, t)
    return (out, lse) if return_lse else out


BWD_PATHS = {"cuda_cores": 0, "wgmma": 1}
WGMMA_BWD_HEAD_DIMS = (64, 128)
BWD_KEYS = 128                     # keys a wgmma dk / dv block
last_bwd_path: Optional[str] = None    # the path of the last backward


def bwd_path(D: int, dtype: torch.dtype) -> str:
    """The backward's path, by dtype and head dim alone: ``wgmma`` (the
    tensor cores, fed by TMA) for bf16 at D 64 or 128, else
    ``cuda_cores``."""
    if dtype == torch.bfloat16 and D in WGMMA_BWD_HEAD_DIMS:
        return "wgmma"
    return "cuda_cores"


def bwd_head_groups(B: int, Hkv: int, Sk: int, G: int) -> int:
    """Groups of a kv head's ``G`` query heads that the ``wgmma`` dk / dv
    kernel takes in separate blocks: the fewest (a divisor of ``G``) that
    give its grid, ``B * Hkv * ceil(Sk / BWD_KEYS)`` blocks a group, at
    least two blocks an SM; ``G`` when none does.  Each group's share goes
    to an f32 scratch that a last pass sums in group order (none with one
    group).  A pure function, importable without CUDA."""
    blocks = B * Hkv * max(1, -(-Sk // BWD_KEYS))
    for d in range(1, G + 1):
        if G % d == 0 and blocks * d >= 2 * SMS:
            return d
    return G


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 11 + [i] * 9 + [f, f, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_bwd(q, k, v, out, lse, dout, window, logit_softcap):
    """The backward's input checks, on any device: ``(B, Sq, H, D, Sk,
    Hkv)`` or a raise."""
    dev = q.device
    if q.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"flash_attention_bwd: unsupported dtype {q.dtype} "
                        f"(kernel takes {SUPPORTED_DTYPES})")
    ts = {"k": k, "v": v, "out": out, "dout": dout}
    for name, t in ts.items():
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention_bwd: {name} is {t.dtype}, q "
                            f"{q.dtype}: one dtype expected")
        if t.device != dev:
            raise ValueError(f"flash_attention_bwd: {name} on {t.device}, "
                             f"q on {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_bwd: q (B,Sq,H,D), k/v "
                         "(B,Sk,Hkv,D) expected")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != D or v.shape != k.shape
            or out.shape != q.shape or dout.shape != q.shape):
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} out "
                         f"{tuple(out.shape)} dout {tuple(dout.shape)} "
                         f"disagree")
    if D % 8 or not 8 <= D <= MAX_D:
        raise ValueError(f"flash_attention_bwd: head dim {D} must be a "
                         f"multiple of 8 in [8, {MAX_D}]")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"flash_attention_bwd: H={H} is not a multiple of "
                         f"Hkv={Hkv}")
    if window is not None and not -INT32_MAX <= int(window) <= INT32_MAX:
        raise ValueError(f"flash_attention_bwd: window {window} beyond int32")
    if not (math.isfinite(logit_softcap) and logit_softcap >= 0):
        raise ValueError(f"flash_attention_bwd: logit_softcap "
                         f"{logit_softcap} must be finite and >= 0")
    if max(B, Sq, Sk, H) > INT32_MAX or max(B, H) > 65535:
        raise ValueError(f"flash_attention_bwd: shape {tuple(q.shape)} / "
                         f"{tuple(k.shape)} beyond the kernel's grid")
    if (lse.dtype != torch.float32 or lse.device != dev
            or tuple(lse.shape) != (B, H, Sq)):
        raise ValueError(f"flash_attention_bwd: lse must be f32 "
                         f"{(B, H, Sq)} on {dev}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    return B, Sq, H, D, Sk, Hkv


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             logit_softcap: float = 0.0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The gradient of :func:`flash_attention_cuda` at q, k, v (its
    shapes, dtypes and options) given its output ``out``, its logsumexp
    ``lse`` (f32 (B, H, Sq), log2 units: what the forward returns with
    ``return_lse=True``) and the cotangent ``dout`` (q's shape):
    ``(dq, dk, dv)`` in q's dtype, through :func:`bwd_path`'s kernels
    (``last_bwd_path`` records it).  Operands of any stride are copied
    dense (and 16-byte aligned) first; what the forward does not take
    raises here too."""
    global last_bwd_path
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd_cuda needs CUDA tensors, got "
                         f"{dev}")
    B, Sq, H, D, Sk, Hkv = _check_bwd(q, k, v, out, lse, dout, window,
                                      logit_softcap)
    q, k, v, out, dout, lse = (
        t if t.is_contiguous() and t.data_ptr() % 16 == 0
        else t.clone(memory_format=torch.contiguous_format)
        for t in (q, k, v, out, dout, lse))
    # every element is written, but with no key dq is 0 (and dk, dv empty)
    alloc = torch.zeros_like if Sk == 0 else torch.empty_like
    dq, dk, dv = (alloc(t) for t in (q, k, v))
    if B == 0 or Sq == 0 or H == 0:
        return dq, dk, dv
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    path = bwd_path(D, q.dtype)
    groups = bwd_head_groups(B, Hkv, Sk, H // Hkv) if path == "wgmma" else 1
    # the groups' f32 dk / dv shares, summed in group order by a last pass
    part = (torch.empty((2, groups, B, Sk, Hkv, D), dtype=torch.float32,
                        device=dev) if groups > 1 and Sk else None)
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(),
            None if part is None else part.data_ptr(), B, Sq, Sk, H, Hkv, D,
            int(bool(causal)), int(window is not None),
            0 if window is None else int(window), 1.0 / math.sqrt(D),
            float(logit_softcap), 0 if q.dtype == torch.float32 else 1,
            BWD_PATHS[path], groups, stream)
    if err != 0:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_bwd launch failed ({path}): "
                           f"{msg} ({err})")
    last_bwd_path = path
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def flash_attention_bwd_meta(q, k, v, out, lse, dout, *, causal: bool = True,
                             window: Optional[int] = None,
                             logit_softcap: float = 0.0):
    """The backward's shape function, for ``meta`` tensors: the checks of
    :func:`flash_attention_bwd_cuda` and empty dq, dk, dv (dense, q's
    dtype)."""
    if q.device.type != "meta":
        raise ValueError(f"flash_attention_bwd_meta needs meta tensors, got "
                         f"{q.device}")
    _check_bwd(q, k, v, out, lse, dout, window, logit_softcap)
    return tuple(torch.empty(t.shape, dtype=q.dtype, device=q.device)
                 for t in (q, k, v))


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention_cuda`` with ``flash_attention_bwd_cuda`` as its
    gradient (on ``meta`` tensors their shape functions); q, k and v are
    saved with the output and the forward's logsumexp, which the backward
    reads (a remat recompute runs the forward kernel again).  The
    backward is one ``flash_attention_bwd`` call for a recorder
    (``kernels/work.py``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_softcap):
        fwd = (flash_attention_meta if q.device.type == "meta"
               else flash_attention_cuda)
        out, lse = fwd(q, k, v, causal=causal, window=window,
                       logit_softcap=logit_softcap, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window,
                        logit_softcap=logit_softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (flash_attention_bwd_meta if q.device.type == "meta"
               else flash_attention_bwd_cuda)
        o = ctx.opts
        with work.kernel_call("flash_attention_bwd",
                              lambda: work.flash_attention_bwd_work(
                                  q, k, causal=o["causal"],
                                  window=o["window"])) as outs:
            grads = bwd(q, k, v, out, lse, dout, **o)
            outs.append(grads)
        return (*grads, None, None, None)
