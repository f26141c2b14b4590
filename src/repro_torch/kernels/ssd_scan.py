"""ssd_scan — Mamba2's SSD chunked scan as a CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py``
(``ssd_scan_kernel``).  The source is ``csrc/ssd_scan.cu``; its header
says how the design follows from the card (chunks in parallel, a short
sequential pass over the carried state, 32-row output strips that form
C.B^T once for a block of heads sharing a group, every product on the
tensor cores with the 3xTF32 split).  The function is bound by
operations.  Its arithmetic in plain PyTorch is
:func:`~.ref.ssd_scan_blocked_ref`, which the CPU tests hold against the
JAX package.

:func:`ssd_scan_cuda` is the wrapper: it checks its inputs, allocates
the outputs and scratch, launches on the current stream and counts the
launch in ``LAUNCHES``.  Unlike the TPU kernel it takes any number of
groups G that divides H, any H and a ragged last chunk; what it does not
take raises.  The plain PyTorch version of the same function is
:func:`ssd_scan_ref` (``kernels/ref.py``); ``kernels/ops.py`` chooses
between them by the tensors' device.  :func:`ssd_scan_meta` and
:func:`ssd_scan_bwd_meta` are the shape functions for ``meta`` tensors
(the wrappers' checks, then empty outputs of their shapes and dtypes).

:func:`ssd_scan_bwd_cuda` is the gradient, ``csrc/ssd_scan_bwd.cu``
(its plain version :func:`~.ref.ssd_scan_bwd_ref`, its arithmetic
:func:`~.ref.ssd_scan_bwd_blocked_ref`), counted as ``ssd_scan_bwd``;
:class:`SsdScanFn` joins the two for autograd, and ``ops.ssd_scan``
takes it on the card when an input requires grad.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build, work
from .hot_gather import LAUNCHES
from .ref import ssd_scan_ref  # noqa: F401  (the plain version)

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 1024   # the kernel's warp tiles


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 10 + [i] * 7 + [ll] * 8 + [i, p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _rows(name: str, t: torch.Tensor, width: int) -> Tuple[int, int]:
    """(batch, step) strides of ``t``, whose trailing dims must be dense
    (each step's row of ``width`` values contiguous)."""
    inner = 1
    for dim in range(t.dim() - 1, 1, -1):
        if t.shape[dim] > 1 and t.stride(dim) != inner:
            raise ValueError(f"ssd_scan: {name} must be dense past its step "
                             f"dim (strides {t.stride()})")
        inner *= t.shape[dim]
    if inner != width:
        raise ValueError(f"ssd_scan: {name} rows hold {inner} values, "
                         f"expected {width}")
    return t.stride(0), t.stride(1)


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                  init_state: Optional[torch.Tensor] = None,
                  return_scratch: bool = False):
    """x: (B, S, H, P) f32/bf16; dt: (B, S, H) f32; A: (H,) f32; Bm/Cm:
    (B, S, G, N) of x's dtype with G dividing H; init_state: (B, H, P, N)
    f32 or None.  x, dt, Bm and Cm may be strided over batch and step
    (slices of one projection); the rest must be dense.  Returns y
    (B, S, H, P) in x's dtype and the final state (B, H, P, N) f32, the
    function of ``ssd_scan_ref``; with ``return_scratch`` also the
    forward's ``dacs`` (B, H, nc, Q), each chunk's running sum of dt A,
    and ``states`` (B, H, nc, P, N), the state entering each chunk, which
    the backward reads."""
    _on("cuda", "ssd_scan_cuda", x)
    _check(x, dt, A, Bm, Cm, chunk)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dev = x.device
    (x_sb, x_ss), (dt_sb, dt_ss), (b_sb, b_ss), (c_sb, c_ss) = _check_fwd(
        x, dt, Bm, Cm, init_state)

    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    final = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    nc = -(-S // chunk)
    dacs = torch.empty((Bsz, H, nc, chunk), dtype=torch.float32, device=dev)
    states = torch.empty((Bsz, H, nc, P, N), dtype=torch.float32,
                         device=dev)
    if Bsz == 0 or S == 0 or H == 0:
        if init_state is None:
            final.zero_()
        else:
            final.copy_(init_state)
        return (y, final, dacs, states) if return_scratch else (y, final)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), final.data_ptr(), dacs.data_ptr(),
            states.data_ptr(), Bsz, S, H, P, G, N, chunk,
            x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss,
            0 if x.dtype == torch.float32 else 1, stream)
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan launch failed: {msg} ({err})")
    LAUNCHES["ssd_scan"] += 1
    return (y, final, dacs, states) if return_scratch else (y, final)


def _check_fwd(x, dt, Bm, Cm, init_state):
    """The forward's checks past :func:`_check`: the initial state's
    type, shape, layout and device, and the operands' row strides
    (returned)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if init_state is not None:
        if init_state.dtype != torch.float32 or \
                tuple(init_state.shape) != (Bsz, H, P, N):
            raise ValueError(f"ssd_scan: init_state must be float32 "
                             f"{(Bsz, H, P, N)}")
        if not init_state.is_contiguous():
            raise ValueError("ssd_scan: init_state is not contiguous")
        if init_state.device != x.device:
            raise ValueError(f"ssd_scan: init_state on {init_state.device}, "
                             f"x on {x.device}")
    return (_rows("x", x, H * P), _rows("dt", dt, H),
            _rows("Bm", Bm, G * N), _rows("Cm", Cm, G * N))


def ssd_scan_meta(x, dt, A, Bm, Cm, *, chunk: int, init_state=None,
                  return_scratch: bool = False):
    """The kernel's shape function, for ``meta`` tensors: the checks of
    :func:`ssd_scan_cuda` and empty outputs of its shapes and dtypes (y
    in x's dtype, the f32 final state, and with ``return_scratch`` the
    f32 ``dacs`` and ``states``).  Computes nothing."""
    _on("meta", "ssd_scan_meta", x)
    _check(x, dt, A, Bm, Cm, chunk)
    _check_fwd(x, dt, Bm, Cm, init_state)
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    nc = -(-S // chunk)
    f32 = torch.float32
    y = x.new_empty((Bsz, S, H, P))
    final = x.new_empty((Bsz, H, P, N), dtype=f32)
    if not return_scratch:
        return y, final
    return (y, final, x.new_empty((Bsz, H, nc, chunk), dtype=f32),
            x.new_empty((Bsz, H, nc, P, N), dtype=f32))


def _on(kind: str, who: str, x) -> None:
    if x.device.type != kind:
        raise ValueError(f"{who} needs {'CUDA' if kind == 'cuda' else kind} "
                         f"tensors, got {x.device}")


def _check(x, dt, A, Bm, Cm, chunk: int) -> None:
    """The checks the forward and the backward share, on any device:
    dtypes, shapes, devices and the kernels' envelope."""
    dev = x.device
    if x.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"ssd_scan: unsupported dtype {x.dtype} "
                        f"(kernel takes {SUPPORTED_DTYPES})")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan: Bm {Bm.dtype} and Cm {Cm.dtype} must "
                        f"have x's dtype {x.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("ssd_scan: dt and A must be float32")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4:
        raise ValueError("ssd_scan: x (B,S,H,P), dt (B,S,H), A (H,), "
                         "Bm/Cm (B,S,G,N) expected")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape[:2]) != (Bsz, S)
            or Cm.shape != Bm.shape):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} A {tuple(A.shape)} Bm "
                         f"{tuple(Bm.shape)} Cm {tuple(Cm.shape)} disagree")
    if G < 1 or H % G:
        raise ValueError(f"ssd_scan: G={G} groups must divide H={H}")
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N
            and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"ssd_scan: P={P} N={N} chunk={chunk} outside the "
                         f"kernel's P<={MAX_P}, N<={MAX_N}, "
                         f"chunk<={MAX_CHUNK}")
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device != dev:
            raise ValueError(f"ssd_scan: {name} on {t.device}, x on {dev}")
    if not A.is_contiguous():
        raise ValueError("ssd_scan: A is not contiguous")


def head_block(rep: int) -> int:
    """The heads a block of ``ssd_scan_bwd``'s triangle covers for ``rep``
    heads a group: the largest divisor of ``rep`` up to 8, the rule by
    which ``ssd_scan.cu`` blocks the forward's heads.  The wrapper passes
    it to the kernel and sizes the dB / dC share scratch with it, one
    share per head block."""
    return next(k for k in range(8, 0, -1) if rep % k == 0)


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan_bwd")
    fn = lib.ssd_scan_bwd_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 21 + [i] * 8 + [ll] * 8 + [i, p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_bwd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Bm: torch.Tensor, Cm: torch.Tensor, dacs: torch.Tensor,
                      states: torch.Tensor, final: torch.Tensor,
                      dy: torch.Tensor, dfinal: Optional[torch.Tensor], *,
                      chunk: int):
    """The gradient of :func:`ssd_scan_cuda` (``csrc/ssd_scan_bwd.cu``):
    the forward's inputs as it took them, its ``dacs``, ``states`` and
    final state (``return_scratch=True``), the cotangent ``dy`` of y and
    ``dfinal`` of the final state (None: zero).  Returns ``(dx, ddt, dA,
    dB, dC, dinit)``: dx, dB and dC in x's dtype (dB and dC summed over
    the heads of each group), ddt, dA and dinit (B, H, P, N) f32 — the
    function of ``ssd_scan_bwd_ref``."""
    _on("cuda", "ssd_scan_bwd_cuda", x)
    _check_bwd(x, dt, A, Bm, Cm, dacs, states, final, dy, dfinal, chunk)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dev = x.device
    nc = -(-S // chunk)
    f32 = torch.float32
    dy = dy.contiguous()
    dfinal = None if dfinal is None else dfinal.contiguous()
    dacs, states, final = (t.contiguous() for t in (dacs, states, final))
    x_sb, x_ss = _rows("x", x, H * P)
    dt_sb, dt_ss = _rows("dt", dt, H)
    b_sb, b_ss = _rows("Bm", Bm, G * N)
    c_sb, c_ss = _rows("Cm", Cm, G * N)

    empty = Bsz == 0 or S == 0 or H == 0
    new = torch.zeros if empty else torch.empty
    dx = new((Bsz, S, H, P), dtype=x.dtype, device=dev)
    ddt = new((Bsz, S, H), dtype=f32, device=dev)
    dA = new((H,), dtype=f32, device=dev)
    dB = new((Bsz, S, G, N), dtype=x.dtype, device=dev)
    dC = new((Bsz, S, G, N), dtype=x.dtype, device=dev)
    dinit = new((Bsz, H, P, N), dtype=f32, device=dev)
    if empty:                  # no step: the final state is the initial one
        if dfinal is not None:
            dinit.copy_(dfinal)
        return dx, ddt, dA, dB, dC, dinit
    nblk = -(-(P * N) // 256)
    hblk = head_block(H // G)
    nhb = H // hblk
    e = lambda *shape: torch.empty(shape, dtype=f32, device=dev)
    scratch = (e(Bsz, H, nc, P, N), e(Bsz, H, nblk, nc),
               e(3, Bsz, H, nc, chunk), e(2, Bsz, S, nhb, N),
               e(Bsz, H, nc))
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), dy.data_ptr(),
            None if dfinal is None else dfinal.data_ptr(),
            dacs.data_ptr(), states.data_ptr(), final.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), dinit.data_ptr(),
            *(t.data_ptr() for t in scratch),
            Bsz, S, H, P, G, N, chunk, hblk,
            x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss,
            0 if x.dtype == torch.float32 else 1, stream)
    if err != 0:
        msg = lib.ssd_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"ssd_scan_bwd launch failed: {msg} ({err})")
    LAUNCHES["ssd_scan_bwd"] += 1
    return dx, ddt, dA, dB, dC, dinit


def _check_bwd(x, dt, A, Bm, Cm, dacs, states, final, dy, dfinal,
               chunk: int) -> None:
    """The backward's checks, on any device: the forward's, then the
    cotangents' and the saved scratch's types, shapes and devices."""
    _check(x, dt, A, Bm, Cm, chunk)
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    nc = -(-S // chunk)
    dev = x.device
    if dy.dtype != x.dtype or tuple(dy.shape) != (Bsz, S, H, P):
        raise ValueError(f"ssd_scan_bwd: dy must be {x.dtype} "
                         f"{(Bsz, S, H, P)}, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    for name, t, shape in (("dacs", dacs, (Bsz, H, nc, chunk)),
                           ("states", states, (Bsz, H, nc, P, N)),
                           ("final", final, (Bsz, H, P, N)),
                           ("dfinal", dfinal, (Bsz, H, P, N))):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape
                              or t.device != dev):
            raise ValueError(f"ssd_scan_bwd: {name} must be float32 {shape} "
                             f"on {dev}")


def ssd_scan_bwd_meta(x, dt, A, Bm, Cm, dacs, states, final, dy, dfinal, *,
                      chunk: int):
    """The backward's shape function, for ``meta`` tensors: the checks of
    :func:`ssd_scan_bwd_cuda` and empty ``(dx, ddt, dA, dB, dC, dinit)``
    of its shapes and dtypes."""
    _on("meta", "ssd_scan_bwd_meta", x)
    _check_bwd(x, dt, A, Bm, Cm, dacs, states, final, dy, dfinal, chunk)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    f32 = torch.float32
    e = lambda shape, dtype: x.new_empty(shape, dtype=dtype)
    return (e((Bsz, S, H, P), x.dtype), e((Bsz, S, H), f32), e((H,), f32),
            e((Bsz, S, G, N), x.dtype), e((Bsz, S, G, N), x.dtype),
            e((Bsz, H, P, N), f32))


class SsdScanFn(torch.autograd.Function):
    """``ssd_scan_cuda`` with ``ssd_scan_bwd_cuda`` as its gradient (on
    ``meta`` tensors their shape functions); the inputs are saved as the
    forward took them (strided views of one projection stay views) with
    the forward's ``dacs``, ``states`` and final state, which the
    backward reads (a remat recompute runs the forward kernel again).
    The backward is one ``ssd_scan_bwd`` call for a recorder
    (``kernels/work.py``)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk):
        ctx.set_materialize_grads(False)
        fwd = ssd_scan_meta if x.device.type == "meta" else ssd_scan_cuda
        y, final, dacs, states = fwd(
            x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state,
            return_scratch=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, dacs, states, final)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm, dacs, states, final = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        bwd = (ssd_scan_bwd_meta if x.device.type == "meta"
               else ssd_scan_bwd_cuda)
        with work.kernel_call("ssd_scan_bwd", lambda: work.ssd_scan_bwd_work(
                x, Bm, chunk=ctx.chunk)) as outs:
            grads = bwd(x, dt, A, Bm, Cm, dacs, states, final, dy, dfinal,
                        chunk=ctx.chunk)
            outs.append(grads)
        dx, ddt, dA, dB, dC, dinit = grads
        need = ctx.needs_input_grad
        return (dx if need[0] else None, ddt if need[1] else None,
                dA if need[2] else None, dB if need[3] else None,
                dC if need[4] else None, dinit if need[5] else None, None)
