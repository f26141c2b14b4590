"""What each kernel of the port must do: its FLOPs, by operand class, and
the bytes it must move, from its inputs' shapes alone.

One formula a kernel, the one its bound in ``chip_smoke.py`` and its row
in ``PERF.md`` use, and the one ``launch/op_analysis.py`` records a call
with: a kernel is counted by its own work, never by the plain version's
operations (on the CPU) or the wrapper's allocations (on the card).
Bytes count each input read once and each output written once.

FLOP classes (``launch/op_analysis.PEAK_FLOPS`` has a peak for each):

* ``"bf16"``: a product of two 16-bit operands (bf16 or fp16), on the
  tensor cores;
* ``"f32"``: a product with f32 operands on the CUDA cores (the port
  turns TF32 off);
* ``"tf32x2"`` / ``"tf32x3"``: ``ssd_scan``'s products with an f32
  operand, run as two (f32 x bf16) or three (f32 x f32, 3xTF32) TF32
  products on the tensor cores.

``RECORDER`` is the active recorder (``launch/op_analysis.Recorder``),
or None: the kernel entry points (``kernels/ops.py``) and the mesh's
per-shard loops (``distributed/compat.py``) report to it.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

RECORDER = None          # the active launch.op_analysis.Recorder, if any


@dataclass
class Work:
    """A call's work: FLOPs by class, and the bytes it must move."""
    flops: Dict[str, float] = field(default_factory=dict)
    bytes: float = 0.0

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def flop_class(dtype: torch.dtype) -> str:
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


def visible_pairs(Sq: int, Sk: int, causal: bool,
                  window: Optional[int]) -> int:
    """(q, k) pairs the mask leaves over the implicit positions
    ``arange(Sq)`` / ``arange(Sk)``: the sum over q of
    ``max(0, hi(q) - lo(q))`` with ``hi = min(Sk, q + 1)`` (causal) or
    ``Sk`` and ``lo = max(0, q - window + 1)`` (or 0).  In closed form: the
    summand is linear between its kinks (``q = Sk - 1``, ``window - 1``
    and ``Sk + window - 1``, where it reaches 0), so each stretch between
    them is an arithmetic series."""
    def f(q: int) -> int:
        hi = min(Sk, q + 1) if causal else Sk
        lo = max(0, q - window + 1) if window is not None else 0
        return max(0, hi - lo)

    kinks = [Sk - 1]
    if window is not None:
        kinks += [window - 1, Sk + window - 1]
    cuts = sorted({0, Sq} | {min(max(p + d, 0), Sq) for p in kinks
                             for d in (0, 1)})
    return sum((f(a) + f(b - 1)) * (b - a) // 2
               for a, b in zip(cuts, cuts[1:]) if b > a)


def flash_attention_work(q, k, *, causal: bool, window: Optional[int],
                         return_lse: bool = False) -> Work:
    """4 D FLOPs a visible (q, k) pair and head (q.k and p.v), in q's
    class; q and k, v read, the output (and the f32 logsumexp) written."""
    B, Sq, H, D = q.shape
    pairs = visible_pairs(Sq, k.shape[1], causal, window)
    nbytes = 2 * _nbytes(q) + 2 * _nbytes(k)
    if return_lse:
        nbytes += B * H * Sq * 4
    return Work({flop_class(q.dtype): 4.0 * D * pairs * B * H}, nbytes)


def flash_attention_bwd_work(q, k, *, causal: bool,
                             window: Optional[int]) -> Work:
    """10 D FLOPs a visible pair and head (the recomputed q.k, dv, dp,
    dq, dk); q, o, dO, k, v and the f32 logsumexp read, dq, dk, dv
    written."""
    B, Sq, H, D = q.shape
    pairs = visible_pairs(Sq, k.shape[1], causal, window)
    nbytes = 4 * _nbytes(q) + 4 * _nbytes(k) + B * H * Sq * 4
    return Work({flop_class(q.dtype): 10.0 * D * pairs * B * H}, nbytes)


def _triangle(S: int, chunk: int) -> int:
    """Lower-triangle entries of the chunks' (L x L) blocks."""
    return sum(L * (L + 1) // 2
               for L in (min(chunk, S - c0) for c0 in range(0, S, chunk)))


def _ssd_flops(dtype, same: float, mixed: float) -> Dict[str, float]:
    """Multiply-adds by operand types as FLOPs by class: bf16 x bf16 at
    the bf16 rate, f32 x bf16 as two TF32 products; in f32 every product
    as 3xTF32."""
    if dtype == torch.float32:
        return {"tf32x3": 2.0 * (same + mixed)}
    return {"bf16": 2.0 * same, "tf32x2": 2.0 * mixed}


def ssd_scan_work(x, Bm, *, chunk: int, init: bool,
                  scratch: bool = False) -> Work:
    """The multiply-adds the inputs need: the lower triangle of C.B per
    group (both operands x's type); the scores (f32) times x per head,
    C.state and the state update (an f32 operand against one of x's
    type).  Bytes: x, dt, A, B, C (and the initial state) read, y and the
    f32 final state (and with ``scratch`` the backward's ``dacs`` and
    ``states``) written."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    tri = _triangle(S, chunk)
    same = B * G * tri * N
    mixed = B * (H * tri * P + 2 * H * S * P * N)
    nbytes = (2 * _nbytes(x) + B * S * H * 4 + H * 4 + 2 * _nbytes(Bm)
              + (2 if init else 1) * B * H * P * N * 4)
    if scratch:
        nc = -(-S // chunk)
        nbytes += B * H * nc * (chunk + P * N) * 4
    return Work(_ssd_flops(x.dtype, same, mixed), nbytes)


def ssd_scan_bwd_work(x, Bm, *, chunk: int) -> Work:
    """Per chunk the lower triangle of C.B per group and of dy.x per
    head (both operands x's type); the scores (f32) times dy, C and B
    per head; the state's four products per head (an f32 operand against
    one of x's type).  Read: x, B, C, dy, dt, A and the forward's
    ``dacs``, ``states`` and final state; written: dx, dB, dC, ddt, dA,
    dinit."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    tri = _triangle(S, chunk)
    same = B * (G * tri * N + H * tri * P)
    mixed = B * (H * tri * (P + 2 * N) + 4 * H * S * P * N)
    elt = x.element_size()
    nc = -(-S // chunk)
    nbytes = (3 * B * S * H * P * elt + 4 * B * S * G * N * elt
              + 2 * B * S * H * 4 + 2 * H * 4 + B * H * nc * chunk * 4
              + B * H * nc * P * N * 4 + 2 * B * H * P * N * 4)
    return Work(_ssd_flops(x.dtype, same, mixed), nbytes)


def hot_gather_work(table, hot_rows, hot_ids, idx,
                    n_cold_rows: Optional[int] = None) -> Work:
    """No FLOPs.  Bytes: the ids, the hot rows, the distinct cold rows
    the tokens read (``n_cold_rows``; without it, which a trace cannot
    know, one row a token) and the output."""
    T = idx.shape[0]
    row = table.shape[1] * table.element_size()
    cold = T if n_cold_rows is None else n_cold_rows
    return Work({}, _nbytes(idx) + _nbytes(hot_ids) + _nbytes(hot_rows)
                + cold * row + T * row)


class _Discard:
    """What a call appends its outputs to when nothing records."""
    __slots__ = ()

    def append(self, _) -> None:
        pass


_NOT_RECORDING = contextlib.nullcontext(_Discard())


def kernel_call(name: str, work):
    """A context around one kernel call: the active recorder counts
    ``work()`` (a thunk, evaluated only while recording) under ``name``
    and nothing that runs inside.  It yields a list the caller appends
    the call's outputs to (the recorder keeps them live).  Without a
    recorder it costs one global read."""
    rec = RECORDER
    if rec is None:
        return _NOT_RECORDING
    return rec.kernel(name, work())
