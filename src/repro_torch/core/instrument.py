"""Adaptive instrumentation (§4.2), single device.

Per (table x call-site) we keep an on-device sketch:

  * a count-min sketch (rows x width, int32) — heavy-hitter frequency
    estimates without per-key state;
  * a candidate ring buffer of recently-seen keys — the engine estimates
    frequencies only for candidates (fixed shape, scatter writes).

The adaptation dimensions are the reference's (``repro.core.instrument``):
small tables are never instrumented, only sampled steps run the
instrumented executable, one sketch per call site, and
``Table(instrument=False)`` opts out.  The sharded recording and merge
of the reference wait for the mesh slice of the port.

Every function here gives bitwise the reference's sketch for the same
keys: the uint32 multiply-and-wrap hash is computed in int64 and masked
to 32 bits, and the candidate ring keeps the *last* write to a position
(see :func:`record`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class SketchConfig:
    rows: int = 4
    width: int = 512
    candidates: int = 128
    sample_every: int = 8        # instrumented-executable cadence
    hot_coverage: float = 0.90   # traffic share the hot set must cover
    max_hot: int = 8             # fast-path cache size


_PRIMES = np.array([1000003, 999983, 999979, 999961, 998244353,
                    1000000007, 1000000021, 1000000033], np.int64)
_MASK32 = 0xFFFFFFFF


def init_site_state(cfg: SketchConfig, device) -> Dict[str, torch.Tensor]:
    """Fresh sketch state for one call site: ``cms (rows, width)``,
    ``cand (candidates,)`` filled with -1, scalar ``ptr``/``total``."""
    return {
        "cms": torch.zeros((cfg.rows, cfg.width), dtype=torch.int32,
                           device=device),
        "cand": torch.full((cfg.candidates,), -1, dtype=torch.int32,
                           device=device),
        "ptr": torch.zeros((), dtype=torch.int32, device=device),
        "total": torch.zeros((), dtype=torch.int32, device=device),
    }


def _hash(keys: torch.Tensor, row: int, width: int) -> torch.Tensor:
    # the reference's uint32 multiplicative hash: keys are read as
    # uint32 (-1 -> 0xFFFFFFFF) and the product wraps mod 2**32.  The
    # product of two values < 2**32 and 2**30 fits int64 exactly.
    p = int(_PRIMES[row % len(_PRIMES)]) & _MASK32
    h = ((keys.to(torch.int64) & _MASK32) * p + row * 7919) & _MASK32
    return (h % width).to(torch.int32)


def record(state: Dict[str, torch.Tensor], keys: torch.Tensor,
           cfg: SketchConfig) -> Dict[str, torch.Tensor]:
    """Fold this step's looked-up keys into the sketch; returns the new
    state (the input is not written).  keys: int tensor (any shape),
    -1 entries ignored.

    All count-min rows update in one integer scatter-add (commutative,
    so the order atomics take on the card does not matter).  The ring
    writes key i at ``(ptr + i) % candidates``; when a step brings more
    keys than the ring holds, positions repeat, and the reference keeps
    the last write.  A scatter with repeated positions has no defined
    order here, so only the last ``candidates`` keys — whose positions
    are distinct — are written."""
    keys = keys.reshape(-1).to(torch.int32)
    valid = keys >= 0
    cms = state["cms"]
    rows, width = cms.shape
    dev = keys.device
    h = torch.stack([_hash(keys, r, width) for r in range(rows)])  # (R, n)
    flat = (torch.arange(rows, device=dev)[:, None] * width + h).reshape(-1)
    upd = valid.to(torch.int32)[None, :].expand(rows, -1).reshape(-1)
    cms = cms.reshape(-1).index_add(0, flat, upd).reshape(rows, width)
    n = keys.shape[0]
    ptr = state["ptr"]
    cand = state["cand"]
    cand_n = cand.shape[0]
    m = min(n, cand_n)
    pos = ((ptr + torch.arange(n - m, n, dtype=torch.int32, device=dev))
           % cand_n).long()
    cand = cand.index_put(
        (pos,), torch.where(valid[n - m:], keys[n - m:], cand[pos]))
    return {"cms": cms, "cand": cand,
            "ptr": (ptr + n) % cand_n,
            "total": state["total"] + valid.sum().to(torch.int32)}


def estimate(state: Dict[str, torch.Tensor],
             keys: torch.Tensor) -> torch.Tensor:
    """Count-min point estimates for ``keys``."""
    cms = state["cms"]
    est = None
    for r in range(cms.shape[0]):
        e = cms[r, _hash(keys, r, cms.shape[1]).long()]
        est = e if est is None else torch.minimum(est, e)
    return est


def hot_keys(state: Dict[str, np.ndarray], cfg: SketchConfig
             ) -> Tuple[np.ndarray, float, int]:
    """Host-side (engine) heavy-hitter extraction from a host copy of a
    sketch.  Returns (hot keys sorted by estimated frequency, coverage
    fraction, total samples)."""
    cand = np.unique(np.asarray(state["cand"]))
    cand = cand[cand >= 0]
    total = int(state["total"])
    if len(cand) == 0 or total == 0:
        return np.array([], np.int32), 0.0, total
    est = estimate({"cms": torch.from_numpy(np.array(state["cms"]))},
                   torch.from_numpy(cand)).numpy()
    order = np.argsort(-est)
    cand, est = cand[order], est[order]
    top = cand[: cfg.max_hot]
    coverage = float(est[: cfg.max_hot].sum()) / max(total, 1)
    return top.astype(np.int32), min(coverage, 1.0), total


class SketchDoubleBuffer:
    """Front/back buffer pair for lock-free instrumentation readout.

    The *front* buffer is the live sketch state inside the runtime's
    :class:`~repro_torch.core.state.PlaneState`.  After each
    instrumented step (and after every sketch-window reset at swap time)
    the runtime :meth:`publish`\\ es a device-side clone of it — enqueued
    under the runtime lock, ordered on the stream before anything later —
    and :meth:`read` hands that clone to any thread for a device->host
    copy without the runtime lock.  ``seq`` counts publishes."""

    def __init__(self):
        self._back: Dict[str, Dict[str, torch.Tensor]] = {}
        self.seq = 0

    def publish(self, instr: Dict[str, Dict[str, torch.Tensor]]) -> None:
        self._back = {sid: {k: v.clone() for k, v in st.items()}
                      for sid, st in instr.items()}
        self.seq += 1

    def read(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The latest published back buffer."""
        return self._back
