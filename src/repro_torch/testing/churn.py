"""Seeded churn schedules for the conformance harness.

Ported from ``repro.testing.churn``.  A schedule is a list of
:class:`ChurnEvent` — serving steps interleaved with the control-plane
churn the runtime claims to survive: control-table updates, feature-flag
flips, hot-set rotations, sampler pin/re-arm, blocking recompiles, and
injected mispredicts (a bare version bump the program guard must catch
on the very next step).

Schedules are fully materialized at generation time: every ``step``
event carries its concrete numpy batch (and frontend request rows), and
the generator draws from numpy exactly as the reference's does, so the
same ``(plane, seed, n_events)`` gives the byte-identical event stream
in either package.  Hot-set rotation is a generation-time move: it
shifts the :class:`~.archzoo.TrafficState` offsets later batches are
drawn from, and appears in the schedule only as a marker event.

The move registry is extensible (:func:`register_churn_move`);
``generate_schedule`` makes every applicable move fire at least once.
The SSD fast path's ``ssm_flush`` / ``ssm_warm`` moves drive
:class:`~repro_torch.core.passes.ssd_fastpath.SSDFastPathPass` through
its claim/decline/re-claim cycle.  The reference's chaos (fault
injection) moves wait for the fault-tolerance slice of the port:
``generate_schedule(..., chaos=True)`` raises until then.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from .archzoo import (ArchPlane, N_CLASSES, N_FRAMES, N_SLOTS, N_SRC,
                      TrafficState, make_batch, make_rows,
                      _ssm_state_width)


@dataclass
class ChurnEvent:
    """One schedule entry.  ``kind`` selects the driver action:

    step              serve ``payload["batch"]`` (plain mode) or submit
                      ``payload["rows"]`` (frontend mode)
    control_update    ``control_update(payload["table"],
                      payload["fields"])`` on both runtimes
    flag_flip         ``set_feature(payload["flag"], payload["value"])``
                      on both runtimes
    hotset_rotate     generation-time marker (already baked into later
                      batches)
    sampler_pin       ``sampler.pin(payload["every"])`` on both
    sampler_rearm     ``sampler.rearm()`` on both
    recompile         blocking recompile cycle on both runtimes
    inject_mispredict ``tables.bump_version()`` on both — the next step
                      MUST deopt through the program guard
    """
    kind: str
    payload: Dict = field(default_factory=dict)

    def __repr__(self):
        keys = ",".join(sorted(self.payload))
        return f"ChurnEvent({self.kind}{':' + keys if keys else ''})"


# ---- move registry ------------------------------------------------------

MoveFactory = Callable[[ArchPlane, np.random.Generator, TrafficState],
                       Optional[ChurnEvent]]
_MOVES: Dict[str, Dict] = {}


def register_churn_move(name: str, factory: MoveFactory,
                        applies: Optional[Callable[[ArchPlane], bool]]
                        = None, weight: float = 1.0) -> None:
    """Add (or replace) a churn move.  ``factory(plane, rng, traffic)``
    returns the materialized event or a list of events (an episode); it
    may also mutate ``traffic`` — that's how hot-set rotation works.
    ``applies(plane)`` gates the move per architecture; ``weight``
    biases random selection."""
    _MOVES[name] = {"factory": factory,
                    "applies": applies or (lambda plane: True),
                    "weight": weight}


def churn_moves(plane: ArchPlane) -> List[str]:
    """Registered move names applicable to ``plane``, in registration
    order."""
    return [n for n, m in _MOVES.items() if m["applies"](plane)]


# ---- built-in moves -----------------------------------------------------

def _mv_update_req_class(plane, rng, traffic):
    rows = int(rng.integers(1, N_CLASSES + 1))
    return ChurnEvent("control_update", {
        "table": "req_class",
        "fields": {
            "temperature": rng.uniform(0.5, 1.5, rows).astype(np.float32),
            "bias": (rng.standard_normal((rows, plane.cfg.d_model))
                     * 0.02).astype(np.float32)}})


def _mv_update_vocab(plane, rng, traffic):
    # rewrite a prefix that overlaps the live hot-token window: the
    # one-hot / hot-cache specializations must serve the NEW rows
    rows = int(rng.integers(4, 32))
    return ChurnEvent("control_update", {
        "table": "vocab_embed",
        "fields": {"vec": (rng.standard_normal((rows, plane.cfg.d_model))
                           * 0.02).astype(np.float32)}})


def _mv_update_cross(plane, rng, traffic):
    table = "cross_src" if plane.has_cross else "media_patches"
    fld = "mem" if plane.has_cross else "patch"
    rows = int(rng.integers(1, 8))
    return ChurnEvent("control_update", {
        "table": table,
        "fields": {fld: (rng.standard_normal(
            (rows, N_FRAMES * plane.cfg.d_model)) * 0.1)
            .astype(np.float32)}})


def _mv_flag_flip(plane, rng, traffic):
    flag = str(rng.choice(sorted(plane.features)))
    return ChurnEvent("flag_flip", {"flag": flag,
                                    "value": bool(rng.integers(0, 2))})


def _mv_hotset_rotate(plane, rng, traffic):
    traffic.token_off = (traffic.token_off
                         + int(rng.integers(4, 32))) % plane.vocab
    traffic.slot_off = (traffic.slot_off
                        + int(rng.integers(4, 16))) % N_SLOTS
    traffic.src_off = (traffic.src_off + int(rng.integers(1, 8))) % N_SRC
    return ChurnEvent("hotset_rotate", {"token_off": traffic.token_off,
                                        "slot_off": traffic.slot_off,
                                        "src_off": traffic.src_off})


def _mv_sampler(plane, rng, traffic):
    if rng.integers(0, 2):
        return ChurnEvent("sampler_pin",
                          {"every": int(rng.choice([2, 4, 8]))})
    return ChurnEvent("sampler_rearm", {})


def _mv_ssm_flush(plane, rng, traffic):
    """Zero the whole SSD state table (state AND count together — the
    freshness invariant ``count==0 => state row zero`` must survive
    every control write).  Re-enables the SSD fast-path claim."""
    w = _ssm_state_width(plane.cfg)
    return ChurnEvent("control_update", {
        "table": "ssm_state",
        "fields": {"state": np.zeros((N_SLOTS, w), np.float32),
                   "count": np.zeros(N_SLOTS, np.int32)}})


def _mv_ssm_warm(plane, rng, traffic):
    """Mark a few slots dirty on the host (count>0, nonzero state):
    the SSD pass must DECLINE at the next recompile and the data plane
    must restore the written state rows exactly."""
    w = _ssm_state_width(plane.cfg)
    rows = int(rng.integers(2, 17))
    return ChurnEvent("control_update", {
        "table": "ssm_state",
        "fields": {"state": (rng.standard_normal((rows, w)) * 0.01)
                   .astype(np.float32),
                   "count": np.ones(rows, np.int32)}})


register_churn_move("update_req_class", _mv_update_req_class)
register_churn_move("update_vocab", _mv_update_vocab)
register_churn_move("update_cross", _mv_update_cross,
                    applies=lambda p: p.has_cross or p.has_media)
register_churn_move("flag_flip", _mv_flag_flip)
register_churn_move("hotset_rotate", _mv_hotset_rotate)
register_churn_move("sampler", _mv_sampler, weight=0.5)
register_churn_move("ssm_flush", _mv_ssm_flush,
                    applies=lambda p: p.has_ssm)
register_churn_move("ssm_warm", _mv_ssm_warm,
                    applies=lambda p: p.has_ssm)


# ---- schedule generation ------------------------------------------------

def _step_event(plane, rng, traffic):
    return ChurnEvent("step", {
        "batch": make_batch(plane, rng, traffic),
        "rows": make_rows(plane, rng, int(rng.integers(1, 7)), traffic)})


def generate_schedule(plane: ArchPlane, seed: int = 0,
                      n_events: int = 60,
                      chaos: bool = False) -> List[ChurnEvent]:
    """A deterministic >= ``n_events`` churn schedule for ``plane``.

    Structure: a warmup run of steps (fills the sketches) and a first
    recompile; a churned body where ~2/3 of events are steps and every
    applicable registered move fires at least once; at least two
    injected mispredicts, each immediately followed by a step (so the
    guard's deopt is observable); periodic recompiles; and a final
    recompile followed by steps, so the terminal plan is exercised too.
    """
    if chaos:
        raise NotImplementedError(
            "chaos schedules wait for the fault-tolerance slice of the "
            "port (ROADMAP.md Queue 1 item 9)")
    rng = np.random.default_rng(seed)
    traffic = TrafficState()
    ev: List[ChurnEvent] = []

    def extend(e) -> None:
        ev.extend(e if isinstance(e, list) else [e])

    warmup = 8
    for _ in range(warmup):
        ev.append(_step_event(plane, rng, traffic))
    ev.append(ChurnEvent("recompile", {}))

    names = churn_moves(plane)
    weights = np.array([_MOVES[n]["weight"] for n in names], np.float64)
    weights = weights / weights.sum()
    pending = list(names)          # each applicable move >= once
    mispredicts = 2
    body = max(n_events - len(ev) - 8, 24)
    since_recompile = 0
    for i in range(body):
        since_recompile += 1
        if since_recompile >= 12:
            ev.append(ChurnEvent("recompile", {}))
            since_recompile = 0
            continue
        r = rng.random()
        if mispredicts and r < mispredicts / max(body - i, 1) * 4:
            ev.append(ChurnEvent("inject_mispredict", {}))
            ev.append(_step_event(plane, rng, traffic))
            mispredicts -= 1
            continue
        if r < 0.35:
            name = (pending.pop(0) if pending else
                    str(rng.choice(names, p=weights)))
            e = _MOVES[name]["factory"](plane, rng, traffic)
            if e is not None:
                extend(e)
                continue
        ev.append(_step_event(plane, rng, traffic))
    for name in pending:           # any move the body never reached
        e = _MOVES[name]["factory"](plane, rng, traffic)
        if e is not None:
            extend(e)
    while mispredicts:
        ev.append(ChurnEvent("inject_mispredict", {}))
        ev.append(_step_event(plane, rng, traffic))
        mispredicts -= 1

    ev.append(ChurnEvent("recompile", {}))
    for _ in range(4):
        ev.append(_step_event(plane, rng, traffic))
    return ev
