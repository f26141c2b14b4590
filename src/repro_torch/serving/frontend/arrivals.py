"""Synthetic open-loop arrival processes.

Ported from ``repro.serving.frontend.arrivals`` (host-only; copied so
the port imports nothing of the reference).

Open-loop means arrivals do not wait for completions — exactly the
regime where batching policy matters (a closed loop self-throttles and
hides queueing).  Two generators cover the bench's arrival mixes:

  * :func:`poisson_gaps` — memoryless arrivals at a target rate;
  * :func:`bursty_onoff_gaps` — an ON/OFF (interrupted Poisson)
    process: bursts of closely spaced arrivals separated by idle gaps,
    with the SAME long-run rate as the Poisson trace, so the two mixes
    isolate burstiness from load.

:class:`OpenLoopDriver` replays a gap sequence against one or more
frontends (round-robin — the multi-plane ``--frontend --planes N``
topology), sleeping real time between submissions.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np


def poisson_gaps(rate_hz: float, n: int, seed: int = 0) -> np.ndarray:
    """N exponential inter-arrival gaps with mean ``1/rate_hz``."""
    rng = np.random.default_rng(seed)
    return rng.exponential(1.0 / float(rate_hz), n)


def bursty_onoff_gaps(rate_hz: float, n: int, seed: int = 0,
                      burst_len: int = 32,
                      duty: float = 0.25) -> np.ndarray:
    """N inter-arrival gaps from an ON/OFF process at long-run rate
    ``rate_hz``: bursts of ``burst_len`` arrivals at rate
    ``rate_hz/duty`` separated by OFF gaps sized so the overall mean
    gap stays ``1/rate_hz`` (``duty`` is the fraction of time ON)."""
    if not (0.0 < duty <= 1.0):
        raise ValueError("duty must be in (0, 1]")
    rng = np.random.default_rng(seed)
    on_rate = float(rate_hz) / duty
    gaps = rng.exponential(1.0 / on_rate, n)
    # every burst_len-th gap becomes the OFF period: its mean makes up
    # exactly the time the fast ON gaps saved
    off_mean = (burst_len / float(rate_hz)) * (1.0 - duty)
    idx = np.arange(n) % burst_len == 0
    idx[0] = False                      # no leading idle gap
    gaps[idx] = rng.exponential(off_mean, int(idx.sum()))
    return gaps


class OpenLoopDriver:
    """Replay an arrival trace against a fleet of frontends.

    ``payloads[i]`` is submitted after sleeping ``gaps[i]``, to
    ``frontends[i % len(frontends)]`` (round-robin load balancing),
    with a relative deadline of ``deadline_s`` when given.  When the
    round-robin target's plane is degraded/quarantined
    (``ServingFrontend.plane_healthy``) the driver reroutes to the next
    healthy frontend in ring order — the fleet-level half of degraded-
    mode serving; with every plane sick, the original target takes the
    submission and sheds it with its explicit ``PLANE_DEGRADED``
    rejection (the loss stays accounted, never silent).  Run inline
    (:meth:`run`) or on a thread (:meth:`start` / :meth:`join`); the
    submitted :class:`Request` objects land in ``self.requests``."""

    def __init__(self, frontends: Sequence, payloads: Sequence,
                 gaps: Sequence[float],
                 deadline_s: Optional[float] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 reroute: bool = True):
        if len(payloads) != len(gaps):
            raise ValueError("need one gap per payload")
        self.frontends = list(frontends)
        self.payloads = list(payloads)
        self.gaps = list(gaps)
        self.deadline_s = deadline_s
        self.sleep = sleep
        self.reroute = reroute
        self.rerouted = 0
        self.requests: List = []
        self._thread: Optional[threading.Thread] = None

    def _pick(self, i: int):
        nf = len(self.frontends)
        fe = self.frontends[i % nf]
        if not self.reroute or nf == 1:
            return fe
        try:
            if fe.plane_healthy:
                return fe
            for off in range(1, nf):
                alt = self.frontends[(i + off) % nf]
                if alt.plane_healthy:
                    self.rerouted += 1
                    return alt
        except AttributeError:
            pass            # bare stubs without the health predicate
        return fe

    def run(self) -> List:
        for i, (payload, gap) in enumerate(zip(self.payloads,
                                               self.gaps)):
            if gap > 0:
                self.sleep(float(gap))
            fe = self._pick(i)
            self.requests.append(
                fe.submit(payload, deadline_s=self.deadline_s))
        return self.requests

    def start(self) -> "OpenLoopDriver":
        self._thread = threading.Thread(target=self.run,
                                        name="openloop-driver",
                                        daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> List:
        if self._thread is not None:
            self._thread.join(timeout)
        return self.requests
