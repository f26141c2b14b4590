"""Signature-keyed executable cache — amortizing t2 across plan churn.

Keying executables by the plan's full ``key`` (which includes the
TableSet version) would make a control-plane bump or an oscillating hot
set (A -> B -> A) rebuild code that is behaviorally identical to an
executable already in hand.  :class:`ExecutableCache` is an LRU map from
``(namespace, plan signature, batch structure[, fused depth])`` to the
executable; the signature carries exactly the plan's constants, so every
plan that runs the same code shares one entry.  One instance can back
several runtimes (one namespace each unless ``EngineConfig.cache_ns``
opts into sharing).

:meth:`ExecutableCache.get_or_compile` deduplicates in-flight builds per
key, and :meth:`ExecutableCache.quarantine` poisons plan signatures whose
recompile cycles kept failing.  Ported from ``repro.core.execcache``;
the reference's persistent XLA compile cache has no counterpart here.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Hashable, Optional

import torch


@dataclass
class CacheStats:
    """Host-side counters of one :class:`ExecutableCache`.
    ``inflight_waits`` counts builds avoided: callers that found another
    thread already building their key and waited for its insert."""
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    inserts: int = 0
    inflight_waits: int = 0
    quarantined: int = 0     # poisoned plan signatures (never rebuilt)


def batch_key(batch: Dict[str, torch.Tensor]) -> Hashable:
    """Hashable identity of a batch's *structure*: per-field shape and
    dtype.  The device is the runtime's (every batch is placed there
    before it is keyed), so a ``device="meta"`` template of a window
    (see ``runtime._induced_window_avals``) keys as the batches it
    stands for."""
    return tuple((k, tuple(v.shape), str(v.dtype))
                 for k, v in sorted(batch.items()))


class ExecutableCache:
    """Bounded LRU cache of executables.  Eviction only drops the
    cache's reference: an evicted executable that is still a runtime's
    active one keeps running and is rebuilt on its next miss."""

    def __init__(self, capacity: int = 64):
        assert capacity >= 1
        self.capacity = capacity
        self.stats = CacheStats()
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._inflight: dict = {}       # key -> Event of the building owner
        self._quarantined: set = set()  # poisoned plan signatures

    @staticmethod
    def make_key(ns: Hashable, signature: Hashable, bkey: Hashable,
                 fuse: Optional[int] = None) -> Hashable:
        """The cache key anatomy: ``(namespace, plan signature, batch
        structure)``, extended with ``("fuse", K)`` for a fused K-step
        window, so a window and a single step over the same plan never
        share an entry."""
        if fuse is None:
            return (ns, signature, bkey)
        return (ns, signature, bkey, ("fuse", fuse))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def get(self, key: Hashable) -> Optional[Any]:
        """The cached executable for ``key`` (marked most-recently-used),
        or None.  Counts a hit or a miss."""
        with self._lock:
            exe = self._entries.get(key)
            if exe is None:
                self.stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return exe

    def probe(self, key: Hashable) -> Optional[Any]:
        """Like :meth:`get` but counting only *hits* (a miss here flows
        into :meth:`get_or_compile`, which counts it)."""
        with self._lock:
            exe = self._entries.get(key)
            if exe is not None:
                self._entries.move_to_end(key)
                self.stats.hits += 1
            return exe

    def peek(self, key: Hashable) -> Optional[Any]:
        """Like :meth:`get` with no stats / recency side effects."""
        with self._lock:
            return self._entries.get(key)

    def put(self, key: Hashable, exe: Any) -> None:
        """Insert ``exe`` under ``key``, evicting least-recently-used
        entries beyond ``capacity``."""
        with self._lock:
            self._entries[key] = exe
            self._entries.move_to_end(key)
            self.stats.inserts += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats.evictions += 1

    def get_or_compile(self, key: Hashable, compile_fn):
        """Fetch ``key``, building it with in-flight deduplication on a
        miss: the first caller to miss runs ``compile_fn`` (returning
        ``(exe, aux)``), concurrent callers of the same key wait for its
        insert.  Returns ``(exe, aux)`` for the owner and ``(exe, None)``
        for hits and waiters.  If the owner's build raises, one waiter
        claims ownership and retries."""
        while True:
            with self._lock:
                exe = self._entries.get(key)
                if exe is not None:
                    self._entries.move_to_end(key)
                    self.stats.hits += 1
                    return exe, None
                ev = self._inflight.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[key] = ev
                    self.stats.misses += 1
                    owner = True
                else:
                    self.stats.inflight_waits += 1
                    owner = False
            if owner:
                try:
                    exe, aux = compile_fn()
                    self.put(key, exe)
                    return exe, aux
                finally:
                    with self._lock:
                        self._inflight.pop(key, None)
                    ev.set()
            ev.wait()

    # ---- quarantine (fleet health) -----------------------------------
    def quarantine(self, signature: Hashable) -> None:
        """Mark a plan *signature* poisoned (the recompile scheduler gave
        up on it) and purge every cached executable built from it.
        Idempotent."""
        with self._lock:
            if signature in self._quarantined:
                return
            self._quarantined.add(signature)
            self.stats.quarantined += 1
            # key anatomy (make_key): key[1] is (plan signature-or-key,
            # instr_struct)
            dead = [k for k in self._entries
                    if isinstance(k, tuple) and len(k) >= 2
                    and isinstance(k[1], tuple) and len(k[1]) >= 1
                    and k[1][0] == signature]
            for k in dead:
                del self._entries[k]
                self.stats.evictions += 1

    def unquarantine(self, signature: Hashable) -> None:
        with self._lock:
            if signature in self._quarantined:
                self._quarantined.discard(signature)
                self.stats.quarantined -= 1

    def is_quarantined(self, signature: Hashable) -> bool:
        with self._lock:
            return signature in self._quarantined

    def purge_namespace(self, ns: Hashable) -> int:
        """Drop every entry whose key was built under ``ns`` (counted as
        evictions); returns how many were dropped.  The owner rotates to
        a fresh namespace when its topology epoch ends."""
        with self._lock:
            dead = [k for k in self._entries
                    if isinstance(k, tuple) and k and k[0] == ns]
            for k in dead:
                del self._entries[k]
                self.stats.evictions += 1
            return len(dead)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
