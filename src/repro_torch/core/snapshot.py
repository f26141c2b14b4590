"""Off-thread table snapshotting — t1 off the control-plane path.

The Morpheus compilation cycle starts with ``t1``: snapshot the tables,
read the instrumentation, plan.  In the seed runtime the table snapshot
ran inline on whichever thread called ``recompile`` and held the TableSet
lock for the whole copy — a control-plane update arriving mid-snapshot
blocked, and a blocking recompile charged the copy to the caller
("Towards Online Code Specialization of Systems": the specialization
controller must stay off the hot path).

:class:`TableSnapshotWorker` fixes both:

  * a dedicated daemon thread owns all snapshot work;
  * snapshots are *copy-on-write* (``TableSet.cow_snapshot``): the worker
    grabs field-array references under the lock — O(#tables), not
    O(bytes) — which is safe because control-plane writes replace arrays
    instead of mutating them;
  * handoff is versioned: consumers ask for "a snapshot at least as new
    as version v" and receive a :class:`VersionedSnapshot` whose tables
    are exactly the contents at ``snapshot.version``.  If the control
    plane races past, the consumer's plan is stamped with the older
    version and the dispatcher's program-level guard deopts it — stale
    snapshots degrade, they never corrupt.

The worker is event-driven (no polling): ``request()`` kicks it after a
control-plane update, ``get()`` kicks and waits.

Ownership: workers are created and torn down by
:class:`~repro_torch.core.controller.MorpheusController` (one per registered
data plane) — the runtime's ``snapshot_worker`` property delegates
there.  The class itself stays fleet-agnostic: one worker snapshots one
:class:`TableSet`.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

from .tables import Table, TableSet


@dataclass(frozen=True)
class VersionedSnapshot:
    """One consistent host view of a TableSet: ``tables`` are the exact
    contents at ``version``.  ``thread_ident`` records which thread took
    the copy (tests assert it was the worker, not the control plane)."""
    version: int
    tables: Dict[str, Table]
    thread_ident: int
    thread_name: str


class TableSnapshotWorker:
    """Background snapshot thread with versioned copy-on-write handoff.

    Usage::

        worker = TableSnapshotWorker(tables)
        worker.request()                       # after a control update
        snap = worker.get(tables.version)      # at plan time (t1)
        plan, t1, _ = engine.build_plan(instr, snapshot=snap.tables,
                                        version=snap.version)
        worker.stop()

    ``get`` blocks only until the worker publishes a snapshot fresh
    enough — usually immediate, because ``request`` keeps the published
    snapshot current between recompiles.
    """

    def __init__(self, tables: TableSet, name: str = "morpheus-snapshot"):
        self._tables = tables
        self._cond = threading.Condition()
        self._snap: Optional[VersionedSnapshot] = None
        self._stopped = False
        self.snapshots_taken = 0
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    # ---- worker side ------------------------------------------------------
    def _take(self) -> VersionedSnapshot:
        version, tabs = self._tables.cow_snapshot()
        return VersionedSnapshot(version, tabs, threading.get_ident(),
                                 threading.current_thread().name)

    def _run(self) -> None:
        while True:
            with self._cond:
                while (not self._stopped
                       and self._snap is not None
                       and self._snap.version == self._tables.version):
                    self._cond.wait()
                if self._stopped:
                    return
            # take the snapshot OUTSIDE the condition so get()/request()
            # callers never serialize behind the copy
            snap = self._take()
            with self._cond:
                self._snap = snap
                self.snapshots_taken += 1
                self._cond.notify_all()

    # ---- consumer side ----------------------------------------------------
    def request(self) -> None:
        """Kick the worker: the published snapshot is (or will shortly
        be) refreshed to the TableSet's current version.  Non-blocking."""
        with self._cond:
            self._cond.notify_all()

    def get(self, min_version: Optional[int] = None,
            timeout: float = 30.0) -> VersionedSnapshot:
        """Return a snapshot with ``version >= min_version`` (default:
        the TableSet's version at call time), waiting for the worker if
        necessary.  The snapshot copy itself always runs on the worker
        thread, never on the caller's."""
        if min_version is None:
            min_version = self._tables.version
        with self._cond:
            self._cond.notify_all()
            ok = self._cond.wait_for(
                lambda: self._stopped or (
                    self._snap is not None
                    and self._snap.version >= min_version),
                timeout=timeout)
            if self._stopped:
                raise RuntimeError("snapshot worker stopped")
            if not ok:
                raise TimeoutError(
                    f"no table snapshot at version >= {min_version} "
                    f"within {timeout}s")
            return self._snap

    def peek(self) -> Optional[VersionedSnapshot]:
        """The latest published snapshot (possibly stale), or None."""
        with self._cond:
            return self._snap

    def stop(self) -> None:
        """Shut the worker down; subsequent ``get`` calls raise."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)
