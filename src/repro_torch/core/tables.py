"""Match-action tables for PyTorch data planes.

The paper's *maps* (§4.1).  A :class:`Table` is a named, fixed-capacity,
dict-of-field-arrays lookup structure whose device copy the step function
("data plane") reads; the host ("control plane") rewrites it through
:meth:`TableSet.control_update`, and RW tables are also written by the
step itself (session state, the ``conn_table`` analogue).

Host contents are numpy arrays, the same as the reference's
(``repro.core.tables``), so both packages build byte-identical tables;
:meth:`Table.device_arrays` makes the torch copies a
:class:`~repro_torch.core.state.PlaneState` carries.

Model/serving code never indexes the tensors directly; it goes through
:class:`~repro_torch.core.ctx.DataPlaneCtx`, whose ``lookup`` /
``update`` / ``flag`` register the *call site* in the analysis registry
below while the step runs under :class:`analyzing`.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class Table:
    """Host-side descriptor.  ``fields`` maps field name -> np array of
    shape (capacity, ...).  ``n_valid`` rows are live."""
    name: str
    fields: Dict[str, np.ndarray]
    n_valid: int
    mutability: str = "auto"          # "ro" | "rw" | "auto" (from analysis)
    instrument: bool = True           # operator opt-out (§4.2 dim 6)
    max_inline: int = 16              # small-table JIT threshold (§4.3.1)
    default: Optional[Dict[str, Any]] = None   # miss values

    @property
    def capacity(self) -> int:
        return next(iter(self.fields.values())).shape[0]

    def device_arrays(self, device) -> Dict[str, torch.Tensor]:
        # a copy even on the CPU: device state never aliases host arrays
        return {k: torch.from_numpy(np.array(v)).to(device)
                for k, v in self.fields.items()}

    def snapshot(self) -> "Table":
        return Table(self.name, {k: np.array(v) for k, v in
                                 self.fields.items()},
                     self.n_valid, self.mutability, self.instrument,
                     self.max_inline, self.default)


class TableSet:
    """All tables of a data plane + the control-plane version counter.

    Every host-side mutation bumps ``version`` — the program-level guard
    (§4.3.6) compares it against the version the specialized executable
    was built for."""

    def __init__(self, tables: List[Table]):
        self.tables: Dict[str, Table] = {t.name: t for t in tables}
        self.version = 0
        self._lock = threading.Lock()
        self._update_log: List[Tuple[str, int]] = []

    def __getitem__(self, name: str) -> Table:
        return self.tables[name]

    def control_update(self, name: str, fields: Dict[str, np.ndarray],
                       n_valid: Optional[int] = None) -> int:
        """Control-plane write: replaces field contents, bumps version.

        Writes are copy-on-write — each updated field gets a *fresh*
        array and the old one is never mutated — so snapshots taken by
        :meth:`cow_snapshot` stay internally consistent without copying
        any data."""
        with self._lock:
            t = self.tables[name]
            for k, v in fields.items():
                arr = np.array(t.fields[k])
                arr[: len(v)] = v
                t.fields[k] = arr
            if n_valid is not None:
                t.n_valid = n_valid
            self.version += 1
            self._update_log.append((name, self.version))
            return self.version

    def bump_version(self, reason: str = "flags") -> int:
        """Bump the control-plane version without touching any table —
        used for non-table control-plane state (feature flags)."""
        with self._lock:
            self.version += 1
            self._update_log.append((reason, self.version))
            return self.version

    def device_state(self, device) -> Dict[str, Dict[str, torch.Tensor]]:
        """Device copies of every table's fields (table -> field ->
        tensor) — the ``tables`` component of a fresh PlaneState."""
        return {n: t.device_arrays(device) for n, t in self.tables.items()}

    def snapshot(self) -> Dict[str, Table]:
        """Deep host copy of every table, taken under the TableSet lock.
        O(bytes); prefer :meth:`cow_snapshot` on hot paths."""
        with self._lock:
            return {n: t.snapshot() for n, t in self.tables.items()}

    def cow_snapshot(self) -> Tuple[int, Dict[str, Table]]:
        """Copy-on-write snapshot: ``(version, tables)`` sharing field
        arrays by reference — safe because :meth:`control_update`
        replaces field arrays instead of mutating them.  The version is
        read under the same lock, so the pair is consistent."""
        with self._lock:
            tabs = {n: Table(t.name, dict(t.fields), t.n_valid,
                             t.mutability, t.instrument, t.max_inline,
                             t.default)
                    for n, t in self.tables.items()}
            return self.version, tabs


# ---------------------------------------------------------------------------
# Call-site registry (filled while the analysis run executes the step)
# ---------------------------------------------------------------------------

@dataclass
class CallSite:
    table: str
    site_id: str
    kind: str                       # "lookup" | "update" | "flag"
    fields: Tuple[str, ...] = ()


class _AnalysisContext(threading.local):
    def __init__(self):
        self.active = False
        self.sites: List[CallSite] = []
        self.counters: Dict[str, int] = {}


_CTX = _AnalysisContext()


def _register(table: str, kind: str, fields=()) -> str:
    n = _CTX.counters.get(table, 0)
    _CTX.counters[table] = n + 1
    site_id = f"{table}#{n}"
    if _CTX.active:
        _CTX.sites.append(CallSite(table, site_id, kind, tuple(fields)))
    return site_id


def analysis_sites():
    return list(_CTX.sites)


class analyzing:
    """Context manager: record call sites while the step runs."""

    def __enter__(self):
        _CTX.active = True
        _CTX.sites = []
        _CTX.counters = {}
        return self

    def __exit__(self, *a):
        _CTX.active = False
        return False


def reset_site_counters():
    """Call before each step so site ids are stable across steps."""
    _CTX.counters = {}
