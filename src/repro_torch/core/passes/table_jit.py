"""JIT table specialization + table elimination (§4.3.1)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..specialize import SiteSpec
from ..tables import Table
from .registry import SpecializationPass


class TableEliminationPass(SpecializationPass):
    name = "eliminated"

    def plan(self, site, snapshot, stats):
        return propose_eliminate(snapshot[site.table])


class InlineJITPass(SpecializationPass):
    name = "inlined"

    def plan(self, site, snapshot, stats):
        return propose_inline(snapshot[site.table], stats.mut(site.table))


def propose_eliminate(table: Table) -> Optional[SiteSpec]:
    """Empty tables disappear from the datapath entirely."""
    if table.n_valid == 0:
        const = tuple((k, v) for k, v in (table.default or {}).items())
        return SiteSpec(impl="eliminated", const_fields=const)
    return None


def propose_inline(table: Table, mutability: str) -> Optional[SiteSpec]:
    """Small RO tables are unconditionally compiled into the executable:
    contents become per-executable device constants (one-hot matmul
    lookup over them), protected only by the program-level guard."""
    if mutability != "ro" or table.n_valid > table.max_inline:
        return None
    inline = tuple(
        (k, np.array(v[: table.n_valid]))
        for k, v in table.fields.items())
    return SiteSpec(impl="inline_const", inline_fields=_hashable(inline))


def _hashable(fields):
    return tuple((k, _Frozen(v)) for k, v in fields)


class _Frozen:
    """numpy array wrapper that hashes by content (plans must be
    hashable executable-cache keys)."""

    def __init__(self, arr: np.ndarray):
        self.arr = np.asarray(arr)
        self._h = hash(self.arr.tobytes()) ^ hash(self.arr.shape)

    def __hash__(self):
        return self._h

    def __eq__(self, other):
        return (isinstance(other, _Frozen)
                and self.arr.shape == other.arr.shape
                and np.array_equal(self.arr, other.arr))

    # numpy/jnp interop
    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.arr, dtype=dtype)

    @property
    def shape(self):
        return self.arr.shape

    @property
    def dtype(self):
        return self.arr.dtype

    def __len__(self):
        return len(self.arr)
