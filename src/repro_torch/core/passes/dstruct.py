"""Data-structure specialization (§4.3.4): gather or one-hot matmul.

Chooses the lookup implementation for tables that stay generic:

  gather      — row gather: ~rows x row_bytes of random-access traffic
  onehot      — one-hot matmul: T x N x d FLOPs, streaming the table once

The choice comes from a small cost model whose parameters are the
reference planner's (``repro.core.passes.dstruct``), kept unchanged so the
port plans exactly the sites the reference plans.  They describe no
measurement of any device this package runs on.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..specialize import SiteSpec
from ..tables import Table
from .registry import SpecializationPass


class DStructPass(SpecializationPass):
    name = "onehot"

    def plan(self, site, snapshot, stats):
        return propose_dstruct(snapshot[site.table],
                               stats.mut(site.table))


# The reference planner's parameters, kept for plan parity (the same
# snapshot must yield the same plan in both packages).  Not a
# description of this package's device: retuning them would change plans.
MXU_FLOPS = 197e12
HBM_BW = 819e9
GATHER_TXN_BYTES = 512


def lookup_cost(table: Table, impl: str, n_queries: int) -> float:
    row_bytes = sum(np.asarray(v[0]).nbytes for v in table.fields.values())
    n = max(table.n_valid, 1)
    if impl == "gather":
        txns = n_queries * max(1, row_bytes // GATHER_TXN_BYTES + 1)
        return txns * GATHER_TXN_BYTES / HBM_BW
    if impl == "onehot":
        flops = 2.0 * n_queries * n * (row_bytes / 2)   # bf16 elements
        stream = n * row_bytes / HBM_BW
        return flops / MXU_FLOPS + stream
    raise ValueError(impl)


def propose_dstruct(table: Table, mutability: str,
                    n_queries: int = 1024) -> Optional[SiteSpec]:
    if table.n_valid == 0:
        return None
    g = lookup_cost(table, "gather", n_queries)
    o = lookup_cost(table, "onehot", n_queries)
    if o < g:
        return SiteSpec(impl="onehot")
    return None
