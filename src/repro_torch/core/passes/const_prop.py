"""Constant propagation across table entries (§4.3.2).

If a field holds the same value in every live row, the lookup of that
field is independent of the key: inline the constant (trace-time) and let
let the step
reuse it — the paper's vip_info->flags example.  When *all*
fields are constant the whole lookup degenerates to constants
(``const_row``)."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..specialize import SiteSpec
from ..tables import Table
from .registry import SpecializationPass
from .table_jit import _Frozen


class ConstPropPass(SpecializationPass):
    name = "const_row"

    def plan(self, site, snapshot, stats):
        return propose_const_row(snapshot[site.table],
                                 stats.mut(site.table))


def constant_fields(table: Table) -> Dict[str, np.ndarray]:
    out = {}
    if table.n_valid == 0:
        return out
    for k, v in table.fields.items():
        live = np.asarray(v[: table.n_valid])
        if len(live) and (live == live[0]).all():
            out[k] = live[0]
    return out


def propose_const_row(table: Table, mutability: str) -> Optional[SiteSpec]:
    if mutability != "ro":
        return None
    consts = constant_fields(table)
    if consts and len(consts) == len(table.fields):
        return SiteSpec(
            impl="const_row",
            const_fields=tuple((k, _Frozen(np.asarray(v)))
                               for k, v in consts.items()))
    return None
