"""SpecializationPlan + lookup dispatch.

The plan is the engine's output: per call site, which implementation to
run.  It is HASHABLE — the runtime caches one executable per distinct
plan *signature*.  ``signature`` carries exactly the plan's constants;
``version`` carries plan identity for the host-side program guard, so
behaviorally identical plans at different table versions share one
executable (see ``repro_torch.core.execcache``).

The class and field names are the reference's (``repro.core.specialize``)
so that the reference's duck-typed ``repro.testing.fingerprint`` hashes a
plan of either package the same way.

An executable's device constants (hot ids, inlined tables, constant
rows) are built once, by :func:`plan_constants` when the engine builds
it, and handed to :func:`dispatch_lookup`; called without them, a lookup
builds its site's constants on each call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as kops


@dataclass(frozen=True)
class SiteSpec:
    impl: str = "gather"       # gather | onehot | hot_cache | inline_const
                               # | const_row | eliminated | moe_fastpath
                               # | ssd_fastpath
    hot_keys: Tuple[int, ...] = ()
    guarded: bool = False      # RW site guard (guard elision decides)
    const_fields: Tuple[Tuple[str, Any], ...] = ()   # const-prop per field
    inline_fields: Tuple[Tuple[str, Any], ...] = ()  # full inlined content


@dataclass(frozen=True)
class SpecializationPlan:
    version: int = -1                                # TableSet version
    sites: Tuple[Tuple[str, SiteSpec], ...] = ()
    flags: Any = None                                # dict flag name -> bool
    instrumented: bool = False
    label: str = "generic"

    def __post_init__(self):
        # not a dataclass field — excluded from eq/hash/replace
        object.__setattr__(self, "_site_map", dict(self.sites))

    def site(self, site_id: str) -> Optional[SiteSpec]:
        """The SiteSpec planned for ``site_id`` (None = stay generic)."""
        return self._site_map.get(site_id)

    def fastpath_keys(self, table: Optional[str] = None,
                      impl: str = "moe_fastpath"
                      ) -> Optional[Tuple[int, ...]]:
        """Hot set a branch-injection pass (``moe_fastpath``,
        ``ssd_fastpath``, ...) planned for one of ``table``'s lookup
        sites (any table when None), or None when no such site was
        specialized."""
        for sid, spec in self.sites:
            if spec.impl != impl:
                continue
            if table is None or sid.split("#")[0] == table:
                return spec.hot_keys or None
        return None

    def hot_experts(self, table: Optional[str] = None
                    ) -> Optional[Tuple[int, ...]]:
        """Hot set the MoE fast-path pass planned for ``table`` (any
        table when None), or None when no such site was specialized."""
        return self.fastpath_keys(table, "moe_fastpath")

    @property
    def signature(self):
        """Executable identity: exactly the plan's constants — sites
        (with their inlined values / hot sets), pinned flags, and whether
        this is the instrumented twin.  Excludes ``version``: plans with
        equal signatures run identical code, and plan *identity* is
        checked host-side by the dispatcher's program guard."""
        return (self.sites, tuple(sorted((self.flags or {}).items())),
                self.instrumented)

    @property
    def key(self):
        """Full plan identity: ``(version, *signature)``."""
        return (self.version,) + self.signature


GENERIC_PLAN = SpecializationPlan(flags={})


def site_constants(spec: SiteSpec, table_state, device
                   ) -> Dict[str, torch.Tensor]:
    """The device constants one site's impl reads: the hot ids of a
    ``hot_cache`` site, the inlined fields of an ``inline_const`` site,
    the constant rows of a ``const_row`` / ``eliminated`` site."""
    if spec.impl == "hot_cache":
        return {"hot_ids": torch.tensor(spec.hot_keys, dtype=torch.int32,
                                        device=device)}
    if spec.impl == "inline_const":
        return {f: torch.as_tensor(np.asarray(v)).to(device, copy=True)
                for f, v in spec.inline_fields}
    if spec.impl in ("const_row", "eliminated"):
        return {f: torch.as_tensor(np.asarray(v),
                                   dtype=table_state[f].dtype,
                                   device=device)
                for f, v in spec.const_fields
                if v is not None and f in table_state}
    return {}


def plan_constants(plan: SpecializationPlan, tables, device
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every site's device constants (site id -> name -> tensor), built
    once when an executable is built."""
    return {sid: site_constants(spec, tables.get(sid.split("#")[0], {}),
                                device)
            for sid, spec in plan.sites}


def _gather(table_state, idx, fields):
    names = fields or tuple(table_state.keys())
    return {f: table_state[f][idx] for f in names}


def _onehot(table_state, idx, fields, n_valid: int):
    """Small-table lookup as a one-hot matmul — data-structure
    specialization (§4.3.4).  Bitwise a gather for finite float tables
    (TF32 is off, see ``repro_torch/__init__.py``)."""
    names = fields or tuple(table_state.keys())
    out = {}
    for f in names:
        t = table_state[f][:n_valid]
        if t.is_floating_point() and t.dim() >= 2:
            # contract the one-hot axis against the table's row axis;
            # tensordot keeps this rank-polymorphic in idx
            oh = F.one_hot(idx.long(), n_valid).to(t.dtype)
            out[f] = torch.tensordot(oh, t, dims=([-1], [0]))
        else:
            out[f] = t[idx.clamp(0, n_valid - 1)]
    return out


def _hot_cache(table_state, idx, fields, hot_ids: torch.Tensor):
    """Fast-path cache (§4.3.1): heavy-hitter rows served from a small
    copy staged in shared memory (the CUDA ``hot_gather`` kernel on the
    card), cold rows from the full table.  Semantics identical to a
    plain gather."""
    names = fields or tuple(table_state.keys())
    out = {}
    for f in names:
        t = table_state[f]
        if t.dim() >= 2 and t.is_floating_point():
            hot_rows = t.index_select(0, hot_ids)
            flat_idx = idx.reshape(-1).to(torch.int32).contiguous()
            res = kops.hot_gather(t, hot_rows, hot_ids, flat_idx)
            out[f] = res.reshape(*idx.shape, *t.shape[1:])
        else:
            out[f] = t[idx]
    return out


def dispatch_lookup(plan, site_id: str, name: str, table_state, idx,
                    fields, guards, consts: Optional[Dict] = None):
    state = table_state[name]
    spec = plan.site(site_id) if plan is not None else None
    if spec is None or spec.impl in ("gather", "moe_fastpath",
                                     "ssd_fastpath"):
        # the *_fastpath impls specialize the *caller's* dispatch
        # (branch injection); the claimed lookup itself stays a plain
        # gather.
        return _gather(state, idx, fields)

    consts = (consts.get(site_id) if consts is not None else None)
    if consts is None:
        consts = site_constants(spec, state, idx.device)

    if spec.impl == "eliminated":
        # empty table (§4.3.1 table elimination): defaults, no memory touch
        names = fields or tuple(state.keys())
        out = {}
        for f in names:
            t = state[f]
            shape = tuple(idx.shape) + tuple(t.shape[1:])
            if f in consts:
                out[f] = consts[f].expand(shape)
            else:
                out[f] = torch.zeros(shape, dtype=t.dtype,
                                     device=idx.device)
        return out

    if spec.impl == "inline_const":
        # whole table held as the executable's device constants;
        # protected by the program-level guard
        names = fields or tuple(state.keys())
        n_valid = len(next(iter(dict(spec.inline_fields).values())))
        return _onehot(consts, idx, names, n_valid)

    if spec.impl == "const_row":
        # every live row identical -> constant propagation (§4.3.2):
        # the lookup result does not depend on idx at all.
        names = fields or tuple(state.keys())
        return {f: consts[f].expand(tuple(idx.shape)
                                    + tuple(state[f].shape[1:]))
                for f in names}

    if spec.impl == "hot_cache":
        fast = _hot_cache(state, idx, fields, consts["hot_ids"])
        if spec.guarded and guards is not None and name in guards:
            # RW site guard: the plain gather once the data plane has
            # written the table (deoptimization, §4.3.6).  Both sides
            # equal table[idx]; select on the device, no host read.
            ok = guards[name][0] == 0
            slow = _gather(state, idx, fields)
            return {f: torch.where(ok, fast[f], slow[f]) for f in fast}
        return fast

    if spec.impl == "onehot":
        t0 = next(iter(state.values()))
        n_valid = int(t0.shape[0])
        return _onehot(state, idx, fields, n_valid)

    raise ValueError(f"unknown impl {spec.impl!r} for site {site_id}")
