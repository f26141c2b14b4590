"""DataPlaneCtx — the single data-plane API.

User data-plane code (the serving step) is written against this context
instead of raw tensors:

    def serve_step(params, ctx, batch):
        cls = ctx.lookup("req_class", batch["class_id"])
        if ctx.flag("vision_enabled"):
            ...
        ctx.update("sessions", batch["slot"], {...})

The ctx carries the active SpecializationPlan and the incoming
:class:`~repro_torch.core.state.PlaneState`; lookups dispatch through
the plan and fold instrumentation in when the plan is the instrumented
variant.  Flags are keyed by flag *name*, so the same feature consulted
at two call sites is one control-plane fact.

On a device mesh (``EngineConfig.mesh``) the engine runs the step once
per data shard, each with a ctx over the shard's slice of the batch, its
own sketch and its device's copy of the tables: recording is then the
plain :func:`~repro_torch.core.instrument.record` into the shard's own
sketch, with no cross-device traffic.  Such a ctx is given a ``writes``
log: its data-plane writes apply to its own copy *and* are logged, so
the engine can apply every shard's writes, in shard order, to every
replica of the table after the step.  A ctx over a batch that does not
split evenly runs once over the whole batch with ``mesh`` set, and
records through :func:`~repro_torch.core.instrument.record_sharded`,
which cuts the keys into the shards' slices, as the reference's does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import instrument, tables as T
from .specialize import dispatch_lookup
from .state import PlaneState


def last_write_values(idx: torch.Tensor, values: torch.Tensor,
                      capacity: int) -> torch.Tensor:
    """``values`` with every row replaced by the row of the *last*
    occurrence of its index in ``idx`` — so a scatter of the result
    writes, at a repeated index, the value the reference's scatter keeps
    (the last), whatever order the device applies the writes in."""
    order = torch.arange(idx.shape[0], device=idx.device)
    last = torch.zeros(capacity, dtype=order.dtype, device=idx.device)
    last = last.scatter_reduce(0, idx.long(), order, reduce="amax",
                               include_self=False)
    return values[last[idx.long()]]


class DataPlaneCtx:
    """Dispatch context for one run of the step function.

    Built by :meth:`MorpheusEngine.make_step_fn` from the incoming
    :class:`PlaneState`; ``lookup``/``update`` replace entries of its
    dicts (never the input tensors), and :meth:`outputs` returns the
    step's new state.  ``consts`` are the executable's device
    constants (``specialize.plan_constants``).  ``mesh`` /
    ``instr_axes`` select the sharded recording for sharded sketches;
    ``writes`` (a list) logs every :meth:`update` as ``(table, idx,
    values)``."""

    def __init__(self, plan, state: PlaneState,
                 sketch_cfg: instrument.SketchConfig,
                 consts: Optional[Dict] = None, mesh=None,
                 instr_axes: Tuple[str, ...] = ("data",),
                 writes: Optional[List] = None):
        self.plan = plan
        self.tables = dict(state.tables)
        self.instr = dict(state.instr)
        self.guards = dict(state.guards)
        self.sketch_cfg = sketch_cfg
        self.consts = consts
        self.mesh = mesh
        self.instr_axes = instr_axes
        self.writes = writes

    # ---- instrumentation ----------------------------------------------------
    def _record(self, site_id: str, idx: torch.Tensor) -> None:
        """Fold this lookup's keys into the site's sketch — per shard
        when the sketch is sharded, else the one sketch."""
        st = self.instr[site_id]
        if self.mesh is not None and instrument.n_shards(st) is not None:
            self.instr[site_id] = instrument.record_sharded(
                st, idx, self.sketch_cfg, self.mesh, self.instr_axes)
        else:
            self.instr[site_id] = instrument.record(st, idx,
                                                    self.sketch_cfg)

    # ---- data-plane API ---------------------------------------------------
    def lookup(self, name: str, idx: torch.Tensor,
               fields: Optional[Tuple[str, ...]] = None):
        """Read rows ``idx`` of table ``name`` (all fields, or just
        ``fields``), returning ``{field: tensor}`` with the table's row
        shape appended to ``idx``'s shape.  Dispatches through the plan's
        SiteSpec for this call site and records instrumentation when the
        plan is the instrumented executable."""
        site_id = T._register(name, "lookup", fields or ())
        if (self.plan is not None and self.plan.instrumented
                and site_id in self.instr):
            self._record(site_id, idx)
        return dispatch_lookup(self.plan, site_id, name, self.tables,
                               idx, fields, self.guards, self.consts)

    def lookup_or_none(self, name: str, idx: torch.Tensor,
                       fields: Optional[Tuple[str, ...]] = None):
        """Like :meth:`lookup`, but when the plan marks this site
        ELIMINATED (empty table, §4.3.1) returns None — the caller's
        whole branch is skipped, like the paper removing the lookup
        call from the datapath."""
        site_id = T._register(name, "lookup", fields or ())
        spec = self.plan.site(site_id) if self.plan is not None else None
        if spec is not None and spec.impl == "eliminated":
            return None
        if (self.plan is not None and self.plan.instrumented
                and site_id in self.instr):
            self._record(site_id, idx)
        return dispatch_lookup(self.plan, site_id, name, self.tables,
                               idx, fields, self.guards, self.consts)

    def update(self, name: str, idx: torch.Tensor,
               values: Dict[str, torch.Tensor]) -> None:
        """Data-plane write: scatter ``values`` into rows ``idx`` of the
        RW table ``name``.  Where ``idx`` repeats, the last row wins, as
        in the reference.  The new contents travel in the step's output
        :class:`PlaneState`; the table's guard is invalidated in the
        same step (§4.3.6), deoptimizing any specialization that assumed
        the old contents."""
        T._register(name, "update")
        state = dict(self.tables[name])
        values = {k: v.to(state[k].dtype) for k, v in values.items()}
        if self.writes is not None:
            self.writes.append((name, idx, values))
        for k, v in values.items():
            t = state[k]
            v = last_write_values(idx, v, t.shape[0])
            state[k] = t.index_put((idx.long(),), v)
        self.tables[name] = state
        if name in self.guards:
            self.guards[name] = torch.ones_like(self.guards[name])

    def flag(self, name: str, default: bool = True):
        """Read feature flag ``name`` as a Python bool.  When the plan
        pins the flag (dead-code pass), the pinned value is returned and
        the untaken branch never runs; on the generic plan the
        ``default`` is used."""
        T._register(name, "flag")
        plan_flags = getattr(self.plan, "flags", None) or {}
        if name in plan_flags:
            return plan_flags[name]
        return default

    def hot_experts(self, table: str) -> Optional[Tuple[int, ...]]:
        """Hot set the MoE fast-path pass planned for ``table``'s lookup
        site (branch injection, §4.3.5), or None when the pass did not
        fire."""
        return self.fastpath_keys(table, "moe_fastpath")

    def fastpath_keys(self, table: str, impl: str = "moe_fastpath"
                      ) -> Optional[Tuple[int, ...]]:
        """Hot set a branch-injection pass planned for one of
        ``table``'s lookup sites, or None when the pass did not fire."""
        if self.plan is None:
            return None
        return self.plan.fastpath_keys(table, impl)

    def table_array(self, name: str, field: str) -> torch.Tensor:
        """Raw read of one field's full backing tensor (the step's current
        contents, prior ``update`` writes included).  For branch-injected
        code ONLY: a slow branch gathering rows the fast branch provably
        does not need must not go through :meth:`lookup`, which would
        register a call site (and record instrumentation) that the other
        branch lacks.  No site is registered and nothing is recorded here;
        callers pair this with an unconditional cheap lookup (the SSD fast
        path's ``count`` site) that keeps the table instrumented."""
        return self.tables[name][field]

    def outputs(self) -> PlaneState:
        """The step's output :class:`PlaneState`."""
        return PlaneState(self.tables, self.instr, self.guards)
