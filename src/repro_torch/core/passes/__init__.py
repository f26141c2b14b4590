"""Morpheus optimization passes (§4.3, Table 2).

Each pass is a :class:`~repro_torch.core.passes.registry.SpecializationPass`
registered in an ordered :class:`~repro_torch.core.passes.registry.PassRegistry`
(``match(site) -> bool``, ``plan(site, snapshot, stats) -> SiteSpec | None``,
optional plan-level ``finalize``).  The default pipeline is the
reference's, in the same priority order:

  table elimination > inline JIT > constant propagation >
  MoE branch injection > SSD-scan branch injection >
  traffic-dependent fast path > data-structure specialization

Dead-code elimination (flag pinning) and guard elision (§4.3.6) are
plan-level passes that run in ``finalize``.
"""
from typing import Optional

from .batch_shape import BATCH_SHAPE_SITE, BatchShapePass, \
    plan_batch_shape
from .branch_inject import MoEFastPathPass, moe_ffn_hotpath, \
    plan_moe_fastpath
from .const_prop import ConstPropPass
from .dead_code import DeadCodePass
from .dstruct import DStructPass
from .fastpath import TrafficFastPathPass
from .guard_elision import GuardElisionPass
from .registry import PassRegistry, PlanDraft, PlanInputs, \
    SpecializationPass
from .ssd_fastpath import SSDFastPathPass, plan_ssd_fastpath
from .table_jit import InlineJITPass, TableEliminationPass


def default_registry(moe_router_table: Optional[str] = None,
                     ssd_state_table: Optional[str] = None
                     ) -> PassRegistry:
    """The paper's pipeline, in priority order."""
    return PassRegistry((
        TableEliminationPass(),
        InlineJITPass(),
        ConstPropPass(),
        MoEFastPathPass(moe_router_table),
        SSDFastPathPass(ssd_state_table),
        TrafficFastPathPass(),
        DStructPass(),
        BatchShapePass(),
        DeadCodePass(),
        GuardElisionPass(),
    ))
