"""Guard elision (§4.3.6).

Every specialized site theoretically needs a consistency guard.  Morpheus
collapses all control-plane guards into ONE program-level version check in
the dispatcher (zero in-graph cost) and keeps in-graph guards only where
the data plane itself can invalidate the specialization — RW tables.

This pass runs last (plan-level ``finalize``): it decorates the chosen
SiteSpecs with ``guarded`` and reports how many guards were elided (the
saving is measured in benchmarks/bench_passes)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..specialize import SiteSpec
from .registry import SpecializationPass


def apply_guard_elision(specs: Dict[str, Optional[SiteSpec]],
                        site_mut: Dict[str, str]
                        ) -> Tuple[Dict[str, Optional[SiteSpec]],
                                   Dict[str, int]]:
    """specs: site_id -> spec (None = generic).  Returns (decorated
    specs, stats)."""
    out: Dict[str, Optional[SiteSpec]] = {}
    stats = {"guards_kept": 0, "guards_elided": 0}
    for sid, spec in specs.items():
        if spec is None:
            out[sid] = None
            continue
        if site_mut.get(sid) == "rw" and spec.impl in ("hot_cache",):
            out[sid] = dataclasses.replace(spec, guarded=True)
            stats["guards_kept"] += 1
        else:
            # RO: the dispatcher's program-level version check covers it
            out[sid] = dataclasses.replace(spec, guarded=False)
            stats["guards_elided"] += 1
    return out, stats


class GuardElisionPass(SpecializationPass):
    name = "guard_elision"

    def match(self, site):
        return False              # plan-level only

    def finalize(self, draft, snapshot, stats):
        draft.specs, gstats = apply_guard_elision(draft.specs,
                                                  draft.site_mut)
        for k, v in gstats.items():
            draft.count(k, v)
