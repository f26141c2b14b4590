"""Pluggable pass registry — the declarative optimization surface.

Morpheus' pipeline (§4.3) is an *ordered* sequence of specialization
passes.  Instead of hardcoding that sequence in the engine, the engine
walks a :class:`PassRegistry`: for every analyzed call site, the first
registered pass whose ``match`` accepts the site and whose ``plan``
returns a :class:`SiteSpec` claims it; plan-level passes (flag pinning,
guard elision) run once at the end via ``finalize``.

Growing a new optimization is therefore one class + one ``register``
call — no engine changes (the Parasol / online-specialization lesson:
the pass surface, not the pass set, is the product).

    class MyPass(SpecializationPass):
        name = "my_pass"
        def match(self, site):  return site.kind == "lookup"
        def plan(self, site, snapshot, stats):
            return SiteSpec(...) or None

    registry = default_registry(...)
    registry.register(MyPass(), before="fastpath")
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..instrument import SketchConfig
from ..specialize import SiteSpec
from ..tables import CallSite, Table


@dataclass(frozen=True)
class PlanInputs:
    """Everything a pass may consult besides the table snapshot: the
    engine's RO/RW classification, per-site heavy-hitter stats read from
    the instrumentation sketches, the sketch config, the control
    plane's feature flags, and (when a serving frontend is attached) the
    request-level traffic ``profile`` — arrival rate, batch-size
    histogram, pad-bucket occupancy — consumed by plan-level passes
    like :class:`~repro_torch.core.passes.batch_shape.BatchShapePass`."""
    mutability: Mapping[str, str]
    hot_stats: Mapping[str, Tuple[np.ndarray, float]]
    sketch: SketchConfig
    features: Mapping[str, bool]
    profile: Optional[Mapping] = None

    def mut(self, table: str) -> str:
        """RO/RW classification of ``table`` ("rw" when unknown — the
        conservative default forbids unguarded specialization)."""
        return self.mutability.get(table, "rw")

    def hot_for(self, site_id: str) -> Tuple[np.ndarray, float]:
        """Heavy-hitter readout for one call site: ``(hot_keys,
        coverage)``, already merged across devices on a mesh.  Empty
        keys / zero coverage when the site was not instrumented."""
        return self.hot_stats.get(site_id, (np.array([], np.int32), 0.0))


@dataclass
class PlanDraft:
    """Mutable plan under construction; ``finalize`` passes decorate it."""
    specs: Dict[str, Optional[SiteSpec]] = field(default_factory=dict)
    site_mut: Dict[str, str] = field(default_factory=dict)
    flags: Dict[str, bool] = field(default_factory=dict)
    stats: Dict[str, int] = field(default_factory=dict)

    def count(self, key: str, n: int = 1) -> None:
        self.stats[key] = self.stats.get(key, 0) + n


class SpecializationPass:
    """Base pass.  ``name`` keys pass statistics and registry lookups.

    Site passes implement ``match`` + ``plan``; plan-level passes (flag
    pinning, guard elision) implement ``finalize`` and never claim
    sites."""

    name: str = "pass"

    def match(self, site: CallSite) -> bool:
        return site.kind == "lookup"

    def plan(self, site: CallSite, snapshot: Dict[str, Table],
             stats: PlanInputs) -> Optional[SiteSpec]:
        return None

    def finalize(self, draft: PlanDraft, snapshot: Dict[str, Table],
                 stats: PlanInputs) -> None:
        pass


class PassRegistry:
    """Ordered, mutable pass pipeline."""

    def __init__(self, passes: Tuple[SpecializationPass, ...] = ()):
        self._passes: List[SpecializationPass] = list(passes)
        for p in self._passes:
            self._check_unique(p)

    # ---- composition ------------------------------------------------------
    def _check_unique(self, p: SpecializationPass) -> None:
        if sum(1 for q in self._passes if q.name == p.name) > 1:
            raise ValueError(f"duplicate pass name {p.name!r}")

    def _index(self, name: str) -> int:
        for i, p in enumerate(self._passes):
            if p.name == name:
                return i
        raise KeyError(f"no pass named {name!r} "
                       f"(registered: {self.names()})")

    def register(self, p: SpecializationPass, *,
                 before: Optional[str] = None,
                 after: Optional[str] = None) -> "PassRegistry":
        """Insert ``p``; by default appended, else anchored to an
        existing pass name.  Returns self for chaining."""
        if before is not None and after is not None:
            raise ValueError("pass either before= or after=, not both")
        if any(q.name == p.name for q in self._passes):
            raise ValueError(f"duplicate pass name {p.name!r}")
        if before is not None:
            self._passes.insert(self._index(before), p)
        elif after is not None:
            self._passes.insert(self._index(after) + 1, p)
        else:
            self._passes.append(p)
        return self

    def remove(self, name: str) -> SpecializationPass:
        return self._passes.pop(self._index(name))

    def get(self, name: str) -> SpecializationPass:
        return self._passes[self._index(name)]

    def names(self) -> List[str]:
        return [p.name for p in self._passes]

    def __iter__(self):
        return iter(self._passes)

    def __len__(self) -> int:
        return len(self._passes)

    # ---- planning ---------------------------------------------------------
    def build(self, sites, snapshot: Dict[str, Table],
              stats: PlanInputs) -> PlanDraft:
        """Walk every analyzed call site through the ordered pipeline;
        first pass to return a SiteSpec claims the site.  Then run every
        pass's ``finalize`` in order."""
        draft = PlanDraft()
        for site in sites:
            draft.site_mut[site.site_id] = stats.mut(site.table)
            claimed = False
            for p in self._passes:
                if not p.match(site):
                    continue
                spec = p.plan(site, snapshot, stats)
                if spec is not None:
                    draft.specs[site.site_id] = spec
                    draft.count(p.name)
                    claimed = True
                    break
            if not claimed and site.kind == "lookup":
                draft.specs[site.site_id] = None
                draft.count("generic")
        for p in self._passes:
            p.finalize(draft, snapshot, stats)
        return draft
