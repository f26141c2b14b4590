"""Dead code elimination via control-plane feature flags (§4.3.3).

Feature flags are RO control-plane state.  The plan pins every flag to
its current value, keyed by flag *name* (the same key ``ctx.flag`` looks
up — one control-plane fact pins every call site of that flag);
``ctx.flag`` then returns a Python bool at trace time, so the untaken
branch never runs — the paper's "no QUIC VIPs => remove the
QUIC branch", with the program-level guard (dispatcher version check)
protecting the assumption."""
from __future__ import annotations

from .registry import SpecializationPass


class DeadCodePass(SpecializationPass):
    name = "dead_code"

    def match(self, site):
        return site.kind == "flag"

    def finalize(self, draft, snapshot, stats):
        draft.flags.update(dict(stats.features))
