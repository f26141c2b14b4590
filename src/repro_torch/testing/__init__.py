"""repro_torch.testing — the arch-zoo conformance subsystem.

Ported from ``repro.testing``.  Morpheus' core safety claim is that
runtime specialization is semantics-preserving: the specialized data
plane must equal the generic one under any control-plane update
sequence, with guards catching every mispredict.

  * :mod:`~repro_torch.testing.archzoo` builds, for every config in
    ``repro_torch.configs.ARCH_IDS``, a serving *plane*: a ctx-based
    step exercising the architecture's distinguishing blocks (SSD scan
    + per-slot state, MoE hot-expert dispatch, cross-attention,
    media-token prepend) against the Morpheus table cast;
  * :mod:`~repro_torch.testing.churn` generates seeded churn schedules
    through an extensible move registry;
  * :mod:`~repro_torch.testing.conformance` drives a specialized
    :class:`~repro_torch.core.MorpheusRuntime` through a schedule while
    a lock-stepped generic oracle replays it, asserting outputs and
    table state bitwise equal at every step;
  * :mod:`~repro_torch.testing.chaos` extends the harness with fault
    injection: degraded-mode serving held to the oracle, and the
    health-gated recovery after every fault;
  * :mod:`~repro_torch.testing.fingerprint` hashes plan signatures
    canonically (the reference's serialization, byte for byte);
    ``python -m repro_torch.testing.fingerprint`` prints the warmup
    scenario's map, for a diff across processes.

  * :func:`~repro_torch.testing.chaos.run_train_chaos` drives the
    training supervisor through a crash and resume, a step fault and
    build faults (the device-loss cell needs a mesh and raises).
"""
from .archzoo import ArchPlane, build_plane, conformance_engine_config
from .chaos import CHAOS_MODES, FAULT_KINDS, TRAIN_SCENARIOS, \
    chaos_health_config, run_chaos, run_train_chaos
from .churn import ChurnEvent, generate_schedule, register_churn_move
from .conformance import ConformanceError, run_conformance
from .fingerprint import plan_fingerprint, run_fingerprints

__all__ = [
    "ArchPlane", "build_plane", "conformance_engine_config",
    "ChurnEvent", "generate_schedule", "register_churn_move",
    "ConformanceError", "run_conformance",
    "CHAOS_MODES", "FAULT_KINDS", "chaos_health_config", "run_chaos",
    "TRAIN_SCENARIOS", "run_train_chaos",
    "plan_fingerprint", "run_fingerprints",
]
