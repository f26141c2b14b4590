"""Fault injection and straggler detection (the reference's
``repro.distributed``).  The mesh policy, collectives and elastic
resharding wait for the sharding slice of the port (ROADMAP.md Queue 1
item 12)."""
from .fault import FailureInjector, LostStepError, SimulatedCompileFailure, \
    SimulatedDeviceLoss, SimulatedFailure, StragglerMonitor

__all__ = ["FailureInjector", "LostStepError", "SimulatedCompileFailure",
           "SimulatedDeviceLoss", "SimulatedFailure", "StragglerMonitor"]
