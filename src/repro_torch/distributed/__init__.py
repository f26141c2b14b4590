"""The distributed layer (the reference's ``repro.distributed``): the
mesh and its policy (``meshctx``), the single-controller ``shard_map``
and fixed-order collectives (``compat``), the logical-axis sharding
rules and the ZeRO placement of a train state (``sharding``), and
fault injection, straggler detection and the elastic reshard of a
checkpoint onto a resized mesh (``fault``)."""
from .fault import FailureInjector, LostStepError, SimulatedCompileFailure, \
    SimulatedDeviceLoss, SimulatedFailure, StragglerMonitor, \
    elastic_reshard
from .meshctx import Mesh, MeshPolicy, data_plane_mesh, get_policy, \
    set_policy, use_policy

__all__ = ["FailureInjector", "LostStepError", "Mesh", "MeshPolicy",
           "SimulatedCompileFailure", "SimulatedDeviceLoss",
           "SimulatedFailure", "StragglerMonitor", "data_plane_mesh",
           "elastic_reshard", "get_policy", "set_policy", "use_policy"]
