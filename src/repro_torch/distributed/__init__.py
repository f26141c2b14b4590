"""The distributed layer (the reference's ``repro.distributed``): the
mesh and its policy (``meshctx``), the single-controller ``shard_map``
and fixed-order collectives (``compat``), the logical-axis sharding
rules (``sharding``), and fault injection and straggler detection
(``fault``).  Elastic resharding of a training run waits for ROADMAP.md
Queue 1 item 12b."""
from .fault import FailureInjector, LostStepError, SimulatedCompileFailure, \
    SimulatedDeviceLoss, SimulatedFailure, StragglerMonitor
from .meshctx import Mesh, MeshPolicy, data_plane_mesh, get_policy, \
    set_policy, use_policy

__all__ = ["FailureInjector", "LostStepError", "Mesh", "MeshPolicy",
           "SimulatedCompileFailure", "SimulatedDeviceLoss",
           "SimulatedFailure", "StragglerMonitor", "data_plane_mesh",
           "get_policy", "set_policy", "use_policy"]
