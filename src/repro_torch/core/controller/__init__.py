# The Morpheus control plane as a standalone subsystem: one adaptive
# controller (snapshot workers, shared executable cache, sampling duty
# cycles, recompile scheduling) driving N data planes.
from .controller import ControllerConfig, ControllerStats, \
    MorpheusController
from .health import DEGRADED, HEALTH_STATES, HEALTHY, QUARANTINED, \
    RECOVERING, HealthConfig, PlaneHealth, TokenBucket
from .sampling import PlaneSampling, SamplingConfig
from .scheduler import RecompileScheduler
