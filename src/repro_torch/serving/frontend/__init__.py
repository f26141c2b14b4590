"""Request-level serving frontend (queue -> batcher -> fused dispatch).

The subsystem that turns the repo's batch-at-a-time serve loop into a
request server: admission-controlled queueing, deadline shedding,
dynamic batch formation against the active plan's pad buckets, fused
``step_many`` dispatch, per-request SLO accounting, and the arrival
profile that lets :class:`~repro_torch.core.passes.batch_shape.\
BatchShapePass` recompile batch shapes from observed traffic.  Ported
from ``repro.serving.frontend``.
"""
from .arrivals import OpenLoopDriver, bursty_onoff_gaps, poisson_gaps
from .batcher import DynamicBatcher
from .frontend import FrontendConfig, Request, RequestQueue, \
    ServingFrontend, default_ladder
from .profile import ArrivalProfile
