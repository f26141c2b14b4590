# Morpheus core: dynamic recompilation of PyTorch data planes.
from .controller import ControllerConfig, ControllerStats, \
    HealthConfig, MorpheusController, PlaneHealth, PlaneSampling, \
    RecompileScheduler, SamplingConfig
from .ctx import DataPlaneCtx
from .engine import EngineConfig, MorpheusEngine
from .execcache import CacheStats, ExecutableCache
from .histogram import StreamingHistogram
from .instrument import SketchConfig, SketchDoubleBuffer
from .passes import BATCH_SHAPE_SITE, BatchShapePass, PassRegistry, \
    SpecializationPass, SSDFastPathPass, default_registry, \
    plan_batch_shape
from .runtime import MorpheusRuntime, RuntimeStats, stack_batches
from .snapshot import TableSnapshotWorker, VersionedSnapshot
from .specialize import GENERIC_PLAN, SiteSpec, SpecializationPlan
from .state import PlaneState
from .tables import Table, TableSet
