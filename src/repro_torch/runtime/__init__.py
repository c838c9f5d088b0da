"""The serving runtime of the port (:mod:`repro.runtime`'s counterpart).

``AsyncEngine`` and ``BucketPlacer`` (the reference's ``scheduler.py``)
are not ported yet.
"""
from .engine import (
    EngineStats,
    InferenceEngine,
    PrecompileReport,
    ProgramCache,
    RerankReport,
    Request,
    Result,
)
from .fault_tolerance import ResilientRunner, StragglerMonitor
from .faults import COMPILE, FaultInjector, FaultRule, InjectionEvent, kill_pallas
from .resilience import (
    STATUS_DEGRADED,
    STATUS_FAILED,
    STATUS_OK,
    STATUS_REJECTED,
    STATUSES,
    DeadlineExceeded,
    EngineOverloaded,
    InvalidRequest,
    KernelFault,
    NumericalFault,
    OversizedGraph,
    RetryPolicy,
    ServingError,
    Tier,
    default_ladder,
    validate_request,
)
from .store import (
    ProgramStore,
    enable_persistent_kernel_cache,
    key_digest,
    store_key,
)
