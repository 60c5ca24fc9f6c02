"""Runtime services: checkpointing, recompile triggers, the
fault-tolerance layer (resilience: preemption-safe checkpointing, step
guards, retry/backoff, fault injection), the elastic runtime (elastic
restore, the health watchdog, fault domains), the strategy tuner, the
numerical-trust layer (checkpoint integrity, the differential strategy
verifier, the SDC/determinism canary), the strategy artifact store,
strategy IO and the KV page pool, as the JAX package's
runtime/__init__.py exports them."""
from .artifact_store import (  # noqa: F401
    ArtifactCorruptionError,
    ArtifactStore,
)
from .checkpoint import (  # noqa: F401
    load_checkpoint_meta,
    restore_checkpoint,
    save_checkpoint,
)
from .elastic import (  # noqa: F401
    ElasticRestoreError,
    FileHeartbeat,
    HealthMonitor,
    allreduce_heartbeat,
    restore_elastic,
    shrunk_devices,
)
from .fault_domains import FailureClassification, FaultDomainMap  # noqa: F401
from .kvcache import (  # noqa: F401
    KVCacheConfig,
    KVCacheExhaustedError,
    PagePool,
)
from .recompile import RecompileState, recompile_on_condition  # noqa: F401
from .resilience import (  # noqa: F401
    CheckpointManager,
    FaultInjector,
    InferenceTimeout,
    NonFiniteGradientsError,
    PreemptionSignal,
    ResilienceError,
    RetryPolicy,
    StepGuardConfig,
    TrainingPreempted,
    restore_latest,
    retry,
)
from .strategy_io import (  # noqa: F401
    apply_imported_strategy,
    export_strategy,
    import_strategy,
)
from .tuner import (  # noqa: F401
    StrategyTuner,
    SwapError,
    TunerConfig,
    strategy_fingerprint,
)
from .verify import (  # noqa: F401
    CanaryConfig,
    CanaryMismatchError,
    CheckpointCorruptionError,
    InvariantViolationError,
    NotCompiledError,
    ServingConfigError,
    StrategyDivergenceError,
    VerificationError,
    verify_checkpoint,
    verify_strategy,
)
