"""Runtime services: checkpointing, the fault-tolerance layer
(resilience: preemption-safe checkpointing, step guards, retry/backoff,
fault injection), the numerical-trust layer (checkpoint integrity, the
differential strategy verifier, the SDC/determinism canary) and the
strategy artifact store, as the JAX package's runtime/__init__.py
exports them."""
from .artifact_store import (  # noqa: F401
    ArtifactCorruptionError,
    ArtifactStore,
)
from .checkpoint import (  # noqa: F401
    load_checkpoint_meta,
    restore_checkpoint,
    save_checkpoint,
)
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
from .verify import (  # noqa: F401
    CanaryConfig,
    CanaryMismatchError,
    CheckpointCorruptionError,
    InvariantViolationError,
    NotCompiledError,
    StrategyDivergenceError,
    VerificationError,
    verify_checkpoint,
    verify_strategy,
)
