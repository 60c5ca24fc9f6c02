"""Runtime services: checkpointing, the fault-tolerance layer
(resilience: preemption-safe checkpointing, step guards, retry/backoff,
fault injection) and checkpoint integrity, as the JAX package's
runtime/__init__.py exports them."""
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
    CheckpointCorruptionError,
    NotCompiledError,
    VerificationError,
    verify_checkpoint,
)
