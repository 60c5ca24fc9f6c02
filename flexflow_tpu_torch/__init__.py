"""flexflow_tpu_torch: the PyTorch/CUDA port of the flexflow_tpu package.

The same public surface and module layout as the JAX package, running on
an NVIDIA GPU (Hopper, sm_90a) through hand-written CUDA kernels:

    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.runtime.serving import incremental_generate

Entry points run on the first CUDA device unless the config names
``device="cpu"``; with no CUDA device and no explicit CPU request they
raise. Ported so far: serving causal decoder LMs (embedding, causal
multi-head attention, dense, softmax); training through `FFModel.fit`
(the flagship Transformer: multi-head attention and dense, the five
losses, SGD and Adam, bf16 compute and gradients over f32 weights);
BERT through the PyTorch frontend; CNNs (conv2d, pool2d, BatchNorm
with running statistics, flat: AlexNet from its `.ff` export through
data loaders, ResNet and ResNeXt-50); and the rest of the zoo (the shape
ops, reductions and top_k, batch_matmul, PReLU, the MoE ops with their
balance loss, Cache: DLRM, Inception-v3, CANDLE-Uno, MLP_Unify, XDL and
the MoE Transformer); the long-context Transformer (chunked attention
off the card), the LSTM with the NMT model, and --fusion; checkpoints
and the resilient training loop (atomic crc32-checked checkpoints,
mid-epoch resume, the NaN/Inf step guard with a dynamic loss scale,
preemption and fault injection); the strategy search (the Unity search,
the memory-aware search, MCMC over the native simulator, the
topology-aware machine model) and its toolchain (the strategy artifact
store, the differential strategy verifier and the SDC canary); the
serving fleet (prefix sharing in the page pool, the prefill memo,
ReplicaSet with failover and warm spares, BatchScheduler, request tracing
and the SLO monitor); the ONNX, Keras and keras_exp frontends.
"""
from .config import FFConfig  # noqa: F401
from .core.initializers import (  # noqa: F401
    ConstantInitializer,
    GlorotUniformInitializer,
    Initializer,
    NormInitializer,
    OneInitializer,
    UniformInitializer,
    ZeroInitializer,
)
from .core.dataloader import SingleDataLoader  # noqa: F401
from .core.model import FFModel  # noqa: F401
from .core.optimizers import AdamOptimizer, Optimizer, SGDOptimizer  # noqa: F401
from .runtime.checkpoint import restore_checkpoint, save_checkpoint  # noqa: F401
from .runtime.distributed import init_distributed  # noqa: F401
from .runtime.resilience import (  # noqa: F401
    CheckpointManager,
    FaultInjector,
    InferenceTimeout,
    NonFiniteGradientsError,
    PreemptionSignal,
    RetryPolicy,
    StepGuardConfig,
    TrainingPreempted,
    restore_latest,
    retry,
)
from .runtime.serving import BatchScheduler  # noqa: F401
from .runtime.tuner import StrategyTuner, TunerConfig  # noqa: F401
from .runtime.verify import (  # noqa: F401
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
from .ff_types import (  # noqa: F401
    ActiMode,
    AggrMode,
    CompMode,
    DataType,
    LossType,
    MetricsType,
    OperatorType,
    PoolType,
)
