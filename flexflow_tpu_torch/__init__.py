"""flexflow_tpu_torch: the PyTorch/CUDA port of the flexflow_tpu package.

The same public surface and module layout as the JAX package, running on
an NVIDIA GPU (Hopper, sm_90a) through hand-written CUDA kernels:

    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.runtime.serving import incremental_generate

Entry points run on the first CUDA device unless the config names
``device="cpu"``; with no CUDA device and no explicit CPU request they
raise. This slice serves causal decoder LMs (embedding, causal
multi-head attention, dense, softmax); training comes next.
"""
from .config import FFConfig  # noqa: F401
from .core.initializers import (  # noqa: F401
    GlorotUniformInitializer,
    Initializer,
    ZeroInitializer,
)
from .core.model import FFModel  # noqa: F401
from .ff_types import (  # noqa: F401
    ActiMode,
    AggrMode,
    CompMode,
    DataType,
    LossType,
    MetricsType,
    OperatorType,
)
