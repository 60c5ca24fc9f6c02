"""reference python/flexflow/torch/model.py (PyTorchModel et al.)."""
from flexflow_tpu_torch.ff_types import ActiMode  # noqa: F401
from flexflow_tpu_torch.frontends.torch.model import (  # noqa: F401
    HAS_TORCH,
    AggrMode,
    DataType,
    OperatorType,
    PoolType,
    PyTorchModel,
    file_to_ff,
    torch_to_flexflow,
)
