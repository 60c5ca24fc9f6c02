"""reference python/flexflow/torch/ (the PyTorch-FX frontend)."""
from . import model  # noqa: F401
from flexflow_tpu_torch.frontends.torch.model import PyTorchModel  # noqa: F401
