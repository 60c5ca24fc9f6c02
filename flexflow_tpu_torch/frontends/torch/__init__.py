"""PyTorch-FX frontend (reference: python/flexflow/torch/)."""
from .model import PyTorchModel, file_to_ff, torch_to_flexflow  # noqa: F401
