"""PyTorch-FX frontend (reference: python/flexflow/torch/)."""
from .model import PyTorchModel  # noqa: F401
