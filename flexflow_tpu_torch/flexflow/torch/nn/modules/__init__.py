"""reference python/flexflow/torch/nn/modules/__init__.py"""
from .module import Module  # noqa: F401
