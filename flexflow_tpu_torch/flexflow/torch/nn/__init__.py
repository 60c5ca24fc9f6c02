"""reference python/flexflow/torch/nn/__init__.py"""
from .modules import Module  # noqa: F401
