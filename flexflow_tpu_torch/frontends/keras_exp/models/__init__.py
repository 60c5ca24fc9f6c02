"""reference: python/flexflow/keras_exp/models/__init__.py"""
from .model import BaseModel, Model, Sequential  # noqa: F401
from .tensor import Tensor  # noqa: F401
