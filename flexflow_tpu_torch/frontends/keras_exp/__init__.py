"""Experimental Keras frontend: wrap a tf.keras model (via its ONNX export)
onto FFModel (reference: python/flexflow/keras_exp/__init__.py)."""
from . import models  # noqa: F401
