"""ONNX frontend (reference: python/flexflow/onnx/)."""
from .model import ONNXModel, ONNXModelKeras  # noqa: F401
