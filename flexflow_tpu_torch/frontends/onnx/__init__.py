"""ONNX frontend (reference: python/flexflow/onnx/)."""
from .model import HAS_ONNX, ONNXModel, ONNXModelKeras  # noqa: F401
