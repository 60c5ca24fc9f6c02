"""reference python/flexflow/onnx/ (the ONNX frontend)."""
from . import model  # noqa: F401
from flexflow_tpu_torch.frontends.onnx.model import ONNXModel  # noqa: F401
