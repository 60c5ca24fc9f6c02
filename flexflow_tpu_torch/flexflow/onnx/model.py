"""reference python/flexflow/onnx/model.py (ONNXModel, ONNXModelKeras)."""
from flexflow_tpu_torch.frontends.onnx.model import ONNXModel, ONNXModelKeras  # noqa: F401
from flexflow_tpu_torch.frontends.onnx import proto  # noqa: F401
