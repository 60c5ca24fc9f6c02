"""`flexflow.torch.fx`: the module name bootcamp_demo and the torch.nn
shim import (`import flexflow.torch.fx as fx; fx.torch_to_flexflow(model,
path)`). The reference never shipped it (python/flexflow/torch/ has only
model.py); here it fronts the working exporter."""
from flexflow_tpu_torch.frontends.torch.model import (  # noqa: F401
    PyTorchModel,
    torch_to_flexflow,
)
