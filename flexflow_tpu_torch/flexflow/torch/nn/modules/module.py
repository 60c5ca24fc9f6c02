"""torch.nn.Module subclass owning an FFConfig/FFModel pair (reference:
python/flexflow/torch/nn/modules/module.py, whose import of a missing
`flexflow.torch.fx` left it a dead prototype): symbolic_trace() goes
through the PyTorch-FX importer (PyTorchModel), so a subclass traces
itself onto its FFModel."""
import torch.nn as nn

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.model import FFModel
from flexflow_tpu_torch.frontends.torch.model import PyTorchModel


class Module(nn.Module):
    def __init__(self):
        super().__init__()
        self._ffconfig = FFConfig()
        self._ffmodel = FFModel(self._ffconfig)
        self._graph = None

    @property
    def ffconfig(self):
        return self._ffconfig

    @property
    def ffmodel(self):
        return self._ffmodel

    def symbolic_trace(self):
        """Trace this module with torch.fx and keep the importer; call
        torch_to_ff(input_tensors) to build onto the owned FFModel."""
        self._graph = PyTorchModel(self)
        return self._graph

    def torch_to_ff(self, input_tensors):
        if self._graph is None:
            self.symbolic_trace()
        return self._graph.torch_to_ff(self._ffmodel, input_tensors)
