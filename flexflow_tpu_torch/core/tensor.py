"""User-facing deferred Tensor and Layer IR.

The PyTorch counterpart of flexflow_tpu/core/tensor.py (reference:
tensor.h:36-94, layer.h:10-62): FFModel API calls create Layers holding
shape-only Tensors; nothing is materialized until compile(). The guid
counter starts where the JAX package's does.

After compile a Tensor reads and writes its value through the model
(the native Python API, reference flexflow_cffi.py:854): a weight's
`get_tensor` is a host copy of the whole weight, `set_tensor` writes the
weight's storage in place (FFModel._set_tensor_value), and an input's or
the label's binds the stepwise loop's batch. `inline_map`/`get_array`/
`inline_unmap` hand out a host numpy buffer and write it back.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ff_types import DataType, OperatorType

_guid = itertools.count(100)


class Tensor:
    """Shape-only tensor created during graph build (reference: tensor.h:36)."""

    def __init__(self, dims: Tuple[int, ...],
                 dtype: DataType = DataType.DT_FLOAT,
                 owner_layer: Optional["Layer"] = None, owner_idx: int = 0,
                 create_gradients: bool = True, name: str = ""):
        self.guid: int = next(_guid)
        self.dims: Tuple[int, ...] = tuple(int(d) for d in dims)
        self.data_type: DataType = dtype
        self.owner_layer = owner_layer
        self.owner_idx = owner_idx
        self.create_gradients = create_gradients
        self.name = name
        self._model = None  # set by FFModel

    @property
    def num_dims(self) -> int:
        return len(self.dims)

    def get_volume(self) -> int:
        return int(np.prod(self.dims)) if self.dims else 0

    # -- post-compile value access (reference: flexflow_cffi.py:854) --------
    def get_tensor(self, ffmodel=None) -> np.ndarray:
        model = ffmodel or self._model
        if model is None:
            raise RuntimeError("tensor not attached to a compiled model")
        return model._get_tensor_value(self)

    def set_tensor(self, ffmodel, value) -> None:
        model = ffmodel or self._model
        model._set_tensor_value(self, np.asarray(value))

    # reference: flexflow_cffi.py Tensor.attach_numpy_array (a zero-copy
    # Legion attach) / inline_map / get_array / inline_unmap. Here the
    # mapped view is a host numpy buffer that inline_unmap writes back.
    def attach_numpy_array(self, ffmodel=None, ffconfig=None,
                           array=None) -> None:
        model = ffmodel or self._model
        model._attach_array(self, array)

    def detach_numpy_array(self, ffmodel=None, ffconfig=None) -> None:
        pass  # nothing is pinned on the host

    def inline_map(self, ffmodel=None, ffconfig=None) -> None:
        model = ffmodel or self._model
        try:
            self._inline_buf = np.array(model._get_tensor_value(self))
        except KeyError:
            # not bound yet (the label before any batch): fresh zeros
            self._inline_buf = np.zeros(self.dims, self.data_type.np_dtype)

    def get_array(self, ffmodel=None, ffconfig=None,
                  data_type=None) -> np.ndarray:
        if getattr(self, "_inline_buf", None) is None:
            raise RuntimeError("call inline_map first")
        return self._inline_buf

    def inline_unmap(self, ffmodel=None, ffconfig=None) -> None:
        model = ffmodel or self._model
        model._set_tensor_value(self, self._inline_buf)
        self._inline_buf = None

    # weight aliases (reference: flexflow_cffi.py Parameter.set_weights /
    # get_weights)
    def set_weights(self, ffmodel, value) -> None:
        self.set_tensor(ffmodel, value)

    def get_weights(self, ffmodel=None) -> np.ndarray:
        return self.get_tensor(ffmodel)

    @property
    def shape(self):
        return self.dims

    def __repr__(self):
        return f"Tensor(guid={self.guid}, dims={self.dims}, {self.data_type.name})"


class Layer:
    """Deferred op record built by FFModel API calls (reference: layer.h:10)."""

    def __init__(self, op_type: OperatorType, params, inputs: List[Tensor],
                 name: str = ""):
        self.guid: int = next(_guid)
        self.op_type = op_type
        self.params = params
        self.inputs: List[Tensor] = list(inputs)
        self.outputs: List[Tensor] = []
        self.weights: List[Tensor] = []
        self.name = name or f"{op_type.name.lower()}_{self.guid}"
        # per-weight initializer overrides: weight name -> Initializer
        self.initializers: Dict[str, object] = {}

    def get_output_tensor(self, idx: int = 0) -> Tensor:
        return self.outputs[idx]

    # reference: flexflow_cffi.py Op.get_input_tensor / get_weight_tensor /
    # get_bias_tensor (weights[0] is the kernel, weights[1] the bias)
    def get_input_tensor(self, idx: int = 0) -> Tensor:
        return self.inputs[idx]

    def get_weight_tensor(self, idx: int = 0) -> Tensor:
        return self.weights[idx]

    def get_bias_tensor(self) -> Tensor:
        if len(self.weights) < 2:
            raise ValueError(f"layer {self.name} has no bias weight")
        return self.weights[1]

    def __repr__(self):
        return f"Layer({self.name}, {self.op_type.name})"
