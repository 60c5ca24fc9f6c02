"""User-facing deferred Tensor and Layer IR.

The PyTorch counterpart of flexflow_tpu/core/tensor.py (reference:
tensor.h:36-94, layer.h:10-62): FFModel API calls create Layers holding
shape-only Tensors; nothing is materialized until compile(). The guid
counter starts where the JAX package's does.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

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

    def __repr__(self):
        return f"Layer({self.name}, {self.op_type.name})"
