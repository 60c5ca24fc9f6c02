"""PCG operator node.

The PyTorch counterpart of flexflow_tpu/pcg/op.py (reference:
operator.h:51-277): a pure IR node -- params + ParallelTensor
inputs/outputs/weights + MachineView -- whose execution is the
registered forward.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

from ..ff_types import PARALLEL_OP_TYPES, OperatorType
from .machine_view import MachineView
from .parallel_tensor import ParallelTensor

_op_guid = itertools.count(2000000)


class PCGOp:
    """A node in the parallel computation graph."""

    def __init__(self, op_type: OperatorType, params,
                 inputs: List[ParallelTensor], name: str = "",
                 layer_guid: int = -1):
        self.guid: int = next(_op_guid)
        self.op_type = op_type
        self.params = params
        self.name = name or f"{op_type.name.lower()}_{self.guid}"
        self.inputs: List[ParallelTensor] = list(inputs)
        self.outputs: List[ParallelTensor] = []
        self.weights: List[ParallelTensor] = []
        self.weight_names: List[str] = []
        # each weight's parallel-dim tags (its WeightSpec's)
        self.weight_tags: List[Tuple[str, ...]] = []
        self.machine_view: Optional[MachineView] = None
        self.layer_guid = layer_guid
        # initializer per weight name (resolved at executor init)
        self.initializers: Dict[str, object] = {}

    @property
    def is_parallel_op(self) -> bool:
        return self.op_type in PARALLEL_OP_TYPES

    def get_params_key(self):
        """Hashable identity for node dedup (reference: model.h:678-706
        get_or_create_node keyed on Params hash)."""
        return (self.op_type, self.params,
                tuple(t.get_shape() for t in self.inputs))

    def __repr__(self):
        return f"PCGOp({self.name})"
