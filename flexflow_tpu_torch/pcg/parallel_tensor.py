"""ParallelTensor: the sharded-tensor IR.

The PyTorch counterpart of flexflow_tpu/pcg/parallel_tensor.py
(reference: parallel_tensor.h:36-198). This slice runs on one device, so
every degree stays 1; the IR keeps the JAX package's shape so the search
and multi-device execution can land on it later.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

from ..ff_types import DataType

_next_guid = itertools.count(1000001)


@dataclasses.dataclass
class ParallelDim:
    """One dimension of a parallel tensor (reference: parallel_tensor.h:36)."""

    size: int = 0
    degree: int = 1
    parallel_idx: int = -1
    is_replica_dim: bool = False


@dataclasses.dataclass
class ParallelTensor:
    """A tensor node in the PCG (reference: parallel_tensor.h:134-198).
    dims are in row-major order: dims[0] is the outermost (sample) dim."""

    dims: List[ParallelDim]
    data_type: DataType = DataType.DT_FLOAT
    guid: int = dataclasses.field(default_factory=lambda: next(_next_guid))
    owner_op: Optional[object] = None

    def material_shape(self) -> Tuple[int, ...]:
        """Global array shape with replica dims dropped."""
        return tuple(d.size for d in self.dims if not d.is_replica_dim)

    def __repr__(self):
        return f"ParallelTensor(guid={self.guid}, {self.material_shape()})"
