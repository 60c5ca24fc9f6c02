"""ParallelTensor: the sharded-tensor IR.

The PyTorch counterpart of flexflow_tpu/pcg/parallel_tensor.py
(reference: ParallelDim / ParallelTensorShape / ParallelTensorBase,
include/flexflow/parallel_tensor.h:36-198). A parallel tensor dim
carries a partition `degree` and may be a pure replica dim
(is_replica_dim). The strategy search sets degrees; the port runs on one
device, where the lowering (parallel/strategies.py assign_mesh_axes)
demotes every degree back to 1 and a tensor is its material shape.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..ff_types import MAX_TENSOR_DIM, DataType, ParameterSyncType  # noqa: F401


@dataclasses.dataclass
class ParallelDim:
    """One dimension of a parallel tensor (reference: parallel_tensor.h:36-71).

    size: global number of elements along this dim.
    degree: #shards the dim is split into.
    parallel_idx: index into the machine-view/mesh axes (-1 = not parallelized).
    is_replica_dim: the dim exists only to index replicas (size == degree).
    axis_tag: optional mesh-axis hint ("expert"/"seq") set by substitution
        generators; assign_mesh_axes routes tagged degrees onto the named
        axis. Deliberately NOT part of key(): the tag never changes the
        numeric sharding, so cost caches and graph hashes ignore it.
    """

    size: int = 0
    degree: int = 1
    parallel_idx: int = -1
    is_replica_dim: bool = False
    axis_tag: Optional[str] = None

    UNKNOWN_DEGREE = -1
    UNKNOWN_INDEX = -2

    def is_valid(self) -> bool:
        if self.size <= 0 or self.degree < 1:
            return False
        if self.size % self.degree != 0:
            return False
        if self.is_replica_dim and self.size != self.degree:
            return False
        return True

    def copy(self) -> "ParallelDim":
        return dataclasses.replace(self)

    def key(self):
        return (self.size, self.degree, self.parallel_idx, self.is_replica_dim)


@dataclasses.dataclass
class ParallelTensorShape:
    """Shape + sharding signature (reference: parallel_tensor.h:76-111)."""

    dims: List[ParallelDim]
    data_type: DataType = DataType.DT_FLOAT

    @property
    def num_dims(self) -> int:
        return len(self.dims)

    def get_volume(self) -> int:
        v = 1
        for d in self.dims:
            v *= d.size
        return v

    def get_num_replica_dims(self) -> int:
        return sum(1 for d in self.dims if d.is_replica_dim)

    def get_num_replicas(self) -> int:
        n = 1
        for d in self.dims:
            if d.is_replica_dim:
                n *= d.degree
        return n

    def get_total_degree(self) -> int:
        n = 1
        for d in self.dims:
            n *= d.degree
        return n

    def material_shape(self) -> Tuple[int, ...]:
        """Global array shape with replica dims dropped — the shape of the
        tensor's torch.Tensor."""
        return tuple(d.size for d in self.dims if not d.is_replica_dim)

    def is_valid(self) -> bool:
        return all(d.is_valid() for d in self.dims)

    def key(self):
        return (tuple(d.key() for d in self.dims), self.data_type)

    def __hash__(self):
        return hash(self.key())

    def __eq__(self, other):
        return isinstance(other, ParallelTensorShape) and self.key() == other.key()

    def __repr__(self):
        parts = []
        for d in self.dims:
            s = f"{d.size}"
            if d.degree > 1:
                s += f"/{d.degree}"
            if d.is_replica_dim:
                s += "r"
            parts.append(s)
        return f"PTShape[{'x'.join(parts)}:{self.data_type.name}]"


_next_guid = [1000000]


def next_tensor_guid() -> int:
    _next_guid[0] += 1
    return _next_guid[0]


@dataclasses.dataclass
class ParallelTensor:
    """A tensor node in the PCG (reference: parallel_tensor.h:134-198).

    NOTE on dim order: the reference stores dims reversed (Legion order); we
    store them in row-major numpy order — dims[0] is the outermost (sample)
    dim for activations, matching the user-facing shape.
    """

    dims: List[ParallelDim]
    data_type: DataType = DataType.DT_FLOAT
    guid: int = dataclasses.field(default_factory=next_tensor_guid)
    owner_op: Optional[object] = None  # Op that produces this tensor
    owner_idx: int = 0
    create_gradients: bool = True
    sync_type: ParameterSyncType = ParameterSyncType.NONE
    initializer: Optional[object] = None
    # Precision flow (analysis/precision.py): the dtype the producing op
    # COMPUTES this tensor in (None = data_type, i.e. full precision) and
    # the dtype its producing op ACCUMULATES in (None = compute dtype;
    # matmul/attention/reduction ops default to fp32 master accumulation
    # under mixed precision). Like axis_tag these are deliberately NOT
    # part of shape_key()/key(): precision annotation never changes the
    # numeric sharding, so cost caches and graph hashes ignore it.
    compute_dtype: Optional[DataType] = None
    accum_dtype: Optional[DataType] = None

    @property
    def num_dims(self) -> int:
        return len(self.dims)

    def get_shape(self) -> ParallelTensorShape:
        return ParallelTensorShape([d.copy() for d in self.dims], self.data_type)

    def shape_key(self):
        """get_shape().key() without the defensive dim copies — the search
        builds cost-cache keys from this millions of times."""
        return (tuple(d.key() for d in self.dims), self.data_type)

    def material_shape(self) -> Tuple[int, ...]:
        return tuple(d.size for d in self.dims if not d.is_replica_dim)

    def get_volume(self) -> int:
        v = 1
        for d in self.dims:
            v *= d.size
        return v

    def get_total_num_parts(self) -> int:
        n = 1
        for d in self.dims:
            n *= d.degree
        return n

    get_total_degree = get_total_num_parts

    def check_valid(self) -> bool:
        return all(d.is_valid() for d in self.dims)

    def effective_dtype(self) -> DataType:
        """The dtype this tensor is materialized in: the precision pass's
        compute_dtype annotation when present, else the declared
        data_type. Byte accounting (cost_model, analysis/collectives)
        prices tensors at this width."""
        return self.compute_dtype if self.compute_dtype is not None \
            else self.data_type

    def effective_itemsize(self) -> int:
        return self.effective_dtype().size

    def __repr__(self):
        return f"ParallelTensor(guid={self.guid}, {self.get_shape()!r})"


def make_dims(sizes, degrees=None, replica_flags=None) -> List[ParallelDim]:
    sizes = list(sizes)
    degrees = list(degrees) if degrees is not None else [1] * len(sizes)
    replica_flags = (
        list(replica_flags) if replica_flags is not None else [False] * len(sizes)
    )
    return [
        ParallelDim(size=s, degree=dg, is_replica_dim=r)
        for s, dg, r in zip(sizes, degrees, replica_flags)
    ]
