"""Parallel operators: Repartition, Combine, Replicate, Reduction,
FusedParallelOp, AllToAll.

The PyTorch counterpart of flexflow_tpu/parallel/parallel_ops.py
(reference: src/parallel_ops/{partition,combine,replicate,reduction,
fused_parallel_op}.cc) -- the parallelism vocabulary the Unity search
inserts into the PCG. The parameter records are the JAX package's, so a
searched graph and a strategy file mean the same in both packages.

On a device mesh (parallel/mesh.py, the mesh executor) each op is a
resharding of a DTensor: its input is redistributed to the placements of
the op's output ParallelTensor, and DTensor inserts the matching
collective (the JAX package's `with_sharding_constraint`, whose
collectives XLA inserts): Repartition splits a dim (a local slice),
Combine gathers it (all-gather), Replicate broadcasts, AllToAll moves
the split from one dim to another, and Reduction turns a `Partial` input
(a row-parallel contraction's partial sums) into its output placement
(an all-reduce or reduce-scatter). A Reduction whose input carries the
partial copies as a material replica axis (an input with one more dim
than the op's output, the JAX package's shard_map path) sums that axis
first. Without a mesh (one device, no process group) every op is the
identity on the activation it passes on, but for that sum. The
weight-sharding node (parallel/weight_sharding.py) reshards the
activation path only.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from ..ff_types import OperatorType
from ..ops.registry import get_op_def, register_op
from ..pcg.op import PCGOp


@dataclasses.dataclass(frozen=True)
class RepartitionParams:
    """reference: include/flexflow/parallel_ops/partition_params.h"""

    repartition_dim: int
    repartition_degree: int


@dataclasses.dataclass(frozen=True)
class CombineParams:
    """reference: include/flexflow/parallel_ops/combine_params.h"""

    combine_dim: int
    combine_degree: int


@dataclasses.dataclass(frozen=True)
class ReplicateParams:
    """reference: include/flexflow/parallel_ops/replicate_params.h"""

    replicate_dim: int
    replicate_degree: int


@dataclasses.dataclass(frozen=True)
class ReductionParams:
    """reference: include/flexflow/parallel_ops/reduction_params.h"""

    reduction_dim: int
    reduction_degree: int


@dataclasses.dataclass(frozen=True)
class AllToAllParams:
    """Ulysses-style sequence parallelism exchange (the JAX package's
    addition; no reference equivalent)."""

    scatter_dim: int
    gather_dim: int
    degree: int


@dataclasses.dataclass(frozen=True)
class FusedParallelOpParams:
    """reference: parallel_ops/fused_parallel_op.h ParallelOpInfo list"""

    stages: Tuple[object, ...]  # sequence of the above param records


def _same_shape(params, in_shapes, in_dtypes):
    return [tuple(in_shapes[0])], [in_dtypes[0]]


def _identity(params, weights, inputs, ctx):
    return [inputs[0]]


for _t, _name in (
        (OperatorType.OP_REPARTITION, "repartition"),
        (OperatorType.OP_COMBINE, "combine"),
        (OperatorType.OP_REPLICATE, "replicate"),
        (OperatorType.OP_REDUCTION, "reduction"),
        (OperatorType.OP_ALL_TO_ALL, "all_to_all"),
        (OperatorType.OP_FUSED_PARALLEL, "fused_parallel"),
        (OperatorType.OP_WEIGHT_SHARD, "weight_shard")):
    register_op(_t, _name, infer=_same_shape, forward=_identity)


def execute(op: PCGOp, inputs: List[torch.Tensor],
            mesh=None) -> List[torch.Tensor]:
    """Run a parallel op: on a `mesh`, a redistribute of its input
    DTensor to the placements of its output; without one, its registry
    row (the identity). Either way a Reduction whose input carries the
    partial copies as a material axis (one more dim than its output) sums
    them over `reduction_dim` first."""
    (x,) = inputs
    if op.op_type == OperatorType.OP_REDUCTION:
        out_ndim = len(op.outputs[0].material_shape())
        if x.dim() == out_ndim + 1:
            x = x.sum(dim=op.params.reduction_dim)
            if mesh is None:
                return [x]
    if mesh is None:
        return get_op_def(op.op_type).forward(op.params, {}, [x], None)
    return [x.redistribute(mesh.device_mesh, mesh.placements(op.outputs[0]))]
