"""Parallel operators: Repartition, Combine, Replicate, Reduction,
FusedParallelOp, AllToAll.

The PyTorch counterpart of flexflow_tpu/parallel/parallel_ops.py
(reference: src/parallel_ops/{partition,combine,replicate,reduction,
fused_parallel_op}.cc) -- the parallelism vocabulary the Unity search
inserts into the PCG. The parameter records are the JAX package's, so a
searched graph and a strategy file mean the same in both packages.

The port runs a PCG on one device, where every parallel op is the
identity on the activation it passes on: a shard of the whole is the
whole. The one exception is Reduction, which sums the partial copies
when its input carries them as a material replica axis (an input with
one more dim than the op's output), as the JAX package's shard_map path
does. The weight-sharding node (parallel/weight_sharding.py) is an
identity on the activation path too.
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


def execute(op: PCGOp, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Run a parallel op on one device: its registry row (the identity),
    except that a Reduction whose input carries the partial copies as a
    material axis (one more dim than its output) sums them over
    `reduction_dim`."""
    (x,) = inputs
    if op.op_type == OperatorType.OP_REDUCTION:
        out_ndim = len(op.outputs[0].material_shape())
        if x.dim() == out_ndim + 1:
            return [x.sum(dim=op.params.reduction_dim)]
    return get_op_def(op.op_type).forward(op.params, {}, inputs, None)
