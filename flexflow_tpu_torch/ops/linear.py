"""Linear / Dense operator.

The PyTorch counterpart of flexflow_tpu/ops/linear.py (reference:
src/ops/linear.cc): one matrix product against the (in, out) kernel in the
compute dtype (f32 accumulation inside the product), then the bias and
the fused activation. The product is torch.matmul, as the JAX package
leaves it to XLA. Serving reads the compute-dtype kernel from its
weight cache (ops/common.py `WeightCache`) instead of casting per call.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ff_types import ActiMode, DataType, OperatorType
from .common import apply_activation, cast_weight
from .registry import WeightSpec, register_op


@dataclasses.dataclass(frozen=True)
class LinearParams:
    """reference: include/flexflow/ops/linear_params.h"""

    out_channels: int
    use_bias: bool = True
    activation: ActiMode = ActiMode.AC_MODE_NONE
    data_type: DataType = DataType.DT_FLOAT


def _infer(params: LinearParams, in_shapes, in_dtypes):
    (s,) = in_shapes
    out = tuple(s[:-1]) + (params.out_channels,)
    return [out], [params.data_type if params.data_type else in_dtypes[0]]


def _weights(params: LinearParams, in_shapes, in_dtypes):
    (s,) = in_shapes
    ws = [WeightSpec("kernel", (s[-1], params.out_channels), params.data_type,
                     "glorot_uniform",
                     parallel_dim_tags=("in_channel", "out_channel"))]
    if params.use_bias:
        ws.append(WeightSpec("bias", (params.out_channels,), params.data_type,
                             "zero", parallel_dim_tags=("out_channel",)))
    return ws


def _forward(params: LinearParams, weights, inputs, ctx):
    (x,) = inputs
    cdt = ctx.compute_dtype
    if cdt is not None:
        x = x.to(cdt)
    y = torch.matmul(x, cast_weight(ctx, weights["kernel"], cdt))
    if params.use_bias:
        y = y + cast_weight(ctx, weights["bias"], y.dtype)
    return [apply_activation(params.activation, y)]


register_op(OperatorType.OP_LINEAR, "Dense", infer=_infer, weights=_weights,
            forward=_forward)
