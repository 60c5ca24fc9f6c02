"""BatchNorm and LayerNorm operators.

The PyTorch counterpart of flexflow_tpu/ops/normalization.py (reference:
src/ops/batch_norm.cc, src/ops/layer_norm.cc). Both take their
statistics in f32 (`var` is the biased variance), normalize as (x -
mean) / sqrt(var + eps), apply `scale` and `bias` in f32 and return the
input's dtype.

BatchNorm normalizes each channel (NCHW axis 1) over (N, H, W). Its
running mean and variance are state, not weights: `state_spec` declares
them and `forward_stateful` reads and returns them (the executor keeps
them in TrainState.net_state). Training normalizes with the batch's
statistics and returns `m * running + (1 - m) * batch` with FF's
momentum m (0.9 keeps 90% of the running value); eval normalizes with
the running statistics; a caller without state gets batch statistics.
The update is written out: torch's `F.batch_norm` would update with the
UNBIASED batch variance and reads its momentum the other way round
(torch's 0.1 is FF's 0.9), where the JAX package keeps the biased
`jnp.var`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ff_types import DataType, OperatorType
from .registry import WeightSpec, register_op


@dataclasses.dataclass(frozen=True)
class BatchNormParams:
    """reference: src/ops/batch_norm.cc ctor"""

    relu: bool = True
    momentum: float = 0.9
    eps: float = 1e-5


def _bn_infer(params, in_shapes, in_dtypes):
    return [in_shapes[0]], [in_dtypes[0]]


def _bn_weights(params, in_shapes, in_dtypes):
    c = in_shapes[0][1]  # NCHW
    return [WeightSpec("scale", (c,), in_dtypes[0], "one"),
            WeightSpec("bias", (c,), in_dtypes[0], "zero")]


def _bn_state(params, in_shapes, in_dtypes):
    c = in_shapes[0][1]
    return [WeightSpec("running_mean", (c,), DataType.DT_FLOAT, "zero"),
            WeightSpec("running_var", (c,), DataType.DT_FLOAT, "one")]


def _bn_batch_stats(x):
    """Per-channel (mean, biased var) over every axis but 1, in f32."""
    from ..parallel.mesh import var_mean

    axes = tuple(i for i in range(x.dim()) if i != 1)
    var, mean = var_mean(x.float(), axes)
    return mean, var


def _bn_normalize(params: BatchNormParams, weights, x, mean, var):
    bshape = [1, -1] + [1] * (x.dim() - 2)
    y = ((x.float() - mean.reshape(bshape))
         / torch.sqrt(var.reshape(bshape) + params.eps))
    y = (y * weights["scale"].float().reshape(bshape)
         + weights["bias"].float().reshape(bshape))
    y = y.to(x.dtype)
    return torch.relu(y) if params.relu else y


def _bn_forward(params: BatchNormParams, weights, inputs, ctx):
    (x,) = inputs
    return [_bn_normalize(params, weights, x, *_bn_batch_stats(x))]


def _bn_forward_stateful(params: BatchNormParams, weights, state, inputs,
                         ctx):
    (x,) = inputs
    if not state:  # a caller without state: batch statistics
        return _bn_forward(params, weights, inputs, ctx), {}
    if ctx.training:
        mean, var = _bn_batch_stats(x)
        m = params.momentum
        new_state = {
            "running_mean": m * state["running_mean"] + (1 - m) * mean,
            "running_var": m * state["running_var"] + (1 - m) * var}
        return [_bn_normalize(params, weights, x, mean, var)], new_state
    return [_bn_normalize(params, weights, x, state["running_mean"],
                          state["running_var"])], state


register_op(OperatorType.OP_BATCHNORM, "BatchNorm", infer=_bn_infer,
            weights=_bn_weights, forward=_bn_forward, state_spec=_bn_state,
            forward_stateful=_bn_forward_stateful)


@dataclasses.dataclass(frozen=True)
class LayerNormParams:
    """reference: include/flexflow/ops/layer_norm_params.h"""

    axes: Tuple[int, ...] = (-1,)
    elementwise_affine: bool = True
    eps: float = 1e-5


def _infer(params, in_shapes, in_dtypes):
    return [in_shapes[0]], [in_dtypes[0]]


def _weights(params: LayerNormParams, in_shapes, in_dtypes):
    if not params.elementwise_affine:
        return []
    s = in_shapes[0]
    norm_shape = tuple(s[a % len(s)] for a in params.axes)
    return [WeightSpec("scale", norm_shape, in_dtypes[0], "one"),
            WeightSpec("bias", norm_shape, in_dtypes[0], "zero")]


def _forward(params: LayerNormParams, weights, inputs, ctx):
    from ..parallel.mesh import var_mean

    (x,) = inputs
    axes = tuple(a % x.dim() for a in params.axes)
    xf = x.float()
    var, mean = var_mean(xf, axes, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + params.eps)
    if params.elementwise_affine:
        bshape = [x.shape[a] if a in axes else 1 for a in range(x.dim())]
        y = y * weights["scale"].float().reshape(bshape)
        y = y + weights["bias"].float().reshape(bshape)
    return [y.to(x.dtype)]


register_op(OperatorType.OP_LAYERNORM, "LayerNorm", infer=_infer,
            weights=_weights, forward=_forward)
