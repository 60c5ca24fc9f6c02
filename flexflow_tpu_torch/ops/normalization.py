"""LayerNorm operator.

The PyTorch counterpart of the LayerNorm half of
flexflow_tpu/ops/normalization.py (reference: src/ops/layer_norm.cc):
statistics in f32 over `axes` (`var` is the biased variance), (x - mean)
/ sqrt(var + eps), then `scale` and `bias` in f32, then the input's
dtype. BatchNorm is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ff_types import OperatorType
from .registry import WeightSpec, register_op


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
    (x,) = inputs
    axes = tuple(a % x.dim() for a in params.axes)
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=axes, keepdim=True, correction=0)
    y = (xf - mean) / torch.sqrt(var + params.eps)
    if params.elementwise_affine:
        bshape = [x.shape[a] if a in axes else 1 for a in range(x.dim())]
        y = y * weights["scale"].float().reshape(bshape)
        y = y + weights["bias"].float().reshape(bshape)
    return [y.to(x.dtype)]


register_op(OperatorType.OP_LAYERNORM, "LayerNorm", infer=_infer,
            weights=_weights, forward=_forward)
