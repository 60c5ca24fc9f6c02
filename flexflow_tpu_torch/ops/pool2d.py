"""Pool2D operator.

The PyTorch counterpart of flexflow_tpu/ops/pool2d.py (reference:
src/ops/pool_2d.cc, cuDNN pooling), NCHW. The JAX package computes one
lax.reduce_window; the port calls torch.nn.functional's pooling:
- max pooling pads with -inf;
- average pooling divides each window's sum by the number of its
  elements that are not padding (JAX counts them with a second
  reduce_window over ones, as cuDNN does), which is
  `count_include_pad=False`, not torch's default;
then the fused activation. torch's pooling takes at most half a window
of padding; wider padding is written out with F.pad first.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ff_types import ActiMode, OperatorType, PoolType
from .common import apply_activation
from .registry import register_op


@dataclasses.dataclass(frozen=True)
class Pool2DParams:
    """reference: include/flexflow/ops/pool_2d_params.h"""

    kernel_h: int
    kernel_w: int
    stride_h: int
    stride_w: int
    padding_h: int = 0
    padding_w: int = 0
    pool_type: PoolType = PoolType.POOL_MAX
    activation: ActiMode = ActiMode.AC_MODE_NONE


def _infer(params: Pool2DParams, in_shapes, in_dtypes):
    (s,) = in_shapes
    oh = (s[2] + 2 * params.padding_h - params.kernel_h) // params.stride_h + 1
    ow = (s[3] + 2 * params.padding_w - params.kernel_w) // params.stride_w + 1
    return [(s[0], s[1], oh, ow)], [in_dtypes[0]]


def _forward(params: Pool2DParams, weights, inputs, ctx):
    (x,) = inputs
    k = (params.kernel_h, params.kernel_w)
    s = (params.stride_h, params.stride_w)
    p = (params.padding_h, params.padding_w)
    is_max = params.pool_type == PoolType.POOL_MAX
    if 2 * p[0] <= k[0] and 2 * p[1] <= k[1]:
        if is_max:
            y = F.max_pool2d(x, k, s, p)
        else:
            y = F.avg_pool2d(x, k, s, p, count_include_pad=False)
    else:
        pads = (p[1], p[1], p[0], p[0])
        if is_max:
            y = F.max_pool2d(F.pad(x, pads, value=float("-inf")), k, s)
        else:
            # window sums over the padded input, over the window's count
            # of real elements
            total = F.avg_pool2d(F.pad(x, pads), k, s, divisor_override=1)
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            count = F.avg_pool2d(F.pad(ones, pads), k, s, divisor_override=1)
            y = total / count
    return [apply_activation(params.activation, y)]


register_op(OperatorType.OP_POOL2D, "Pool2D", infer=_infer, forward=_forward)
