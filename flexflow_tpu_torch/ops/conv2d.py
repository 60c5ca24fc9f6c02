"""Conv2D operator.

The PyTorch counterpart of flexflow_tpu/ops/conv2d.py (reference:
src/ops/conv_2d.cc, cuDNN): one convolution in NCHW against the OIHW
kernel (out, in / groups, kh, kw), then the bias and the fused
activation. The JAX package leaves the convolution to XLA
(lax.conv_general_dilated); the port leaves it to cuDNN through
torch.nn.functional, as it leaves matrix products to torch.matmul.

Precision. Under a compute dtype the input and the kernel are cast to it
and the output stays in it. In f32 the convolution is full f32, as JAX's
(`preferred_element_type=f32`) and as the port's f32 matrix products: on a
card cuDNN would run f32 convolutions in TF32 by default
(`torch.backends.cudnn.allow_tf32`), so the forward and both backward
convolutions run under `exact_conv`, which turns TF32 off and asks cuDNN
for deterministic algorithms (no atomics in the backward-filter sums, so
two runs of a step give the same bits), and puts both flags back after
the call. The user's own flags are untouched outside it. Serving reads
the compute-dtype kernel from its weight cache (ops/common.py
`WeightCache`).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

from ..ff_types import ActiMode, DataType, OperatorType
from .common import apply_activation, cast_weight
from .registry import WeightSpec, register_op


@dataclasses.dataclass(frozen=True)
class Conv2DParams:
    """reference: include/flexflow/ops/conv_2d_params.h"""

    out_channels: int
    kernel_h: int
    kernel_w: int
    stride_h: int = 1
    stride_w: int = 1
    padding_h: int = 0
    padding_w: int = 0
    groups: int = 1
    use_bias: bool = True
    activation: ActiMode = ActiMode.AC_MODE_NONE
    data_type: DataType = DataType.DT_FLOAT


def _out_hw(params, h, w):
    oh = (h + 2 * params.padding_h - params.kernel_h) // params.stride_h + 1
    ow = (w + 2 * params.padding_w - params.kernel_w) // params.stride_w + 1
    return oh, ow


def _infer(params: Conv2DParams, in_shapes, in_dtypes):
    (s,) = in_shapes  # (N, C, H, W)
    if len(s) != 4:
        raise ValueError(f"conv2d expects NCHW, got {s}")
    oh, ow = _out_hw(params, s[2], s[3])
    return [(s[0], params.out_channels, oh, ow)], [in_dtypes[0]]


def _weights(params: Conv2DParams, in_shapes, in_dtypes):
    (s,) = in_shapes
    ws = [WeightSpec("kernel", (params.out_channels, s[1] // params.groups,
                                params.kernel_h, params.kernel_w),
                     in_dtypes[0], "glorot_uniform",
                     parallel_dim_tags=("out_channel", "in_channel", "", ""))]
    if params.use_bias:
        ws.append(WeightSpec("bias", (params.out_channels,), in_dtypes[0],
                             "zero", parallel_dim_tags=("out_channel",)))
    return ws


@contextlib.contextmanager
def exact_conv():
    """cuDNN without TF32 and with deterministic algorithms for the calls
    inside; the flags the caller had come back after."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, cudnn.deterministic)
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = saved


class _Conv2d(torch.autograd.Function):
    """F.conv2d with its backward convolutions under `exact_conv` too:
    autograd runs a backward after the forward's context has closed."""

    @staticmethod
    def forward(ctx, x, kernel, stride, padding, groups):
        ctx.save_for_backward(x, kernel)
        ctx.conf = (stride, padding, groups)
        with exact_conv():
            return F.conv2d(x, kernel, None, stride, padding, 1, groups)

    @staticmethod
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        stride, padding, groups = ctx.conf
        with exact_conv():
            dx, dk, _ = torch.ops.aten.convolution_backward(
                dy, x, kernel, None, stride, padding, (1, 1), False, (0, 0),
                groups, (ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                         False))
        return dx, dk, None, None, None


def conv2d(x, kernel, stride=(1, 1), padding=(0, 0), groups=1):
    """The op's convolution: NCHW input, OIHW kernel, no bias."""
    return _Conv2d.apply(x, kernel, tuple(stride), tuple(padding), groups)


def _forward(params: Conv2DParams, weights, inputs, ctx):
    from ..parallel.mesh import per_shard

    (x,) = inputs
    cdt = ctx.compute_dtype
    if cdt is not None:
        x = x.to(cdt)
    # on a mesh, on each rank's batch shard with C, H and W whole and the
    # kernel whole: torch 2.11's DTensor refuses a strided, padded
    # convolution
    y = per_shard(
        lambda t, k: conv2d(t, k, (params.stride_h, params.stride_w),
                            (params.padding_h, params.padding_w),
                            params.groups),
        x, (1, 2, 3), "conv2d",
        shared=(cast_weight(ctx, weights["kernel"], x.dtype),))
    if params.use_bias:
        y = y + cast_weight(ctx, weights["bias"], y.dtype)[None, :, None,
                                                           None]
    return [apply_activation(params.activation, y)]


register_op(OperatorType.OP_CONV2D, "Conv2D", infer=_infer, weights=_weights,
            forward=_forward)
