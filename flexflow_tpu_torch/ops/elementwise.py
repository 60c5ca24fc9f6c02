"""Element-wise unary, scalar and binary operators.

The PyTorch counterpart of flexflow_tpu/ops/elementwise.py (reference:
src/ops/element_unary.cc, element_binary.cc): one dispatch table per
family. OP_GELU is jax.nn.gelu's default, the tanh approximation, not
torch's exact erf. Binary ops broadcast as numpy does. PReLU keeps a
learnable per-channel negative slope ("alpha", 0.25 at init) over the
channel axis: axis 1 of an NCHW input, else the last.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..ff_types import DataType, OperatorType
from .registry import WeightSpec, register_op

_UNARY_FNS = {
    OperatorType.OP_EXP: torch.exp,
    OperatorType.OP_LOG: torch.log,
    OperatorType.OP_RELU: torch.relu,
    OperatorType.OP_SIGMOID: torch.sigmoid,
    OperatorType.OP_TANH: torch.tanh,
    OperatorType.OP_ELU: F.elu,
    OperatorType.OP_GELU: lambda x: F.gelu(x, approximate="tanh"),
    OperatorType.OP_RSQRT: torch.rsqrt,
    OperatorType.OP_SQRT: torch.sqrt,
    OperatorType.OP_SIN: torch.sin,
    OperatorType.OP_COS: torch.cos,
    OperatorType.OP_IDENTITY: lambda x: x,
    OperatorType.OP_CEIL: torch.ceil,
    OperatorType.OP_ROUND: torch.round,       # half to even, as jnp.round
    OperatorType.OP_LOGICAL_NOT: torch.logical_not,
    OperatorType.OP_LEAKYRELU: lambda x: F.leaky_relu(x, 0.01),
}

_SCALAR_FNS = {
    OperatorType.OP_POW: torch.pow,
    OperatorType.OP_SCALAR_MULTIPLY: lambda x, c: x * c,
    OperatorType.OP_SCALAR_ADD: lambda x, c: x + c,
    OperatorType.OP_SCALAR_SUB: lambda x, c: x - c,
    OperatorType.OP_SCALAR_TRUE_DIV: lambda x, c: x / c,
    OperatorType.OP_SCALAR_FLOOR_DIV: torch.floor_divide,
}


@dataclasses.dataclass(frozen=True)
class ElementUnaryParams:
    """reference: include/flexflow/ops/element_unary_params.h"""

    op_type: OperatorType
    inplace: bool = False
    scalar: float = 0.0


def _unary_infer(params, in_shapes, in_dtypes):
    return [in_shapes[0]], [in_dtypes[0]]


def _unary_forward(params: ElementUnaryParams, weights, inputs, ctx):
    (x,) = inputs
    t = params.op_type
    if t in _SCALAR_FNS:
        return [_SCALAR_FNS[t](x, params.scalar)]
    return [_UNARY_FNS[t](x)]


for _t in list(_UNARY_FNS) + list(_SCALAR_FNS):
    register_op(_t, f"ElementUnary_{_t.name}", infer=_unary_infer,
                forward=_unary_forward)

_BINARY_FNS = {
    OperatorType.OP_EW_ADD: torch.add,
    OperatorType.OP_EW_SUB: torch.sub,
    OperatorType.OP_EW_MUL: torch.mul,
    OperatorType.OP_EW_DIV: torch.div,
    OperatorType.OP_EW_MAX: torch.maximum,
    OperatorType.OP_EW_MIN: torch.minimum,
    OperatorType.OP_EW_EQUAL: torch.eq,
    OperatorType.OP_EW_GREATER: torch.gt,
    OperatorType.OP_EW_LESS: torch.lt,
}
_COMPARISONS = (OperatorType.OP_EW_EQUAL, OperatorType.OP_EW_GREATER,
                OperatorType.OP_EW_LESS)


@dataclasses.dataclass(frozen=True)
class ElementBinaryParams:
    """reference: include/flexflow/ops/element_binary_params.h"""

    op_type: OperatorType
    inplace_a: bool = False


def _binary_infer(params, in_shapes, in_dtypes):
    out = np.broadcast_shapes(tuple(in_shapes[0]), tuple(in_shapes[1]))
    dt = (DataType.DT_BOOLEAN if params.op_type in _COMPARISONS
          else in_dtypes[0])
    return [tuple(out)], [dt]


def _binary_forward(params: ElementBinaryParams, weights, inputs, ctx):
    a, b = inputs
    return [_BINARY_FNS[params.op_type](a, b)]


for _t in _BINARY_FNS:
    register_op(_t, f"ElementBinary_{_t.name}", infer=_binary_infer,
                forward=_binary_forward, num_inputs=2)


# -- PReLU (learnable per-channel negative slope; ONNX frontend op) ---------
@dataclasses.dataclass(frozen=True)
class PReluParams:
    pass


def _prelu_channels(shape):
    # NCHW conv layout for 4-D (ops/conv2d.py is NCHW), else the last axis
    return shape[1] if len(shape) == 4 else shape[-1]


def _prelu_weights(params, in_shapes, in_dtypes):
    (s,) = in_shapes
    return [WeightSpec("alpha", (_prelu_channels(s),), in_dtypes[0],
                       "constant:0.25")]


def _prelu_forward(params, weights, inputs, ctx):
    (x,) = inputs
    a = weights["alpha"].to(x.dtype)
    if x.dim() == 4:  # per channel over the NCHW spatial axes
        a = a.reshape(1, -1, 1, 1)
    return [torch.where(x >= 0, x, a * x)]


register_op(OperatorType.OP_PRELU, "PReLU",
            infer=lambda p, s, dt: ([s[0]], [dt[0]]),
            weights=_prelu_weights, forward=_prelu_forward)
