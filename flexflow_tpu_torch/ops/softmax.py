"""Softmax operator (the PyTorch counterpart of flexflow_tpu/ops/softmax.py;
reference: src/ops/softmax.cc)."""
from __future__ import annotations

import dataclasses

import torch

from ..ff_types import OperatorType
from .registry import register_op


@dataclasses.dataclass(frozen=True)
class SoftmaxParams:
    """reference: include/flexflow/ops/softmax_params.h"""

    dim: int = -1


def _infer(params, in_shapes, in_dtypes):
    return [in_shapes[0]], [in_dtypes[0]]


def _forward(params: SoftmaxParams, weights, inputs, ctx):
    (x,) = inputs
    return [torch.softmax(x, dim=params.dim)]


register_op(OperatorType.OP_SOFTMAX, "Softmax", infer=_infer, forward=_forward)
