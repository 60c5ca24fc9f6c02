"""Shape operators.

The PyTorch counterpart of flexflow_tpu/ops/tensor_ops.py (reference:
src/ops/flat.cc and the other shape ops), with Flat: NCHW (or any rank)
-> (N, C*H*W), the batch dim kept and the rest flattened in order. The
other shape ops (reshape, transpose, reverse, concat, split, cast,
gather, pad, slice) are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..ff_types import OperatorType
from .registry import register_op


@dataclasses.dataclass(frozen=True)
class FlatParams:
    pass


def _flat_infer(params, in_shapes, in_dtypes):
    (s,) = in_shapes
    return [(s[0], int(np.prod(s[1:])))], [in_dtypes[0]]


def _flat_forward(params, weights, inputs, ctx):
    (x,) = inputs
    return [x.reshape(x.shape[0], -1)]


register_op(OperatorType.OP_FLAT, "Flat", infer=_flat_infer,
            forward=_flat_forward)
