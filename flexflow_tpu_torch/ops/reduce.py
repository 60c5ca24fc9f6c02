"""Reductions: reduce_sum/mean/max/min/prod, mean, argmax/argmin, top_k.

The PyTorch counterpart of flexflow_tpu/ops/reduce.py (reference:
src/ops/reduce.cc, mean.cc, topk.cc). The JAX package computes them with
XLA's reduce, argmax and `lax.top_k`; the port with torch's reductions
and sort. What must agree with JAX beyond the values:
- max and min spread a gradient evenly over tied maxima (torch.amax and
  amin, as JAX's reduce_max rule; torch.max(dim) would give it to one);
- argmax and argmin return the first of tied extremes, as int32;
- top_k returns the k largest sorted descending, and among equal values
  the lower index first, on the CPU and on a card. `lax.top_k` promises
  that; `torch.topk` promises no order among ties. The MoE gate is a
  RELU dense layer, so exact zeros, and ties among them, are common
  whenever fewer than k gates are positive, and a tie broken the other
  way sends a token to another expert. So top_k is a stable descending
  sort (equal values keep their index order) cut to k. Its backward
  writes each gradient to its own index: no sums, deterministic.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ff_types import DataType, OperatorType
from .registry import register_op


@dataclasses.dataclass(frozen=True)
class ReduceParams:
    """reference: include/flexflow/ops/reduce_params.h"""

    axes: Tuple[int, ...]
    keepdims: bool = False


def _prod(x, dim, keepdim):
    # torch.prod takes one axis: the highest first, so the rest keep
    # their positions
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, d, keepdim=keepdim)
    return x


_REDUCE_FNS = {
    OperatorType.OP_REDUCE_SUM: torch.sum,
    OperatorType.OP_REDUCE_MEAN: torch.mean,
    OperatorType.OP_REDUCE_MAX: torch.amax,
    OperatorType.OP_REDUCE_MIN: torch.amin,
    OperatorType.OP_REDUCE_PROD: _prod,
}


def _reduce_infer(params: ReduceParams, in_shapes, in_dtypes):
    (s,) = in_shapes
    axes = tuple(a % len(s) for a in params.axes)
    if params.keepdims:
        out = tuple(1 if i in axes else d for i, d in enumerate(s))
    else:
        out = tuple(d for i, d in enumerate(s) if i not in axes)
    return [out], [in_dtypes[0]]


def _make_reduce_forward(fn):
    def fwd(params, w, x, ctx):
        (t,) = x
        axes = tuple(a % t.dim() for a in params.axes)
        if not axes:  # an empty axis list reduces nothing (torch: all)
            return [t]
        return [fn(t, dim=axes, keepdim=params.keepdims)]

    return fwd


for _t, _fn in _REDUCE_FNS.items():
    register_op(_t, _t.name, infer=_reduce_infer,
                forward=_make_reduce_forward(_fn))

# OP_MEAN is reduce_mean over an axis list (reference: src/ops/mean.cc)
register_op(OperatorType.OP_MEAN, "Mean", infer=_reduce_infer,
            forward=_make_reduce_forward(torch.mean))


def _argminmax_infer(params: ReduceParams, in_shapes, in_dtypes):
    shapes, _ = _reduce_infer(params, in_shapes, in_dtypes)
    return shapes, [DataType.DT_INT32]


register_op(OperatorType.OP_REDUCE_ARGMAX, "ArgMax", infer=_argminmax_infer,
            forward=lambda p, w, x, ctx: [torch.argmax(
                x[0], dim=p.axes[0], keepdim=p.keepdims).int()])
register_op(OperatorType.OP_REDUCE_ARGMIN, "ArgMin", infer=_argminmax_infer,
            forward=lambda p, w, x, ctx: [torch.argmin(
                x[0], dim=p.axes[0], keepdim=p.keepdims).int()])


@dataclasses.dataclass(frozen=True)
class TopKParams:
    """reference: include/flexflow/ops/topk_params.h"""

    k: int
    sorted: bool = True


def _topk_infer(params: TopKParams, in_shapes, in_dtypes):
    (s,) = in_shapes
    out = tuple(s[:-1]) + (params.k,)
    return [out, out], [in_dtypes[0], DataType.DT_INT32]


def top_k(x: torch.Tensor, k: int):
    """(values, int64 indices) of the k largest along the last axis,
    sorted descending, ties to the lower index: `lax.top_k`'s order."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _topk_forward(params: TopKParams, w, x, ctx):
    values, indices = top_k(x[0], params.k)
    return [values, indices.int()]


register_op(OperatorType.OP_TOPK, "TopK", infer=_topk_infer,
            forward=_topk_forward)
