"""Shape and layout operators: reshape, flat, transpose, reverse, concat,
split, cast, gather, pad, slice, noop, squeeze, unsqueeze, where, resize.

The PyTorch counterpart of flexflow_tpu/ops/tensor_ops.py (reference:
src/ops/{reshape,flat,transpose,reverse,concat,split,cast,gather,pad}.cc).
Each is data movement that the JAX package leaves to XLA and the port to
PyTorch's own calls; every backward is a slice, a sum over a broadcast or
a permutation, so it is deterministic on a card, except gather's (below).

Two of them differ from their torch namesakes:
- Resize is `jax.image.resize(..., method="nearest")`: every axis of
  the full output shape whose size changes is resampled at half-pixel
  centres, source floor((i + 0.5) * in / out). That is torch's
  `mode="nearest-exact"` (plain "nearest" samples floor(i * in / out)),
  applied one axis at a time.
- Gather is `jnp.take_along_axis`, torch.gather's semantics. JAX clamps
  an index out of range and does not fault; `torch.gather` raises on the
  CPU and device-asserts on a card, which ends the process's use of the
  card. Indices must lie in range. Its backward scatter-adds into the
  data's gradient, which on a card sums repeated indices with atomics in
  no fixed order, so it runs under torch's deterministic algorithms
  (`_Gather`), as ops/conv2d.py `exact_conv` does for cuDNN.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ff_types import DataType, OperatorType
from .registry import register_op


# -- Reshape (reference: src/ops/reshape.cc) --------------------------------
@dataclasses.dataclass(frozen=True)
class ReshapeParams:
    shape: Tuple[int, ...]


def _reshape_infer(params, in_shapes, in_dtypes):
    (s,) = in_shapes
    vol = int(np.prod(s))
    out = list(params.shape)
    if -1 in out:
        i = out.index(-1)
        rest = int(np.prod([d for d in out if d != -1]))
        out[i] = vol // rest
    if int(np.prod(out)) != vol:
        raise ValueError(f"reshape {tuple(s)} -> {params.shape}")
    return [tuple(out)], [in_dtypes[0]]


def _out_shape(infer, params, x):
    return infer(params, [tuple(x.shape)], [None])[0][0]


register_op(OperatorType.OP_RESHAPE, "Reshape", infer=_reshape_infer,
            forward=lambda p, w, x, ctx: [
                x[0].reshape(_out_shape(_reshape_infer, p, x[0]))])


# -- Flat (reference: src/ops/flat.cc -- NCHW -> (N, C*H*W)) -----------------
@dataclasses.dataclass(frozen=True)
class FlatParams:
    pass


def _flat_infer(params, in_shapes, in_dtypes):
    (s,) = in_shapes
    return [(s[0], int(np.prod(s[1:])))], [in_dtypes[0]]


register_op(OperatorType.OP_FLAT, "Flat", infer=_flat_infer,
            forward=lambda p, w, x, ctx: [x[0].reshape(x[0].shape[0], -1)])


# -- Transpose (reference: src/ops/transpose.cc) ----------------------------
@dataclasses.dataclass(frozen=True)
class TransposeParams:
    perm: Tuple[int, ...]


def _transpose_infer(params, in_shapes, in_dtypes):
    (s,) = in_shapes
    return [tuple(s[p] for p in params.perm)], [in_dtypes[0]]


register_op(OperatorType.OP_TRANSPOSE, "Transpose", infer=_transpose_infer,
            forward=lambda p, w, x, ctx: [x[0].permute(p.perm)])


# -- Reverse (reference: src/ops/reverse.cc) --------------------------------
@dataclasses.dataclass(frozen=True)
class ReverseParams:
    axis: int


register_op(OperatorType.OP_REVERSE, "Reverse",
            infer=lambda p, s, dt: ([s[0]], [dt[0]]),
            forward=lambda p, w, x, ctx: [torch.flip(x[0], (p.axis,))])


# -- Concat (reference: src/ops/concat.cc) ----------------------------------
@dataclasses.dataclass(frozen=True)
class ConcatParams:
    axis: int


def _concat_infer(params, in_shapes, in_dtypes):
    ax = params.axis % len(in_shapes[0])
    out = list(in_shapes[0])
    out[ax] = sum(s[ax] for s in in_shapes)
    return [tuple(out)], [in_dtypes[0]]


register_op(OperatorType.OP_CONCAT, "Concat", infer=_concat_infer,
            forward=lambda p, w, x, ctx: [torch.cat(list(x), dim=p.axis)],
            num_inputs=-1)


# -- Split (reference: src/ops/split.cc) ------------------------------------
@dataclasses.dataclass(frozen=True)
class SplitParams:
    sizes: Tuple[int, ...]
    axis: int


def _split_infer(params, in_shapes, in_dtypes):
    (s,) = in_shapes
    ax = params.axis % len(s)
    outs = []
    for sz in params.sizes:
        o = list(s)
        o[ax] = sz
        outs.append(tuple(o))
    return outs, [in_dtypes[0]] * len(params.sizes)


register_op(OperatorType.OP_SPLIT, "Split", infer=_split_infer,
            forward=lambda p, w, x, ctx: list(
                torch.split(x[0], list(p.sizes), dim=p.axis)))


# -- Cast (reference: src/ops/cast.cc) --------------------------------------
@dataclasses.dataclass(frozen=True)
class CastParams:
    dtype: DataType


register_op(OperatorType.OP_CAST, "Cast",
            infer=lambda p, s, dt: ([s[0]], [p.dtype]),
            forward=lambda p, w, x, ctx: [x[0].to(p.dtype.torch_dtype)])


# -- Gather (reference: src/ops/gather.cc -- torch.gather semantics) ---------
@dataclasses.dataclass(frozen=True)
class GatherParams:
    dim: int


class _Gather(torch.autograd.Function):
    """torch.gather whose backward scatter-adds under torch's
    deterministic algorithms (a sort, no atomics in changing order), and
    puts the caller's setting back after."""

    @staticmethod
    def forward(ctx, data, index, dim):
        ctx.save_for_backward(index)
        ctx.dim, ctx.shape = dim, data.shape
        return torch.gather(data, dim, index)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        was = torch.are_deterministic_algorithms_enabled()
        warn = torch.is_deterministic_algorithms_warn_only_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            g = grad.new_zeros(ctx.shape).scatter_add_(ctx.dim, index, grad)
        finally:
            torch.use_deterministic_algorithms(was, warn_only=warn)
        return g, None, None


def _gather_infer(params, in_shapes, in_dtypes):
    data, index = in_shapes
    return [tuple(index)], [in_dtypes[0]]


def _gather_forward(params, w, x, ctx):
    data, index = x
    index = index.long()
    dim = params.dim % data.dim()
    if data.requires_grad:
        return [_Gather.apply(data, index, dim)]
    return [torch.gather(data, dim, index)]


register_op(OperatorType.OP_GATHER, "Gather", infer=_gather_infer,
            forward=_gather_forward, num_inputs=2)


# -- Pad ---------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PadParams:
    pads: Tuple[Tuple[int, int], ...]
    value: float = 0.0


def _pad_infer(params, in_shapes, in_dtypes):
    (s,) = in_shapes
    out = tuple(d + lo + hi for d, (lo, hi) in zip(s, params.pads))
    return [out], [in_dtypes[0]]


def _pad_forward(params, w, x, ctx):
    # F.pad lists (lo, hi) from the last axis backwards
    flat = [v for lo_hi in reversed(params.pads) for v in lo_hi]
    return [F.pad(x[0], flat, value=params.value)]


register_op(OperatorType.OP_PAD, "Pad", infer=_pad_infer,
            forward=_pad_forward)


# -- Slice -------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SliceParams:
    starts: Tuple[int, ...]
    ends: Tuple[int, ...]


def _slice_infer(params, in_shapes, in_dtypes):
    out = tuple(e - b for b, e in zip(params.starts, params.ends))
    return [out], [in_dtypes[0]]


register_op(OperatorType.OP_SLICE, "Slice", infer=_slice_infer,
            forward=lambda p, w, x, ctx: [
                x[0][tuple(slice(b, e) for b, e in zip(p.starts, p.ends))]])


# -- NoOp (identity passthrough) ---------------------------------------------
@dataclasses.dataclass(frozen=True)
class NoOpParams:
    pass


register_op(OperatorType.OP_NOOP, "NoOp",
            infer=lambda p, s, dt: ([s[0]], [dt[0]]),
            forward=lambda p, w, x, ctx: [x[0]])


# -- Squeeze / Unsqueeze (ONNX's; negative axes allowed) ---------------------
@dataclasses.dataclass(frozen=True)
class SqueezeParams:
    axes: Tuple[int, ...] = ()


def _squeeze_infer(params, in_shapes, in_dtypes):
    (s,) = in_shapes
    axes = params.axes or tuple(i for i, d in enumerate(s) if d == 1)
    axes = tuple(a % len(s) for a in axes)
    return [tuple(d for i, d in enumerate(s) if i not in axes)], \
        [in_dtypes[0]]


register_op(OperatorType.OP_SQUEEZE, "Squeeze", infer=_squeeze_infer,
            forward=lambda p, w, x, ctx: [
                x[0].reshape(_out_shape(_squeeze_infer, p, x[0]))])


@dataclasses.dataclass(frozen=True)
class UnsqueezeParams:
    axes: Tuple[int, ...]


def _unsqueeze_infer(params, in_shapes, in_dtypes):
    (s,) = in_shapes
    # axes are positions in the output (rank in + len(axes)); negative
    # ones resolve against that rank
    out_rank = len(s) + len(params.axes)
    out = list(s)
    for a in sorted(a % out_rank for a in params.axes):
        out.insert(a, 1)
    return [tuple(out)], [in_dtypes[0]]


register_op(OperatorType.OP_UNSQUEEZE, "Unsqueeze", infer=_unsqueeze_infer,
            forward=lambda p, w, x, ctx: [
                x[0].reshape(_out_shape(_unsqueeze_infer, p, x[0]))])


# -- Where (ONNX select) -----------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WhereParams:
    pass


def _where_infer(params, in_shapes, in_dtypes):
    return [tuple(np.broadcast_shapes(*in_shapes))], [in_dtypes[1]]


register_op(OperatorType.OP_WHERE, "Where", infer=_where_infer,
            forward=lambda p, w, x, ctx: [
                torch.where(x[0].bool(), x[1], x[2])],
            num_inputs=3)


# -- Resize (nearest at half-pixel centres; ONNX Resize/Upsample) ------------
@dataclasses.dataclass(frozen=True)
class ResizeParams:
    out_shape: Tuple[int, ...]  # the full output shape


def _resize_forward(params, w, x, ctx):
    (y,) = x
    for d, n in enumerate(params.out_shape):
        if y.shape[d] == n:
            continue
        moved = y.movedim(d, -1)
        lead = moved.shape[:-1]
        z = F.interpolate(moved.reshape(1, -1, moved.shape[-1]), size=n,
                          mode="nearest-exact")
        y = z.reshape(*lead, n).movedim(-1, d)
    return [y]


register_op(OperatorType.OP_RESIZE, "Resize",
            infer=lambda p, s, dt: ([tuple(p.out_shape)], [dt[0]]),
            forward=_resize_forward)
