"""Linear / Dense operator.

The PyTorch counterpart of flexflow_tpu/ops/linear.py (reference:
src/ops/linear.cc): one matrix product against the (in, out) kernel in the
compute dtype (f32 accumulation inside the product), then the bias and
the fused activation. The product is torch.matmul, as the JAX package
leaves it to XLA. Serving reads the compute-dtype kernel from its
weight cache (ops/common.py `WeightCache`) instead of casting per call.

On a device mesh, an input that a mesh axis shards on any dim but the
last (the batch over "data", the sequence over "seq") takes the product
on each rank's local tensors through `local_map` (`_local_product`), as
GSPMD runs JAX's dot on shards: DTensor's own matmul flattens the
leading dims, which some torch releases refuse when a dim after the
first is sharded. The kernel keeps its placements and is never gathered:
a column-sharded kernel gives an output sharded on its last dim, a
row-sharded one a `Partial` output that the executor reduces
(`ROUTES["local"]` counts the calls).
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from ..ff_types import ActiMode, DataType, OperatorType, RegularizerMode
from ..parallel.mesh import is_dtensor
from .common import apply_activation, cast_weight
from .registry import WeightSpec, register_op


@dataclasses.dataclass(frozen=True)
class LinearParams:
    """reference: include/flexflow/ops/linear_params.h"""

    out_channels: int
    use_bias: bool = True
    activation: ActiMode = ActiMode.AC_MODE_NONE
    data_type: DataType = DataType.DT_FLOAT
    # the kernel regularizer (FFModel.dense(kernel_regularizer=)): its
    # penalty joins the training loss (parallel/executor.py _reg_penalty)
    kernel_reg_lambda: float = 0.0
    kernel_reg_type: RegularizerMode = RegularizerMode.REG_MODE_NONE


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


# the dense products a mesh ran on local shards ("local"); the tests
# read it
ROUTES: collections.Counter = collections.Counter()


def _local_product(x, w):
    """`x @ w` on each rank's local tensors (`local_map`) for a DTensor
    `x` sharded on a dim but its last, or None where a placement pair has
    no local product (a `Partial` operand, a kernel sharded over an axis
    that shards x's rows). Per mesh axis: x's rows sharded and the kernel
    whole give rows sharded (the kernel's gradient a partial sum); x's
    contracted dim and the kernel's rows sharded give a `Partial` output;
    x whole and the kernel's columns sharded give the output's last dim
    sharded (x's gradient a partial sum); x whole and the kernel's rows
    sharded slice x locally; both whole stay whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(w, DTensor):
        return None
    last = x.dim() - 1
    plan = []  # (out, x in, x grad, w grad) per mesh dim
    for xp, wp in zip(x.placements, w.placements):
        w_rows = isinstance(wp, Shard) and wp.dim == 0
        w_cols = isinstance(wp, Shard) and wp.dim == 1
        if isinstance(xp, Shard) and xp.dim < last:
            if not isinstance(wp, Replicate):
                return None
            plan.append((Shard(xp.dim), xp, xp, Partial()))
        elif isinstance(xp, Shard) and w_rows:
            plan.append((Partial(), xp, xp, wp))
        elif isinstance(xp, Replicate) and w_cols:
            plan.append((Shard(last), xp, Partial(), wp))
        elif isinstance(xp, Replicate) and w_rows:
            plan.append((Partial(), Shard(last), Shard(last), wp))
        elif isinstance(xp, Replicate) and isinstance(wp, Replicate):
            plan.append((xp, xp, xp, wp))
        else:
            return None
    out, x_in, x_grad, w_grad = (list(c) for c in zip(*plan))
    ROUTES["local"] += 1
    return local_map(torch.matmul, out_placements=out,
                     in_placements=(x_in, tuple(w.placements)),
                     in_grad_placements=(x_grad, w_grad),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, w)


def _rows_sharded(x) -> bool:
    """Whether `x` is a DTensor that a mesh axis shards on a dim but its
    last."""
    if not is_dtensor(x):
        return False
    from torch.distributed.tensor import Shard

    return any(isinstance(p, Shard) and p.dim < x.dim() - 1
               for p in x.placements)


def _forward(params: LinearParams, weights, inputs, ctx):
    (x,) = inputs
    cdt = ctx.compute_dtype
    if cdt is not None:
        x = x.to(cdt)
    kernel = cast_weight(ctx, weights["kernel"], cdt)
    y = _local_product(x, kernel) if _rows_sharded(x) else None
    if y is None:
        y = torch.matmul(x, kernel)
    if params.use_bias:
        y = y + cast_weight(ctx, weights["bias"], y.dtype)
    return [apply_activation(params.activation, y)]


register_op(OperatorType.OP_LINEAR, "Dense", infer=_infer, weights=_weights,
            forward=_forward)
