"""BatchMatmul operator.

The PyTorch counterpart of flexflow_tpu/ops/batch_matmul.py (reference:
src/ops/batch_matmul.cc, a strided cuBLAS batched GEMM): one
torch.matmul over the leading batch axes, as the JAX package leaves its
`jnp.matmul` to XLA. The product is taken in the inputs' dtype, as the
port's Dense takes it: cuBLAS accumulates 16-bit products in f32 inside
the product and rounds the output once to the input dtype, which is
JAX's `preferred_element_type=f32` followed by the cast back. One place
may differ on a card: with torch's default
`torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`
(True), cuBLAS may sum a split-K product's partial results in bf16. The
port leaves that global flag to the user. The a/b_seq_length_dim
parameters (reference: model.h:481-485) slice those axes to the
iteration's seq_length (`ctx.seq_length`).
"""
from __future__ import annotations

import dataclasses

import torch

from ..ff_types import OperatorType
from .registry import register_op


@dataclasses.dataclass(frozen=True)
class BatchMatmulParams:
    """reference: include/flexflow/ops/batch_matmul_params.h"""

    a_seq_length_dim: int = -1
    b_seq_length_dim: int = -1


def _infer(params, in_shapes, in_dtypes):
    a, b = in_shapes  # (..., m, k) x (..., k, n)
    if a[-1] != b[-2]:
        raise ValueError(f"batch_matmul mismatch {tuple(a)} x {tuple(b)}")
    return [tuple(a[:-1]) + (b[-1],)], [in_dtypes[0]]


def _slice_seq(x, dim, seq_length):
    if dim < 0 or seq_length < 0 or x.shape[dim] <= seq_length:
        return x
    return x.narrow(dim, 0, seq_length)


def _forward(params: BatchMatmulParams, weights, inputs, ctx):
    a, b = inputs
    a = _slice_seq(a, params.a_seq_length_dim, ctx.seq_length)
    b = _slice_seq(b, params.b_seq_length_dim, ctx.seq_length)
    dt = torch.promote_types(a.dtype, b.dtype)
    return [torch.matmul(a.to(dt), b.to(dt)).to(a.dtype)]


register_op(OperatorType.OP_BATCHMATMUL, "BatchMatmul", infer=_infer,
            forward=_forward, num_inputs=2)
