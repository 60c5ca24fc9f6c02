"""Transformer block-stack operator with pipeline-parallel execution.

The PyTorch counterpart of flexflow_tpu/ops/pipeline.py. One PCG node
holds all `num_layers` encoder blocks with their weights stacked along a
leading layer dim tagged "pipeline_stage"; `apply_pipeline_parallel`
shards that dim over the "pipe" mesh axis, so stage placement is a
sharding decision (the reference's OP_PIPELINE is enum-only,
ffconst.h:158).

The block is the flagship's (reference: examples/cpp/Transformer/
transformer.cc:33-45 create_attention_encoder): MHA with an output bias,
then two bias-free dense layers with a ReLU between them, no residual or
norm. It computes attention densely, in JAX's math and casts: every
product accumulates in f32; q, k, v and the attention rows round to the
compute dtype, the scores and the softmax stay f32, and the output
projection and the dense layers come out in the activation dtype (f32),
each dense layer's input rounded to the compute dtype first; the bias is
added in the activation dtype. A product whose JAX result is f32 from
compute-dtype operands runs here on the operands upcast to f32 (their
products are exact in f32, so the values are JAX's up to the order of
the sums). No flash kernel runs inside the block, in either package.

On a mesh whose "pipe" axis has the op's `num_stages` ranks the stack
runs the GPipe schedule (parallel/pipeline.py `gpipe_mesh`); on any other
mesh each rank scans every layer on its batch shard, and on one device
the stack is a plain scan over the layers.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..ff_types import DataType, OperatorType
from .registry import WeightSpec, register_op


@dataclasses.dataclass(frozen=True)
class BlockStackParams:
    hidden: int
    num_heads: int
    num_layers: int
    num_stages: int = 1  # pipeline degree; 1 = plain sequential scan
    num_microbatches: int = 0  # 0 -> auto (= num_stages)
    data_type: DataType = DataType.DT_FLOAT

    @property
    def head_dim(self):
        return self.hidden // self.num_heads


def _infer(params: BlockStackParams, in_shapes, in_dtypes):
    (s,) = in_shapes
    return [tuple(s)], [in_dtypes[0]]


def _weights(params: BlockStackParams, in_shapes, in_dtypes):
    L, e, h, d = (params.num_layers, params.hidden, params.num_heads,
                  params.head_dim)
    dt = params.data_type
    # leading dim of every weight = layer index; tagged "pipeline_stage"
    # so apply_pipeline_parallel shards it over the pipe axis
    stk = ("pipeline_stage",)
    return [
        WeightSpec("wq", (L, e, h, d), dt, "glorot_uniform",
                   stk + ("", "head", "")),
        WeightSpec("wk", (L, e, h, d), dt, "glorot_uniform",
                   stk + ("", "head", "")),
        WeightSpec("wv", (L, e, h, d), dt, "glorot_uniform",
                   stk + ("", "head", "")),
        WeightSpec("wo", (L, h, d, e), dt, "glorot_uniform",
                   stk + ("head", "", "")),
        WeightSpec("bias_o", (L, e), dt, "zero", stk + ("",)),
        WeightSpec("w1", (L, e, e), dt, "glorot_uniform", stk + ("", "")),
        WeightSpec("w2", (L, e, e), dt, "glorot_uniform", stk + ("", "")),
    ]


def _encoder_block(w, x, *, head_dim: int, compute_dtype):
    """One flagship encoder block on per-layer weights `w` (no layer
    dim), in the JAX package's math and casts (module docstring)."""
    f32 = torch.float32
    xc = x.to(compute_dtype) if compute_dtype is not None else x
    wq, wk, wv, wo, w1, w2 = (w[k] for k in ("wq", "wk", "wv", "wo", "w1",
                                             "w2"))
    if compute_dtype is not None:
        wq, wk, wv, wo, w1, w2 = (t.to(compute_dtype)
                                  for t in (wq, wk, wv, wo, w1, w2))
    # products whose result stays in the operands' dtype: the library's
    # f32 accumulation, then one rounding, as preferred_element_type=f32
    # and astype
    q = torch.einsum("bse,ehd->bshd", xc, wq)
    k = torch.einsum("bse,ehd->bshd", xc, wk)
    v = torch.einsum("bse,ehd->bshd", xc, wv)
    scale = 1.0 / math.sqrt(head_dim)
    scores = torch.einsum("bshd,bthd->bhst", q.to(f32), k.to(f32)) * scale
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    attn = torch.einsum("bhst,bthd->bshd", probs, v)
    # products whose result is f32 from compute-dtype operands
    out = torch.einsum("bshd,hde->bse", attn.to(f32), wo.to(f32))
    out = out.to(x.dtype) + w["bias_o"].to(x.dtype)
    h1 = torch.matmul(out.to(xc.dtype).to(f32), w1.to(f32)).to(x.dtype)
    h1 = torch.relu(h1)
    return torch.matmul(h1.to(xc.dtype).to(f32), w2.to(f32)).to(x.dtype)


def _forward(params: BlockStackParams, weights, inputs, ctx):
    from ..parallel.pipeline import gpipe_mesh, scan_blocks, scan_blocks_mesh

    (x,) = inputs
    block = functools.partial(_encoder_block, head_dim=params.head_dim,
                              compute_dtype=ctx.compute_dtype)
    mesh = ctx.mesh
    pp = params.num_stages
    if mesh is None:
        return [scan_blocks(block, weights, x)]
    if pp > 1 and mesh.shape.get("pipe", 1) == pp:
        return [gpipe_mesh(block, weights, x, mesh=mesh, n_stages=pp,
                           n_micro=params.num_microbatches or pp)]
    return [scan_blocks_mesh(block, weights, x, mesh=mesh)]


register_op(
    OperatorType.OP_BLOCK_STACK,
    "TransformerBlockStack",
    infer=_infer,
    weights=_weights,
    forward=_forward,
    num_inputs=1,
)
