"""Embedding operator.

The PyTorch counterpart of flexflow_tpu/ops/embedding.py (reference:
src/ops/embedding.cc): a row gather from the (num_entries, out_channels)
table, with the SUM/AVG bag aggregations over the ids axis.
"""
from __future__ import annotations

import dataclasses

import torch.nn.functional as F

from ..ff_types import AggrMode, DataType, OperatorType
from .registry import WeightSpec, register_op


@dataclasses.dataclass(frozen=True)
class EmbeddingParams:
    """reference: include/flexflow/ops/embedding_params.h"""

    num_entries: int
    out_channels: int
    aggr: AggrMode = AggrMode.AGGR_MODE_NONE
    data_type: DataType = DataType.DT_FLOAT


def _infer(params: EmbeddingParams, in_shapes, in_dtypes):
    (s,) = in_shapes
    if params.aggr == AggrMode.AGGR_MODE_NONE:
        out = tuple(s) + (params.out_channels,)
    else:
        out = tuple(s[:-1]) + (params.out_channels,)
    return [out], [params.data_type]


def _weights(params: EmbeddingParams, in_shapes, in_dtypes):
    return [
        WeightSpec("weight", (params.num_entries, params.out_channels),
                   params.data_type, "glorot_uniform",
                   parallel_dim_tags=("vocab", "out_channel"))
    ]


def _forward(params: EmbeddingParams, weights, inputs, ctx):
    (ids,) = inputs
    emb = F.embedding(ids.long(), weights["weight"])
    if params.aggr == AggrMode.AGGR_MODE_SUM:
        emb = emb.sum(dim=-2)
    elif params.aggr == AggrMode.AGGR_MODE_AVG:
        emb = emb.mean(dim=-2)
    return [emb]


register_op(OperatorType.OP_EMBEDDING, "Embedding", infer=_infer,
            weights=_weights, forward=_forward)
