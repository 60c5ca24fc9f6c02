"""DLRM model builder (recommendation: embeddings, MLPs, interaction).

The PyTorch counterpart of flexflow_tpu/models/dlrm.py, the same network
as reference examples/cpp/DLRM/dlrm.cc (defaults dlrm.cc:27-41: 4
embedding tables of 1M rows x 64 summed over their bags, bottom MLP
4-64-64, top MLP 64-64-2 with a sigmoid on its last layer, the "cat"
interaction).
"""
from __future__ import annotations

from typing import Sequence

from ..core.model import FFModel
from ..ff_types import ActiMode, AggrMode, DataType


def create_mlp(model: FFModel, input_t, layers: Sequence[int],
               sigmoid_layer: int):
    """reference: dlrm.cc:44-63"""
    t = input_t
    for i, dim in enumerate(layers):
        act = (ActiMode.AC_MODE_SIGMOID if i == sigmoid_layer
               else ActiMode.AC_MODE_RELU)
        t = model.dense(t, dim, act)
    return t


def create_emb(model: FFModel, input_t, vocab_size: int, feature_size: int):
    """reference: dlrm.cc:67-79 (embedding bag, sum aggregation)"""
    return model.embedding(input_t, vocab_size, feature_size,
                           AggrMode.AGGR_MODE_SUM)


def build_dlrm(model: FFModel, batch_size: int,
               embedding_sizes: Sequence[int] = (1000000,) * 4,
               embedding_bag_size: int = 1, sparse_feature_size: int = 64,
               mlp_bot: Sequence[int] = (4, 64, 64),
               mlp_top: Sequence[int] = (64, 64, 2),
               arch_interaction_op: str = "cat"):
    """reference: dlrm.cc top_level_task. Returns (the inputs: one int32
    id tensor per table, then the dense features; the output)."""
    sparse_inputs = [
        model.create_tensor((batch_size, embedding_bag_size),
                            DataType.DT_INT32, name=f"sparse_{i}")
        for i in range(len(embedding_sizes))]
    dense_input = model.create_tensor((batch_size, mlp_bot[0]),
                                      DataType.DT_FLOAT, name="dense")
    ly = [create_emb(model, s, v, sparse_feature_size)
          for s, v in zip(sparse_inputs, embedding_sizes)]
    x = create_mlp(model, dense_input, mlp_bot[1:], -1)
    if arch_interaction_op != "cat":
        raise NotImplementedError(f"interaction {arch_interaction_op}")
    z = model.concat([x] + ly, axis=-1)
    p = create_mlp(model, z, mlp_top, len(mlp_top) - 1)
    return sparse_inputs + [dense_input], p
