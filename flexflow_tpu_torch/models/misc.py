"""Smaller zoo members: MLP_Unify, XDL, CANDLE-Uno, MoE, BERT-proxy.

The PyTorch counterpart of flexflow_tpu/models/misc.py, the same networks
as the reference examples they mirror:
  MLP_Unify  -- examples/cpp/MLP_Unify/mlp.cc (two 4-layer towers merged
                by add)
  XDL        -- examples/cpp/XDL/xdl.cc (embeddings + MLP, a slim DLRM)
  CANDLE-Uno -- examples/cpp/candle_uno/candle_uno.cc (per-feature
                encoders concatenated into a deep regressor)
  MoE        -- examples/cpp/mixture_of_experts/moe.cc (gate + experts)
  BERT-proxy -- examples/python/native/bert_proxy_native.py (an encoder
                stack)
"""
from __future__ import annotations

from typing import Sequence

from ..core.model import FFModel
from ..ff_types import ActiMode, AggrMode, DataType
from .transformer import create_attention_encoder


def build_mlp_unify(model: FFModel, batch_size: int,
                    input_dims=(3072, 3072),
                    hidden_dims=(8192, 8192, 8192, 8192)):
    """reference: mlp.cc:40-55 -- two towers merged with add."""
    in1 = model.create_tensor((batch_size, input_dims[0]), DataType.DT_FLOAT)
    in2 = model.create_tensor((batch_size, input_dims[1]), DataType.DT_FLOAT)
    t1, t2 = in1, in2
    for i, h in enumerate(hidden_dims):
        act = (ActiMode.AC_MODE_RELU if i + 1 < len(hidden_dims)
               else ActiMode.AC_MODE_NONE)
        t1 = model.dense(t1, h, act, use_bias=False)
        t2 = model.dense(t2, h, act, use_bias=False)
    t = model.add(t1, t2)
    t = model.softmax(t)
    return [in1, in2], t


def build_xdl(model: FFModel, batch_size: int,
              embedding_sizes: Sequence[int] = (1000000,) * 4,
              sparse_feature_size: int = 64, dense_dim: int = 16,
              mlp_dims=(256, 128, 2)):
    """reference: xdl.cc -- embeddings concatenated + MLP."""
    sparse = [model.create_tensor((batch_size, 1), DataType.DT_INT32)
              for _ in embedding_sizes]
    dense = model.create_tensor((batch_size, dense_dim), DataType.DT_FLOAT)
    embs = [model.embedding(s, v, sparse_feature_size,
                            AggrMode.AGGR_MODE_SUM)
            for s, v in zip(sparse, embedding_sizes)]
    t = model.concat(embs + [dense], axis=-1)
    for i, d in enumerate(mlp_dims):
        act = (ActiMode.AC_MODE_RELU if i + 1 < len(mlp_dims)
               else ActiMode.AC_MODE_NONE)
        t = model.dense(t, d, act)
    t = model.softmax(t)
    return sparse + [dense], t


def build_candle_uno(model: FFModel, batch_size: int,
                     feature_shapes=(942, 5270, 2048),
                     dense_feature_layers=(1000, 1000, 1000),
                     dense_layers=(1000, 1000, 1000, 1000, 1000)):
    """reference: candle_uno.cc:51-130 -- per-input feature towers,
    concat, a deep regressor to one output."""
    inputs = [model.create_tensor((batch_size, fs), DataType.DT_FLOAT)
              for fs in feature_shapes]
    encoded = []
    for inp in inputs:
        t = inp
        for d in dense_feature_layers:
            t = model.dense(t, d, ActiMode.AC_MODE_RELU, use_bias=False)
        encoded.append(t)
    t = model.concat(encoded, axis=-1)
    for d in dense_layers:
        t = model.dense(t, d, ActiMode.AC_MODE_RELU, use_bias=False)
    out = model.dense(t, 1)
    return inputs, out


def build_moe(model: FFModel, batch_size: int, input_dim: int = 784,
              num_classes: int = 10, num_exp: int = 5, num_select: int = 2,
              hidden: int = 64, alpha: float = 2.0,
              lambda_bal: float = 0.04):
    """reference: moe.cc:20-44 -- the moe composite + a classifier."""
    input_t = model.create_tensor((batch_size, input_dim), DataType.DT_FLOAT)
    t = model.moe(input_t, num_exp, num_select, hidden, alpha, lambda_bal)
    t = model.dense(t, num_classes)
    t = model.softmax(t)
    return input_t, t


def build_bert_proxy(model: FFModel, batch_size: int, seq_length: int = 512,
                     hidden_size: int = 768, num_heads: int = 12,
                     num_layers: int = 12):
    """reference: examples/python/native/bert_proxy_native.py -- an
    encoder stack at BERT-Base's shape."""
    input_t = model.create_tensor((batch_size, seq_length, hidden_size),
                                  DataType.DT_FLOAT)
    t = input_t
    kdim = hidden_size // num_heads
    for _ in range(num_layers):
        t = create_attention_encoder(model, t, hidden_size, num_heads, kdim,
                                     kdim)
    return input_t, t
