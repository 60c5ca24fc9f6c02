"""Transformer encoder model builder -- the flagship benchmark model.

The PyTorch counterpart of flexflow_tpu/models/transformer.py (reference:
examples/cpp/Transformer/transformer.cc:33-45 create_attention_encoder,
defaults transformer.cc:80-84: hidden 1024, 16 heads, 12 layers, seq 512).
The JAX builder also has a pipeline-parallel branch, taken when
`config.pipeline_parallel_degree > 1`; this package's FFConfig has no
parallel degrees (multi-device execution is not ported), so the copy here
builds the per-layer graph only, which that branch is numerically
identical to.
"""
from __future__ import annotations

from ..core.model import FFModel
from ..ff_types import ActiMode, DataType


def create_attention_encoder(model: FFModel, input_t, hidden_dim: int,
                             num_heads: int, kdim: int, vdim: int):
    """One encoder block (reference: transformer.cc:33-45 -- MHA followed
    by a 2-layer MLP, no residual/layernorm in the reference's benchmark
    net)."""
    t = model.multihead_attention(input_t, input_t, input_t, hidden_dim,
                                  num_heads, kdim, vdim)
    t = model.dense(t, hidden_dim, ActiMode.AC_MODE_RELU, use_bias=False)
    t = model.dense(t, hidden_dim, ActiMode.AC_MODE_NONE, use_bias=False)
    return t


def build_transformer(model: FFModel, batch_size: int, seq_length: int = 512,
                      hidden_size: int = 1024, num_heads: int = 16,
                      num_layers: int = 12):
    """reference: transformer.cc top_level_task (defaults :80-84). The
    training objective there is MSE against a same-shaped label tensor.
    Returns (input tensor, output tensor)."""
    input_t = model.create_tensor((batch_size, seq_length, hidden_size),
                                  DataType.DT_FLOAT, name="tokens")
    t = input_t
    kdim = hidden_size // num_heads
    for _ in range(num_layers):
        t = create_attention_encoder(model, t, hidden_size, num_heads, kdim,
                                     kdim)
    return input_t, t
