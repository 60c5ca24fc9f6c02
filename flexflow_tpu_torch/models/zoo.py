"""Workload-zoo models: the MoE Transformer.

The PyTorch counterpart of flexflow_tpu/models/zoo.py's
`build_moe_transformer`. Its `build_long_context_transformer` waits for
chunked attention.
"""
from __future__ import annotations

from ..core.model import FFModel
from ..ff_types import DataType


def build_moe_transformer(model: FFModel, batch_size: int,
                          seq_length: int = 4, hidden_size: int = 256,
                          num_heads: int = 4, num_layers: int = 2,
                          num_experts: int = 4, top_k: int = 2,
                          capacity_factor: float = 1.2,
                          lambda_bal: float = 0.04, num_classes: int = 10):
    """A Mixtral-style MoE encoder: MHA -> top-k gated expert FFNs.

    The MoE block works on flattened (batch * seq, hidden) tokens (the
    dispatch product is rank 2, ops/moe.py), so each block reshapes
    around `model.moe` and back; the experts project to hidden_size.
    Returns (input, output)."""
    input_t = model.create_tensor((batch_size, seq_length, hidden_size),
                                  DataType.DT_FLOAT, name="tokens")
    t = input_t
    kdim = hidden_size // num_heads
    tokens = batch_size * seq_length
    for _ in range(num_layers):
        t = model.multihead_attention(t, t, t, hidden_size, num_heads, kdim,
                                      kdim)
        t = model.reshape(t, (tokens, hidden_size))
        t = model.moe(t, num_exp=num_experts, num_select=top_k,
                      expert_hidden_size=hidden_size, alpha=capacity_factor,
                      lambda_bal=lambda_bal)
        t = model.reshape(t, (batch_size, seq_length, hidden_size))
    t = model.dense(t, num_classes)
    t = model.softmax(t)
    return input_t, t
