"""A BERT encoder stack as a plain torch.nn.Module, for the PyTorch
frontend.

BERT-base's published widths (google-research/bert,
uncased_L-12_H-768_A-12/bert_config.json: hidden 768, 12 layers, 12 heads,
intermediate 3072, gelu, attention and hidden dropout 0.1) are the
defaults. Each layer is post-LN: self-attention (nn.MultiheadAttention
with its attention dropout), nn.Dropout on its output, residual add,
LayerNorm; then Linear, GELU, Linear, nn.Dropout, residual add,
LayerNorm. The embeddings and pooler are left out: the stack maps
(batch, seq, hidden) to the same shape, as the JAX package's
`build_bert_proxy` (flexflow_tpu/models/misc.py) does. It enters an
FFModel through the PyTorch frontend:
`PyTorchModel(BertEncoder()).torch_to_ff(model, [x])` with x a (batch,
seq, hidden) f32 tensor of the model.
"""
from __future__ import annotations

from torch import nn


class BertLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int,
                 attention_dropout: float, hidden_dropout: float):
        super().__init__()
        self.attn = nn.MultiheadAttention(hidden, heads,
                                          dropout=attention_dropout,
                                          batch_first=True)
        self.attn_drop = nn.Dropout(hidden_dropout)
        self.attn_norm = nn.LayerNorm(hidden)
        self.fc1 = nn.Linear(hidden, intermediate)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(intermediate, hidden)
        self.ffn_drop = nn.Dropout(hidden_dropout)
        self.ffn_norm = nn.LayerNorm(hidden)

    def forward(self, x):
        a, _ = self.attn(x, x, x)
        x = self.attn_norm(x + self.attn_drop(a))
        h = self.fc2(self.act(self.fc1(x)))
        return self.ffn_norm(x + self.ffn_drop(h))


class BertEncoder(nn.Module):
    """`layers` BertLayers, BERT-base's widths by default."""

    def __init__(self, layers: int = 12, hidden: int = 768, heads: int = 12,
                 intermediate: int = 3072, attention_dropout: float = 0.1,
                 hidden_dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            BertLayer(hidden, heads, intermediate, attention_dropout,
                      hidden_dropout) for _ in range(layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

