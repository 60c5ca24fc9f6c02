"""LSTM operator.

The PyTorch counterpart of flexflow_tpu/ops/lstm.py (reference: the
standalone NMT LSTM, nmt/lstm.cc): the input projections of the whole
sequence in one product, then an explicit loop over the steps, each one
product against the recurrent kernel and the cell update. On a card the
train scan captures the loop's launches in its CUDA graph, as the JAX
package's lax.scan is one compiled program.

The numerics are the JAX package's, not a library LSTM's: the products
take the compute-dtype operands with f32 results, the gates
(order i, f, g, o) and the cell state c stay f32, and the hidden state h
is carried, and emitted, in the input's (compute) dtype, so under mixed
precision h is bf16 and c f32. torch.nn.LSTM keeps c in the compute
dtype and adds two biases; FF's LSTM has one.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ff_types import OperatorType
from .common import cast_weight
from .registry import WeightSpec, register_op


@dataclasses.dataclass(frozen=True)
class LSTMParams:
    hidden_size: int
    return_sequences: bool = True


def _infer(params: LSTMParams, in_shapes, in_dtypes):
    (s,) = in_shapes  # (batch, seq, features)
    if params.return_sequences:
        out = (s[0], s[1], params.hidden_size)
    else:
        out = (s[0], params.hidden_size)
    return [out], [in_dtypes[0]]


def _weights(params: LSTMParams, in_shapes, in_dtypes):
    (s,) = in_shapes
    h, f = params.hidden_size, s[-1]
    dt = in_dtypes[0]
    return [
        WeightSpec("wx", (f, 4 * h), dt, "glorot_uniform",
                   ("", "out_channel")),
        WeightSpec("wh", (h, 4 * h), dt, "glorot_uniform",
                   ("", "out_channel")),
        WeightSpec("bias", (4 * h,), dt, "zero", ("out_channel",)),
    ]


def _forward(params: LSTMParams, weights, inputs, ctx):
    from ..parallel.mesh import like, local

    (x,) = inputs  # (b, s, f)
    cdt = ctx.compute_dtype
    wx, wh = (cast_weight(ctx, weights[n], cdt) for n in ("wx", "wh"))
    if cdt is not None:
        x = x.to(cdt)
    b, steps = x.shape[:2]
    # the whole sequence's input projections in one product. The products
    # take the compute-dtype values up to f32 (exactly) and sum in f32:
    # XLA's preferred_element_type=f32
    xg = torch.matmul(x.float(), wx.float()) + weights["bias"].float()
    wh32 = wh.float()
    # the zero state, a replicated DTensor on a device mesh (an op on
    # DTensors takes no plain operand)
    h = like(torch.zeros((b, params.hidden_size), dtype=x.dtype,
                         device=local(x).device), x)
    c = like(torch.zeros((b, params.hidden_size), dtype=torch.float32,
                         device=local(x).device), x)
    hs = []
    for t in range(steps):
        gates = xg[:, t] + torch.matmul(h.float(), wh32)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(x.dtype)
        hs.append(h)
    if params.return_sequences:
        return [torch.stack(hs, dim=1)]
    return [hs[-1]]


register_op(OperatorType.OP_LSTM, "LSTM", infer=_infer, weights=_weights,
            forward=_forward)
