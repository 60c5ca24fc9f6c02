"""The PyTorch frontend's `getitem` rows on flexflow_tpu_torch against the
JAX package's: identity slices (full slices, an Ellipsis, a negative
start that covers the dim) pass the tensor through, newaxis-only indexing
becomes `unsqueeze`, index 0 of an LSTM's or a MultiheadAttention's
tuple is the op's output, and any other indexing of a single-output op
raises. A module using them goes through both packages' `torch_to_ff`:
the same layers (names, op types, params, shapes) and, with the JAX
weights carried into the port, the same outputs within rtol 1e-5, atol
1e-6 (f32 on the CPU, sums in other orders).
"""
import numpy as np
import pytest
import torch
from torch import nn

import flexflow_tpu as jff
from flexflow_tpu.frontends.torch import PyTorchModel as JPyTorchModel
from flexflow_tpu.frontends.torch.model import _replay_fn as jreplay
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.ff_types import LossType
from flexflow_tpu_torch.frontends.torch import PyTorchModel
from flexflow_tpu_torch.frontends.torch.model import _replay_fn as treplay
from flexflow_tpu_torch.runtime.weights import params_from_numpy

RTOL, ATOL = 1e-5, 1e-6
B, S, D = 2, 3, 8


class Slicer(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(D, D)

    def forward(self, x):
        h = self.fc(x[:, :, :])         # identity
        h = h[..., :]                   # identity through an Ellipsis
        h = h[:, -S:]                   # a negative start covering the dim
        h = h[:, None, :, None]         # newaxis only: unsqueeze (1, 3)
        return torch.softmax(h, dim=2)


def _models():
    cfg = jff.FFConfig()
    cfg.batch_size = B
    cfg.workersPerNode = 1
    jm = jff.FFModel(cfg)
    tm = FFModel(FFConfig(batch_size=B, device="cpu"))
    return (jm, [jm.create_tensor((B, S, D), jff.DataType.DT_FLOAT)], tm,
            [tm.create_tensor((B, S, D))])


def _layers(m):
    return [(layer.name, layer.op_type.name,
             {k: getattr(v, "name", v) for k, v in vars(layer.params).items()
              if not k.startswith("kernel_reg")},
             [tuple(o.dims) for o in layer.outputs]) for layer in m.layers]


def test_slicing_rows_match_jax():
    torch.manual_seed(0)
    mod = Slicer()
    jm, jin, tm, tin = _models()
    JPyTorchModel(mod).torch_to_ff(jm, jin)
    (out,) = PyTorchModel(mod).torch_to_ff(tm, tin)
    assert out.dims == (B, 1, S, 1, D)
    assert _layers(tm) == _layers(jm)
    assert [layer.op_type.name for layer in tm.layers] == \
        ["OP_LINEAR", "OP_UNSQUEEZE", "OP_SOFTMAX"]
    jm.compile(jff.SGDOptimizer(lr=0.01), jff.LossType.LOSS_IDENTITY)
    tm.compile(SGDOptimizer(lr=0.01), LossType.LOSS_IDENTITY)
    params_from_numpy(tm, {op: {n: np.asarray(a) for n, a in ws.items()}
                           for op, ws in jm.state.params.items()})
    x = np.random.RandomState(0).randn(B, S, D).astype(np.float32)
    jout = np.asarray(jm.executor.build_forward()(jm.state.params, [x]))
    tout = tm.executor.build_forward()(tm.params, [x]).numpy()
    np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=ATOL)


def _both(build):
    """A fresh model of each package with one (B, S, D) input, `build`
    run on it; returns [(replay function, model, output)]."""
    jm, jin, tm, tin = _models()
    return [(jreplay, jm, build(jm, jin[0])), (treplay, tm, build(tm, tin[0]))]


@pytest.mark.parametrize("op", ["lstm", "mha"])
def test_index_0_of_a_tuple_returning_op_is_its_output(op):
    def build(m, x):
        if op == "lstm":
            return m.lstm(x, 4)
        return m.multihead_attention(x, x, x, D, 2)

    for replay, m, t in _both(build):
        assert replay(m, "getitem", [t, 0], {}) is t
        with pytest.raises(NotImplementedError, match=r"getitem\[1\]"):
            replay(m, "getitem", [t, 1], {})


@pytest.mark.parametrize("idx", [
    (slice(0, 1),), (slice(None), slice(1, None)), (slice(None, None, 2),),
    (0,), (None, Ellipsis), (Ellipsis, Ellipsis)], ids=repr)
def test_other_indexing_raises_in_both(idx):
    for replay, m, t in _both(lambda m, x: m.relu(x)):
        with pytest.raises(NotImplementedError, match="getitem"):
            replay(m, "getitem", [t, idx if len(idx) > 1 else idx[0]], {})
