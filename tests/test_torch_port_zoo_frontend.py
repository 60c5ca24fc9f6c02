"""The PyTorch frontend rows that the zoo's ops unblock, on
flexflow_tpu_torch against the JAX package's: `torch.cat`, `bmm` and
`matmul`, `permute` and `transpose`, `view` with `size`, `mean`,
`unsqueeze`, `squeeze`, the casts (`float`, `to`, `type_as`, `half`) and
the metadata they read (`size`, `dim`, `getattr`).

A small two-input nn.Module goes through both packages' `torch_to_ff`
and through each package's `torch_to_flexflow` export, replayed by the
other: the same layers (names, op types, params, shapes), and, with the
JAX weights carried into the port, the same outputs. f32 on the CPU:
outputs within rtol 1e-5 (sums in other orders); what one package
builds twice (a file against a live import) is bit for bit.
"""
import numpy as np
import pytest
import torch
from torch import nn

import flexflow_tpu as jff
import flexflow_tpu_torch as tff
from flexflow_tpu.frontends.torch import PyTorchModel as JPyTorchModel
from flexflow_tpu.frontends.torch import torch_to_flexflow as jexport
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.ff_types import LossType
from flexflow_tpu_torch.frontends.torch import PyTorchModel, torch_to_flexflow
from flexflow_tpu_torch.runtime.weights import params_from_numpy

RTOL = 1e-5
B, S, D = 2, 3, 8


class Mixer(nn.Module):
    """cat, view(size), a Linear, permute, bmm, transpose, matmul, mean,
    unsqueeze, squeeze and the casts, on two inputs."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(D, D)

    def forward(self, x, y):
        h = torch.cat([x, y], dim=-1)                 # (b, s, 2d)
        h = h.view(h.size(0), -1, D)                  # (b, 2s, d)
        a = self.fc(h).permute(0, 2, 1)               # (b, d, 2s)
        g = torch.bmm(a, h)                           # (b, d, d)
        g = torch.matmul(g.transpose(1, 2), g)        # (b, d, d)
        m = g.mean(dim=1).unsqueeze(1)                # (b, 1, d)
        m = torch.softmax(m.squeeze(1), dim=-1)       # (b, d)
        return m.float().to("cpu").type_as(m).reshape(B, D)


def _models():
    cfg = jff.FFConfig()
    cfg.batch_size = B
    cfg.workersPerNode = 1
    jm = jff.FFModel(cfg)
    tm = FFModel(FFConfig(batch_size=B, device="cpu"))
    jin = [jm.create_tensor((B, S, D), jff.DataType.DT_FLOAT)
           for _ in range(2)]
    tin = [tm.create_tensor((B, S, D)) for _ in range(2)]
    return jm, jin, tm, tin


def _layers(m):
    """Every layer's name, op type, params (a Linear's regularizer
    fields among them), output shapes and dtypes."""
    return [(layer.name, layer.op_type.name,
             {k: getattr(v, "name", v)
              for k, v in vars(layer.params).items()},
             [tuple(o.dims) for o in layer.outputs],
             [o.data_type.name for o in layer.outputs])
            for layer in m.layers]


def _compile(ff, m):
    m.compile(ff.SGDOptimizer(lr=0.01),
              ff.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)


def _forward(jm, tm, xs):
    jout = np.asarray(jm.executor.build_forward()(jm.state.params, xs))
    tout = tm.executor.build_forward()(tm.params, xs).numpy()
    return jout, tout


def test_live_import_matches_jax():
    torch.manual_seed(0)
    mod = Mixer()
    jm, jin, tm, tin = _models()
    JPyTorchModel(mod).torch_to_ff(jm, jin)
    pt = PyTorchModel(mod)
    (out,) = pt.torch_to_ff(tm, tin)
    assert out.dims == (B, D)
    assert _layers(tm) == _layers(jm)
    assert [layer.op_type.name for layer in tm.layers] == [
        "OP_CONCAT", "OP_RESHAPE", "OP_LINEAR", "OP_TRANSPOSE",
        "OP_BATCHMATMUL", "OP_TRANSPOSE", "OP_BATCHMATMUL", "OP_MEAN",
        "OP_UNSQUEEZE", "OP_SQUEEZE", "OP_SOFTMAX", "OP_CAST", "OP_CAST",
        "OP_RESHAPE"]
    _compile(jff, jm)
    _compile(tff, tm)
    pt.load_weights(tm)
    rng = np.random.RandomState(1)
    xs = [rng.randn(B, S, D).astype(np.float32) for _ in range(2)]
    ref = mod(*[torch.from_numpy(a) for a in xs]).detach().numpy()
    np.testing.assert_allclose(tm.executor.build_forward()(tm.params, xs)
                               .numpy(), ref, rtol=RTOL, atol=1e-6)
    params_from_numpy(tm, {op: {n: np.asarray(a) for n, a in ws.items()}
                           for op, ws in jm.state.params.items()})
    jout, tout = _forward(jm, tm, xs)
    np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ff_file_replays_in_both_packages(writer, tmp_path):
    """A file written by either package replays in both to the layers of
    the live import; the two writers write the same bytes."""
    paths = {"jax": str(tmp_path / "jax.ff"),
             "port": str(tmp_path / "port.ff")}
    jexport(Mixer(), paths["jax"])
    torch_to_flexflow(Mixer(), paths["port"])
    with open(paths["jax"]) as a, open(paths["port"]) as b:
        assert a.read() == b.read()
    jm, jin, tm, tin = _models()
    JPyTorchModel(paths[writer]).apply(jm, jin)
    PyTorchModel(paths[writer]).apply(tm, tin)
    assert _layers(tm) == _layers(jm)
    live = FFModel(FFConfig(batch_size=B, device="cpu"))
    PyTorchModel(Mixer()).torch_to_ff(
        live, [live.create_tensor((B, S, D)) for _ in range(2)])
    assert _layers(live) == _layers(tm)


@pytest.mark.parametrize("target", ["where", "masked_fill", "expand"])
def test_rows_that_need_constant_tensors_still_raise(target):
    """The rows that waited for constant tensors, on graph-tensor
    operands, against JAX's: where builds JAX's op, expand passes its
    input through, masked_fill over a traced mask fails with JAX's
    message (its mask must be concrete)."""
    from flexflow_tpu.frontends.torch.model import _replay_fn as jreplay
    from flexflow_tpu_torch.frontends.torch.model import _replay_fn

    cfg = jff.FFConfig()
    cfg.batch_size = B
    jm = jff.FFModel(cfg)
    jx = jm.create_tensor((B, D), jff.DataType.DT_FLOAT)
    m = FFModel(FFConfig(batch_size=B, device="cpu"))
    x = m.create_tensor((B, D))
    try:
        want = jreplay(jm, target, [jx, jx, 2.0], {})
    except AssertionError as e:
        with pytest.raises(NotImplementedError, match=str(e)):
            _replay_fn(m, target, [x, x, 2.0], {})
        assert target == "masked_fill"
        return
    got = _replay_fn(m, target, [x, x, 2.0], {})
    assert (got is x) == (want is jx)
    assert tuple(got.dims) == tuple(want.dims)
    assert _layers(m) == _layers(jm)


def test_metadata_rows():
    from flexflow_tpu_torch.frontends.torch.model import _replay_fn

    m = FFModel(FFConfig(batch_size=B, device="cpu"))
    x = m.create_tensor((B, S, D))
    assert _replay_fn(m, "size", [x], {}) == (B, S, D)
    assert _replay_fn(m, "size", [x, 1], {}) == S
    assert _replay_fn(m, "dim", [x], {}) == 3
    assert _replay_fn(m, "getattr", [x, "shape"], {}) == (B, S, D)
    assert _replay_fn(m, "getattr", [x, "dtype"], {}) == torch.float32
    assert _replay_fn(m, "to", [x, "cuda"], {}) is x
    assert _replay_fn(m, "to", [x, torch.float64], {}).data_type.name == \
        "DT_DOUBLE"
    assert _replay_fn(m, "to", [x], {"dtype": torch.int32}).data_type \
        .name == "DT_INT32"
    y = _replay_fn(m, "half", [x], {})
    assert y.data_type.name == "DT_HALF"
    assert m.layers[-1].op_type.name == "OP_CAST"
    m.compile(SGDOptimizer(lr=0.01), LossType.LOSS_IDENTITY)
