"""The bootcamp flow of flexflow_tpu_torch against the JAX package's: the
PyTorch frontend's CNN rows (Conv2d, BatchNorm2d, the pools, Flatten),
the `.ff` file format in both directions, data loaders, the label
tensor and init_layers.

A small CNN nn.Module goes through both packages' `torch_to_ff` with
`load_weights` (so both start from the module's own weights) and through
each package's `torch_to_flexflow` export, replayed by the other; the
bootcamp's AlexNet module (flexflow_tpu_torch/models/alexnet.py) is
replayed from its export and trained, at 67x67 and batch 2. f32 on the
CPU: outputs and losses within rtol 1e-5 (the two packages' sums run in
other orders); what one package computes twice from the same weights and
data (a file against a live import, loaders against arrays) is bit for
bit.
"""
import os

import jax
import numpy as np
import pytest
import torch
from torch import nn

import flexflow_tpu as jff
import flexflow_tpu_torch as tff
from flexflow_tpu.core.dataloader import SingleDataLoader as JLoader
from flexflow_tpu.frontends.torch import PyTorchModel as JPyTorchModel
from flexflow_tpu.frontends.torch import torch_to_flexflow as jexport
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.core.dataloader import SingleDataLoader
from flexflow_tpu_torch.ff_types import DataType, LossType, MetricsType
from flexflow_tpu_torch.frontends.torch import (PyTorchModel, file_to_ff,
                                                torch_to_flexflow)
from flexflow_tpu_torch.models import AlexNet

RTOL = 1e-5
BATCH, HW = 4, 12
SPARSE = "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY"


class SmallCNN(nn.Module):
    """Every CNN row of the frontend, and torch.flatten as a function."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(8)
        self.pool1 = nn.MaxPool2d(2)
        self.conv2 = nn.Conv2d(8, 8, 3, stride=2, padding=1, groups=2,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(8)
        self.pool2 = nn.AvgPool2d(3, stride=1, padding=1)
        self.gap = nn.AdaptiveAvgPool2d((1, 1))
        self.same = nn.AdaptiveAvgPool2d(1)
        self.flat = nn.Flatten()
        self.fc = nn.Linear(8, 5)
        self.out = nn.Softmax(dim=-1)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.pool2(torch.relu(self.bn2(self.conv2(self.pool1(x)))))
        x = self.same(self.gap(x))
        x = torch.flatten(x, 1) + self.flat(x)
        return self.out(self.fc(x))


def _cnn():
    torch.manual_seed(0)
    m = SmallCNN()
    with torch.no_grad():  # BatchNorm2d's affine weights away from (1, 0)
        for bn in (m.bn1, m.bn2):
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.5, 0.5)
    return m


def _jax_model(batch=BATCH):
    cfg = jff.FFConfig()
    cfg.batch_size = batch
    cfg.workersPerNode = 1
    m = jff.FFModel(cfg)
    return m, m.create_tensor((batch, 3, HW, HW), jff.DataType.DT_FLOAT)


def _port_model(batch=BATCH, hw=HW):
    m = FFModel(FFConfig(batch_size=batch, device="cpu"))
    return m, m.create_tensor((batch, 3, hw, hw))


def _compile(ff, m):
    m.compile(ff.SGDOptimizer(lr=0.01), getattr(ff.LossType, SPARSE),
              [ff.MetricsType.METRICS_ACCURACY])


def _layers(m):
    """(name, op type, params as a dict, output dims) of every layer."""
    return [(layer.name, layer.op_type.name,
             {k: getattr(v, "name", v)
              for k, v in vars(layer.params).items()}
             if hasattr(layer.params, "__dataclass_fields__") else None,
             tuple(layer.outputs[0].dims)) for layer in m.layers]


def _data(seed, n=BATCH, hw=HW, classes=5):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3, hw, hw).astype(np.float32),
            rng.randint(0, classes, (n, 1)).astype(np.int32))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ff_file_replays_in_the_other_package(writer, tmp_path):
    """A file written by either package's torch_to_flexflow replays in
    both to the same layers: names, op types, params and shapes. The two
    writers write the same bytes."""
    paths = {"jax": str(tmp_path / "jax.ff"), "port": str(tmp_path / "port.ff")}
    assert jexport(_cnn(), paths["jax"]) == paths["jax"]
    assert torch_to_flexflow(_cnn(), paths["port"]) == paths["port"]
    with open(paths["jax"]) as a, open(paths["port"]) as b:
        assert a.read() == b.read()
    jm, jx = _jax_model()
    (jout,) = JPyTorchModel(paths[writer]).apply(jm, [jx])
    tm, tx = _port_model()
    (tout,) = PyTorchModel(paths[writer]).apply(tm, [tx])
    assert tuple(tout.dims) == tuple(jout.dims) == (BATCH, 5)
    # JAX's Dense has regularizer fields the port has not ported; they
    # stay at their defaults here
    jlayers = _layers(jm)
    for (_, _, tp, _), (_, _, jp, _) in zip(_layers(tm), jlayers):
        for k in set(jp or {}) - set(tp or {}):
            assert jp.pop(k) in (0.0, "REG_MODE_NONE"), k
    assert _layers(tm) == jlayers
    assert [layer.op_type.name for layer in tm.layers].count("OP_POOL2D") == 4
    _compile(jff, jm)
    _compile(tff, tm)
    assert {op: {n: tuple(w.shape) for n, w in ws.items()}
            for op, ws in tm.params.items()} == \
        {op: {n: tuple(w.shape) for n, w in ws.items()}
         for op, ws in jm.state.params.items()}
    assert set(tm.state.net_state) == set(jm.state.net_state) != set()


def test_module_level_file_to_ff(tmp_path):
    path = torch_to_flexflow(_cnn(), str(tmp_path / "cnn.ff"))
    tm, tx = _port_model()
    (out,) = file_to_ff(path, tm, [tx])
    assert tuple(out.dims) == (BATCH, 5)
    with pytest.raises(TypeError, match="file"):
        PyTorchModel(path).torch_to_ff(tm, [tx])


def test_live_import_with_load_weights_matches_jax():
    """Both packages import the module live and load its weights (conv
    kernels OIHW in both, BatchNorm2d's scale and bias; not its running
    statistics): the same params, then the same eval output and one train
    step's loss, weights and running statistics."""
    module = _cnn()
    jm, jx = _jax_model()
    jpt = JPyTorchModel(module)
    jpt.torch_to_ff(jm, [jx])
    _compile(jff, jm)
    jpt.load_weights(jm)
    tm, tx = _port_model()
    tpt = PyTorchModel(module)
    tpt.torch_to_ff(tm, [tx])
    _compile(tff, tm)
    tpt.load_weights(tm)
    assert [layer.name for layer in tm.layers] == \
        [layer.name for layer in jm.layers]
    for op, ws in tm.params.items():
        for n, w in ws.items():
            np.testing.assert_array_equal(w.numpy(),
                                          np.asarray(jm.state.params[op][n]),
                                          err_msg=f"{op}.{n}")
    np.testing.assert_array_equal(tm.params["conv1"]["kernel"].numpy(),
                                  module.conv1.weight.detach().numpy())
    np.testing.assert_array_equal(tm.params["bn1"]["scale"].numpy(),
                                  module.bn1.weight.detach().numpy())
    x, y = _data(0)
    np.testing.assert_allclose(tm.predict(x), np.asarray(jm.predict(x)),
                               rtol=RTOL, atol=1e-7)
    jst, jp = jm.executor.build_train_step()(jm.state, [x], y,
                                             jax.random.PRNGKey(0))
    tst, tp = tm.executor.build_train_step()(tm.state, [x], y)
    np.testing.assert_allclose(float(tp["loss"]), float(jp["loss"]),
                               rtol=RTOL)
    for tree in ("params", "net_state"):
        for op, ws in getattr(tst, tree).items():
            for n, w in ws.items():
                np.testing.assert_allclose(
                    w.numpy(), np.asarray(getattr(jst, tree)[op][n]),
                    rtol=1e-4, atol=1e-6, err_msg=f"{tree} {op}.{n}")


def test_adaptive_avg_pool_to_another_size_raises():
    class Bad(nn.Module):
        def __init__(self):
            super().__init__()
            self.pool = nn.AdaptiveAvgPool2d(2)

        def forward(self, x):
            return self.pool(x)

    tm, tx = _port_model()
    with pytest.raises(NotImplementedError, match="AdaptiveAvgPool2d"):
        PyTorchModel(Bad()).torch_to_ff(tm, [tx])


def test_unknown_module_in_a_file_raises(tmp_path):
    path = str(tmp_path / "bad.ff")
    with open(path, "w") as f:
        f.write('{"op": "placeholder", "name": "x"}\n'
                '{"op": "call_module", "name": "m", "module_type": "LSTM",'
                ' "config": {}, "args": [{"ref": "x"}]}\n')
    tm, tx = _port_model()
    with pytest.raises(NotImplementedError, match="LSTM"):
        PyTorchModel(path).apply(tm, [tx])


def _bootcamp_model(source, hw=67, batch=2):
    """The bootcamp's AlexNet module into the port, from its `.ff` export
    (a path) or live; compiled as the bootcamp compiles it."""
    m, x = _port_model(batch, hw)
    if isinstance(source, str):
        PyTorchModel(source).apply(m, [x])
    else:
        PyTorchModel(source).torch_to_ff(m, [x])
    m.set_sgd_optimizer(SGDOptimizer(lr=0.01))
    m.compile(loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              metrics=[MetricsType.METRICS_ACCURACY,
                       MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    return m, x


def test_bootcamp_alexnet_from_its_file_trains_like_the_live_import(
        tmp_path, capsys):
    """The bootcamp flow: export the AlexNet module, replay the file,
    compile, build loaders over the label tensor, init_layers, fit. It
    equals the module imported live and fit on the arrays, bit for bit
    (the same op names draw the same weights from the seed)."""
    path = torch_to_flexflow(AlexNet(num_classes=10),
                             os.path.join(tmp_path, "alexnet.ff"))
    a, xa = _bootcamp_model(path)
    b, _ = _bootcamp_model(AlexNet(num_classes=10))
    assert _layers(a) == _layers(b)
    assert a.layers[0].op_type.name == "OP_CONV2D"
    assert [layer.op_type.name for layer in a.layers][-7:] == [
        "OP_FLAT", "OP_LINEAR", "OP_RELU", "OP_LINEAR", "OP_RELU",
        "OP_LINEAR", "OP_SOFTMAX"]
    x, y = _data(1, n=4, hw=67, classes=10)
    label = a.get_label_tensor()
    assert label.dims == (2, 1) and label.data_type == DataType.DT_INT32
    dx = a.create_data_loader(xa, x)
    dy = a.create_data_loader(label, y)
    assert (dx.num_batches, dy.num_batches) == (2, 2)
    a.init_layers()
    a.fit(x=dx, y=dy, epochs=1)
    b.fit(x, y, epochs=1)
    lines = [ln.split("throughput")[0] for ln in
             capsys.readouterr().out.splitlines() if ln.startswith("epoch")]
    assert len(lines) == 2 and lines[0] == lines[1]
    for op, ws in a.params.items():
        for n, w in ws.items():
            assert torch.equal(w, b.params[op][n]), f"{op}.{n}"


def test_fit_and_eval_on_loaders_equal_fit_and_eval_on_arrays(capsys):
    tms = [_port_model()[0] for _ in range(2)]
    for tm in tms:
        PyTorchModel(_cnn()).torch_to_ff(tm, [tm.input_tensors[0]])
        _compile(tff, tm)
    a, b = tms
    x, y = _data(2, n=11)
    a.fit(x=a.create_data_loader(a.input_tensors[0], x),
          y=a.create_data_loader(a.get_label_tensor(), y), epochs=2)
    b.fit(x, y, epochs=2)
    out = capsys.readouterr().out
    assert out.count("dropping 3 tail samples") == 2
    for tree in ("params", "net_state"):
        for op, ws in getattr(a.state, tree).items():
            for n, w in ws.items():
                assert torch.equal(w, getattr(b.state, tree)[op][n])
    ea = a.eval(a.create_data_loader(a.input_tensors[0], x),
                a.create_data_loader(a.get_label_tensor(), y))
    eb = b.eval(x, y)
    assert ea.train_all == eb.train_all == 8
    assert ea.train_correct == eb.train_correct


class _Dims:
    def __init__(self, batch):
        self.dims = (batch, 3)


@pytest.mark.parametrize("n,batch", [(12, 4), (10, 4), (7, 4), (4, 4),
                                     (9, 2)])
def test_single_data_loader_matches_jax(n, batch):
    """num_batches drops the tail; next_batch wraps to the start when the
    next batch would run past the end; reset starts over."""
    full = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    j, t = JLoader(None, _Dims(batch), full), SingleDataLoader(
        None, _Dims(batch), full)
    assert t.num_batches == j.num_batches == n // batch
    assert t.num_samples == j.num_samples == n
    for _ in range(2 * (n // batch) + 3):
        np.testing.assert_array_equal(t.next_batch(), j.next_batch())
        assert t.next_index == j.next_index
    t.reset()
    j.reset()
    np.testing.assert_array_equal(t.next_batch(), full[:batch])
    np.testing.assert_array_equal(j.next_batch(), full[:batch])


@pytest.mark.parametrize("loss", [SPARSE, "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE"])
def test_label_tensor_matches_jax(loss):
    jm, jx = _jax_model()
    tm, tx = _port_model()
    for m, x in ((jm, jx), (tm, tx)):
        m.dense(m.flat(x), 6)
    with pytest.raises(RuntimeError, match="compile"):
        tm.get_label_tensor()
    jm.compile(jff.SGDOptimizer(), getattr(jff.LossType, loss))
    tm.compile(SGDOptimizer(), getattr(LossType, loss))
    jl, tl = jm.get_label_tensor(), tm.get_label_tensor()
    assert tl.dims == jl.dims
    assert tl.data_type.name == jl.data_type.name
    assert tl is tm.label_tensor


def test_init_layers_draws_the_compiled_state_again():
    """init_layers re-initializes weights (from the seed, as compile did),
    the optimizer state and the running statistics."""
    tm, tx = _port_model()
    PyTorchModel(_cnn()).torch_to_ff(tm, [tx])
    _compile(tff, tm)
    first = {op: {n: w.clone() for n, w in ws.items()}
             for op, ws in tm.params.items()}
    x, y = _data(3)
    tm.fit(x, y)
    assert not torch.equal(tm.params["conv1"]["kernel"],
                           first["conv1"]["kernel"])
    assert tm.state.net_state["bn1"]["running_mean"].abs().max() > 0
    tm.init_layers()
    assert tm.state.step == 0
    for op, ws in tm.params.items():
        for n, w in ws.items():
            assert torch.equal(w, first[op][n])
    for bufs in tm.state.net_state.values():
        assert torch.equal(bufs["running_mean"],
                           torch.zeros_like(bufs["running_mean"]))
        assert torch.equal(bufs["running_var"],
                           torch.ones_like(bufs["running_var"]))
