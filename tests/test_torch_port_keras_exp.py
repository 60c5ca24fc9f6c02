"""flexflow_tpu_torch's keras_exp frontend against the JAX package's, on
the CPU.

  - keras2onnx_min: the same functional model, built with each package's
    own keras layers, converts to the same ONNX graph bytes from the same
    seed (only the model's producer name differs: each codec writes its
    own package's), and the port's codec parses the JAX bytes back to
    them;
  - training through keras_exp `Model`: a keras2onnx-style MLP (from a
    pre-exported ModelProto) and the CIFAR-10 CNN with concat (two conv
    towers over one input, channel-axis Concatenate, a shared conv trunk
    and a dense head, as examples/python/keras_exp/
    func_cifar10_cnn_concat.py builds it, at 16x16) through the live
    converter: each epoch's loss equal to JAX's within rtol 1e-4 (f32 on
    the CPU; the packages sum the same products in other orders), and the
    trained weights within atol 1e-4;
  - the tf.keras optimizer duck typing, and the tensorflow gate (with
    tensorflow hidden both raise ImportError).
"""
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.frontends.keras import layers as JL
from flexflow_tpu.frontends.keras_exp import keras2onnx_min as jconv
from flexflow_tpu.frontends.keras_exp.models import Model as JModel
from flexflow_tpu.frontends.keras_exp.models import Sequential as JSeq
from flexflow_tpu.frontends.keras_exp.models import model as jmodel
from flexflow_tpu.frontends.onnx import proto as JP
from flexflow_tpu_torch import FFConfig
from flexflow_tpu_torch.frontends.keras import layers as TL
from flexflow_tpu_torch.frontends.keras_exp import keras2onnx_min as tconv
from flexflow_tpu_torch.frontends.keras_exp.models import Model as TModel
from flexflow_tpu_torch.frontends.keras_exp.models import Sequential as TSeq
from flexflow_tpu_torch.frontends.keras_exp.models import model as tmodel
from flexflow_tpu_torch.frontends.onnx import proto as TP

LOSS_RTOL = 1e-4
WEIGHT_ATOL = 1e-4
SPARSE = "sparse_categorical_crossentropy"


def _jcfg(batch):
    cfg = JConfig()
    cfg.batch_size = batch
    return cfg


def _tcfg(batch):
    return FFConfig(batch_size=batch, device="cpu")


def cifar_concat(L, hw=16, width=8, hidden=32, classes=10):
    """func_cifar10_cnn_concat.py's topology in keras layers: two towers
    of two valid 3x3 convs over one input, concat on channels, pool, two
    convs at twice the width, pool, flatten, dense, dense, softmax."""
    src = L.Input((3, hw, hw))
    towers = []
    for _ in range(2):
        t = L.Conv2D(width, 3, activation="relu")(src)
        towers.append(L.Conv2D(width, 3, activation="relu")(t))
    t = L.Concatenate(axis=1)(towers)
    t = L.MaxPooling2D(2)(t)
    t = L.Conv2D(2 * width, 3, activation="relu")(t)
    t = L.Conv2D(2 * width, 3, activation="relu")(t)
    t = L.MaxPooling2D(2)(t)
    t = L.Flatten()(t)
    t = L.Dense(hidden, activation="relu")(t)
    t = L.Dense(classes)(t)
    return {1: src}, L.Activation("softmax")(t)


def two_input(L):
    """tests/test_keras_exp.py's live model: a conv branch and a dense
    branch over two inputs, concatenated."""
    x_img = L.Input((3, 16, 16))
    t = L.Conv2D(8, 3, padding="same", activation="relu")(x_img)
    t = L.MaxPooling2D(2)(t)
    t = L.Flatten()(t)
    x_vec = L.Input((12,))
    v = L.Dense(8)(x_vec)
    v = L.Activation("relu")(v)
    merged = L.Concatenate(axis=1)([t, v])
    out = L.Dense(10, activation="softmax")(merged)
    return {1: x_img, 2: x_vec}, out


def _live(inputs, out):
    return SimpleNamespace(inputs=list(inputs.values()), outputs=[out],
                           input_keys=list(inputs))


@pytest.mark.parametrize("builder", [cifar_concat, two_input])
@pytest.mark.parametrize("seed", [0, 3])
def test_keras2onnx_min_writes_jax_bytes(builder, seed):
    jm = jconv.keras_to_onnx(_live(*builder(JL)), "m", seed=seed)
    tm = tconv.keras_to_onnx(_live(*builder(TL)), "m", seed=seed)
    assert tm.graph.dumps() == jm.graph.dumps()
    assert (tm.ir_version, [o.version for o in tm.opset_import]) == \
        (jm.ir_version, [o.version for o in jm.opset_import])
    assert TP.load_model(jm.dumps()).graph.dumps() == jm.graph.dumps()
    assert [n.op_type for n in tm.graph.node].count("Concat") == 1


def _mlp_bytes(dims=(784, 64, 10), seed=0):
    """tests/test_keras_exp.py's keras2onnx-style MLP (MatMul with (in,
    out) kernels, Relu, Softmax), written by the JAX codec."""
    rng = np.random.RandomState(seed)
    nodes, inits = [], []
    prev = "input_1"
    for i in range(len(dims) - 1):
        w = (rng.randn(dims[i], dims[i + 1]) / np.sqrt(dims[i])).astype(
            np.float32)
        inits.append(JP.from_array(w, f"dense_{i}/kernel"))
        nodes.append(JP.make_node("MatMul", [prev, f"dense_{i}/kernel"],
                                  [f"mm{i}"], name=f"MatMul_{i}"))
        prev = f"mm{i}"
        if i < len(dims) - 2:
            nodes.append(JP.make_node("Relu", [prev], [f"relu{i}"],
                                      name=f"Relu_{i}"))
            prev = f"relu{i}"
    nodes.append(JP.make_node("Softmax", [prev], ["out"], name="Softmax_0",
                              axis=-1))
    graph = JP.make_graph(
        nodes, "keras_model",
        [JP.make_tensor_value_info("input_1", JP.TensorProto.FLOAT,
                                   ["N", dims[0]])],
        [JP.make_tensor_value_info("out", JP.TensorProto.FLOAT,
                                   ["N", dims[-1]])],
        initializer=inits)
    return JP.make_model(graph).dumps()


def _weights(ff, torch_side):
    params = ff.params if torch_side else ff.state.params
    return {(op, n): (a.detach().cpu().numpy() if torch_side
                      else np.asarray(a))
            for op, ws in params.items() for n, a in ws.items()}


def _fit_both(jmodel_, tmodel_, xs, y, epochs):
    losses = []
    for m in (jmodel_, tmodel_):
        m.compile(optimizer="SGD", loss=SPARSE,
                  metrics=["accuracy", SPARSE])
        losses.append([m.fit(xs, y, epochs=1, verbose=0).sparse_cce_loss
                       for _ in range(epochs)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=LOSS_RTOL)
    jw, tw = _weights(jmodel_.ffmodel, False), _weights(tmodel_.ffmodel,
                                                         True)
    assert set(tw) == set(jw)
    for k, a in jw.items():
        np.testing.assert_allclose(tw[k], a, atol=WEIGHT_ATOL, err_msg=k)
    return losses[1]


def test_mlp_from_a_model_proto_trains_as_jax():
    blob = _mlp_bytes()
    spec = {1: SimpleNamespace(shape=(None, 784), dtype="float32")}
    jm = JModel(inputs=spec, onnx_model=JP.load_model(blob),
                ffconfig=_jcfg(16))
    tm = TModel(inputs=spec, onnx_model=TP.load_model(blob),
                ffconfig=_tcfg(16))
    rng = np.random.RandomState(0)
    x = rng.rand(64, 784).astype(np.float32)
    y = rng.randint(0, 10, (64, 1)).astype(np.int32)
    losses = _fit_both(jm, tm, x, y, epochs=3)
    assert losses[-1] < losses[0]
    assert "MatMul" in tm.summary() and tm.summary() == jm.summary()


def test_cnn_with_concat_through_the_live_converter_trains_as_jax():
    jm = JModel(*cifar_concat(JL), ffconfig=_jcfg(8))
    tm = TModel(*cifar_concat(TL), ffconfig=_tcfg(8))
    rng = np.random.RandomState(1)
    x = rng.rand(32, 3, 16, 16).astype(np.float32)
    y = rng.randint(0, 10, (32, 1)).astype(np.int32)
    _fit_both(jm, tm, x, y, epochs=2)
    assert "Concat" in tm.summary()
    ev = tm.evaluate(x, y)
    assert np.isfinite(ev.sparse_cce_loss)


def test_two_input_live_model_trains_as_jax():
    jm = JModel(*two_input(JL), ffconfig=_jcfg(8))
    tm = TModel(*two_input(TL), ffconfig=_tcfg(8))
    rng = np.random.RandomState(0)
    xi = rng.rand(32, 3, 16, 16).astype(np.float32)
    xv = rng.rand(32, 12).astype(np.float32)
    y = rng.randint(0, 10, (32, 1)).astype(np.int32)
    losses = _fit_both(jm, tm, [xi, xv], y, epochs=3)
    assert losses[-1] < losses[0]


def test_tf_optimizer_duck_typing_matches_jax():
    var = lambda v: SimpleNamespace(numpy=lambda: v)  # noqa: E731
    sgd = type("SGD", (), {"learning_rate": var(0.05),
                           "momentum": var(0.9), "nesterov": True})()
    adam = type("Adam", (), {"learning_rate": 0.002, "beta_1": var(0.8),
                             "beta_2": None, "epsilon": var(1e-7)})()
    for opt in (sgd, adam, "SGD", "Adam"):
        j, t = jmodel._convert_optimizer(opt), tmodel._convert_optimizer(opt)
        assert type(t).__name__ == type(j).__name__
        assert vars(t) == vars(j)
    for bad in ("RMSprop", type("Adagrad", (), {})()):
        with pytest.raises(AssertionError):
            jmodel._convert_optimizer(bad)
        with pytest.raises(AssertionError):
            tmodel._convert_optimizer(bad)
    # through compile, as tests/test_keras_exp.py drives it
    spec = {1: SimpleNamespace(shape=(None, 784), dtype="float32")}
    tm = TModel(inputs=spec, onnx_model=TP.load_model(_mlp_bytes()),
                ffconfig=_tcfg(8))
    tm.compile(optimizer=sgd, loss=SPARSE, metrics=["accuracy"])
    opt = tm._base_model._ffoptimizer
    assert (opt.learning_rate, opt.momentum, opt.nesterov) == (0.05, 0.9,
                                                               True)
    assert tm.ffmodel.optimizer.lr == 0.05


def test_tensorflow_gate_matches_jax(monkeypatch):
    """Without tensorflow (hidden here), a non-duck-typed model and a
    Sequential without onnx_model raise ImportError in both packages; a
    layer outside the vendored subset raises ImportError naming it."""
    for name in ("tensorflow", "tensorflow.keras", "keras2onnx", "tf2onnx"):
        monkeypatch.setitem(sys.modules, name, None)
    spec = {1: SimpleNamespace(shape=(None, 4))}
    for M, S in ((JModel, JSeq), (TModel, TSeq)):
        with pytest.raises(ImportError, match="tensorflow is not installed"):
            M(inputs=spec, outputs=SimpleNamespace(shape=(4,)))
        with pytest.raises(ImportError, match="tensorflow is not installed"):
            S(layers=[])
        with pytest.raises(AssertionError):
            S(onnx_model=object())
    for L, M, cfg in ((JL, JModel, _jcfg(2)), (TL, TModel, _tcfg(2))):
        x = L.Input((4,))
        out = L.Dense(3, activation="gelu")(x)
        with pytest.raises(ImportError, match="gelu"):
            M(inputs={1: x}, outputs=out, ffconfig=cfg)
