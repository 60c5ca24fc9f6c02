"""flexflow_tpu_torch's ONNX frontend against the JAX package's, on the CPU.

Graphs are written with the port's own codec (`proto.make_graph`/
`make_model`/`save_model`, no `onnx` package) to a file, then imported by
both packages' `ONNXModel(path).apply`, compiled, given the graph's
weights (`load_weights`) and trained 2 steps of SGD on the same numpy
batches: the cases of tests/test_onnx_frontend.py (an MLP through Gemm,
MatMul and Softmax; a MatMul+Add bias folded into one trainable dense; a
scalar Add kept a constant; a pre-bias tap left unfolded; Constant-node
weights folded and lifted) and a small CNN (Conv, Relu, MaxPool, Flatten,
Gemm), each also against numpy. The codec round-trips the JAX package's
bytes, and a model it writes is byte-equal to the JAX codec's. f32 on
the CPU: rtol 1e-5 with atol 1e-6 against JAX, atol 1e-5 against numpy
(the JAX test's bound).
"""
import numpy as np
import pytest

import flexflow_tpu as jff
from flexflow_tpu.frontends.onnx import ONNXModel as JONNXModel
from flexflow_tpu.frontends.onnx import proto as jproto
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.ff_types import LossType
from flexflow_tpu_torch.frontends.onnx import ONNXModel, proto

RTOL, ATOL = 1e-5, 1e-6
NP_ATOL = 1e-5
BATCH = 8
F32 = proto.TensorProto.FLOAT
MSE = "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE"


def _write(tmp_path, nodes, inits, outputs, in_shape, name="g"):
    graph = proto.make_graph(
        nodes, name, [proto.make_tensor_value_info("x", F32, in_shape)],
        [proto.make_tensor_value_info(o, F32, None) for o in outputs],
        [proto.from_array(a, n) for n, a in inits.items()])
    path = str(tmp_path / f"{name}.onnx")
    proto.save_model(proto.make_model(graph), path)
    return path


def _import(path, in_shape, lr=0.01):
    """The file imported into both packages, compiled (MSE, SGD at lr)
    and given its weights: ((jax model, outs), (port model, outs))."""
    cfg = jff.FFConfig()
    cfg.batch_size = in_shape[0]
    cfg.workersPerNode = 1
    jm = jff.FFModel(cfg)
    jom = JONNXModel(path)
    jouts = jom.apply(jm, {"x": jm.create_tensor(list(in_shape),
                                                 jff.DataType.DT_FLOAT)})
    jm.compile(jff.SGDOptimizer(lr=lr), getattr(jff.LossType, MSE), [])
    jom.load_weights(jm)
    tm = FFModel(FFConfig(batch_size=in_shape[0], device="cpu"))
    tom = ONNXModel(path)
    touts = tom.apply(tm, {"x": tm.create_tensor(in_shape)})
    tm.compile(SGDOptimizer(lr=lr), getattr(LossType, MSE))
    tom.load_weights()
    assert [(l.name, l.op_type.name) for l in tm.layers] == \
        [(l.name, l.op_type.name) for l in jm.layers]
    return (jm, jouts), (tm, touts)


def _train_two_steps(jm, tm, in_shape, out_shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2 * in_shape[0], *in_shape[1:]).astype(np.float32)
    y = rng.randn(2 * in_shape[0], *out_shape[1:]).astype(np.float32)
    for m in (jm, tm):
        m.fit(x, y, epochs=1, verbose=False)
    want = {op: {n: np.asarray(a) for n, a in ws.items()}
            for op, ws in jm.state.params.items()}
    assert set(tm.params) == set(want)
    for op, ws in want.items():
        for n, a in ws.items():
            np.testing.assert_allclose(tm.params[op][n].numpy(), a,
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{op}.{n}")


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def test_onnx_mlp_import_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    w1 = rng.randn(16, 32).astype(np.float32)
    b1 = rng.randn(32).astype(np.float32)
    w2 = rng.randn(32, 4).astype(np.float32)
    path = _write(tmp_path, [
        proto.make_node("Gemm", ["x", "w1", "b1"], ["h"]),
        proto.make_node("Relu", ["h"], ["hr"]),
        proto.make_node("MatMul", ["hr", "w2"], ["logits"]),
        proto.make_node("Softmax", ["logits"], ["probs"], axis=-1),
    ], {"w1": w1, "b1": b1, "w2": w2}, ["probs"], [BATCH, 16])
    (jm, _), (tm, _) = _import(path, (BATCH, 16))
    xv = rng.randn(BATCH, 16).astype(np.float32)
    got = tm.predict(xv, batch_size=BATCH)
    np.testing.assert_allclose(got, jm.predict(xv, batch_size=BATCH),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, _softmax(np.maximum(xv @ w1 + b1, 0) @ w2), atol=NP_ATOL)
    _train_two_steps(jm, tm, (BATCH, 16), (BATCH, 4), 1)


def test_onnx_bias_fold_trainable_matches_jax(tmp_path):
    """MatMul -> Add(1-D bias) folds into ONE dense with a trainable bias."""
    rng = np.random.RandomState(0)
    w = rng.randn(16, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    path = _write(tmp_path, [proto.make_node("MatMul", ["x", "w"], ["mm"]),
                             proto.make_node("Add", ["mm", "b"], ["y"])],
                  {"w": w, "b": b}, ["y"], [BATCH, 16])
    (jm, _), (tm, _) = _import(path, (BATCH, 16))
    dense = [l for l in tm.layers if len(l.weights) == 2]
    assert len(dense) == 1, "MatMul+Add should fold to one dense"
    xv = rng.randn(BATCH, 16).astype(np.float32)
    np.testing.assert_allclose(tm.predict(xv, batch_size=BATCH), xv @ w + b,
                               atol=NP_ATOL)
    _train_two_steps(jm, tm, (BATCH, 16), (BATCH, 4), 2)
    assert not np.allclose(tm.params[dense[0].name]["bias"].numpy(), b)


def test_onnx_scalar_add_stays_constant_like_jax(tmp_path):
    """A broadcast shape-(1,) Add operand stays a baked constant."""
    rng = np.random.RandomState(1)
    w = rng.randn(16, 4).astype(np.float32)
    c = np.array([2.5], np.float32)
    path = _write(tmp_path, [proto.make_node("MatMul", ["x", "w"], ["mm"]),
                             proto.make_node("Add", ["mm", "c"], ["y"])],
                  {"w": w, "c": c}, ["y"], [BATCH, 16])
    (jm, _), (tm, _) = _import(path, (BATCH, 16))
    assert [len(l.weights) for l in tm.layers] == [1, 0]
    xv = rng.randn(BATCH, 16).astype(np.float32)
    np.testing.assert_allclose(tm.predict(xv, batch_size=BATCH),
                               xv @ w + 2.5, atol=NP_ATOL)
    _train_two_steps(jm, tm, (BATCH, 16), (BATCH, 4), 3)


def test_onnx_prebias_tap_not_folded_like_jax(tmp_path):
    """A MatMul whose output is itself a graph output is not folded: the
    pre-bias tap stays its own tensor."""
    rng = np.random.RandomState(2)
    w = rng.randn(16, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    path = _write(tmp_path, [proto.make_node("MatMul", ["x", "w"], ["mm"]),
                             proto.make_node("Add", ["mm", "b"], ["y"])],
                  {"w": w, "b": b}, ["mm", "y"], [BATCH, 16])
    cfg = jff.FFConfig()
    cfg.batch_size = BATCH
    jm = jff.FFModel(cfg)
    jouts = JONNXModel(path).apply(
        jm, {"x": jm.create_tensor([BATCH, 16], jff.DataType.DT_FLOAT)})
    tm = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    touts = ONNXModel(path).apply(tm, {"x": tm.create_tensor((BATCH, 16))})
    assert isinstance(touts, list) and len(touts) == len(jouts) == 2
    assert touts[0] is not touts[1], "pre-bias tap aliased to biased output"
    assert [(l.name, l.op_type.name) for l in tm.layers] == \
        [(l.name, l.op_type.name) for l in jm.layers]
    assert [t.dims for t in touts] == [t.dims for t in jouts]


def test_onnx_constant_node_weights_fold_and_lift_like_jax(tmp_path):
    """Constant-node weights (keras2onnx's other layout) fold into the
    dense; a non-bias Constant operand is lifted to a baked constant."""
    rng = np.random.RandomState(3)
    w = rng.randn(16, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)

    def const(arr, out):
        return proto.make_node("Constant", [], [out],
                               value=proto.from_array(arr, out))

    path = _write(tmp_path, [
        const(w, "w"), const(b, "b"), const(np.array([1.5], np.float32), "c"),
        proto.make_node("MatMul", ["x", "w"], ["mm"]),
        proto.make_node("Add", ["mm", "b"], ["y"]),
        proto.make_node("Add", ["y", "c"], ["z"]),
    ], {}, ["z"], [BATCH, 16])
    (jm, _), (tm, _) = _import(path, (BATCH, 16))
    assert len([l for l in tm.layers if len(l.weights) == 2]) == 1
    xv = rng.randn(BATCH, 16).astype(np.float32)
    got = tm.predict(xv, batch_size=BATCH)
    np.testing.assert_allclose(got, xv @ w + b + 1.5, atol=NP_ATOL)
    np.testing.assert_allclose(got, jm.predict(xv, batch_size=BATCH),
                               rtol=RTOL, atol=ATOL)
    _train_two_steps(jm, tm, (BATCH, 16), (BATCH, 4), 4)


def _small_cnn(rng):
    """Conv(3->4, 3x3, pad 1) + bias, Relu, MaxPool 2, Flatten, Gemm with
    transB (the torch.onnx.export layout)."""
    inits = {"cw": rng.randn(4, 3, 3, 3).astype(np.float32) * 0.3,
             "cb": rng.randn(4).astype(np.float32) * 0.1,
             "fw": rng.randn(5, 64).astype(np.float32) * 0.2,
             "fb": rng.randn(5).astype(np.float32) * 0.1}
    nodes = [
        proto.make_node("Conv", ["x", "cw", "cb"], ["c"],
                        kernel_shape=[3, 3], pads=[1, 1, 1, 1],
                        strides=[1, 1]),
        proto.make_node("Relu", ["c"], ["r"]),
        proto.make_node("MaxPool", ["r"], ["p"], kernel_shape=[2, 2],
                        strides=[2, 2]),
        proto.make_node("Flatten", ["p"], ["f"]),
        proto.make_node("Gemm", ["f", "fw", "fb"], ["y"], transB=1),
    ]
    return nodes, inits


def test_onnx_cnn_trains_like_jax(tmp_path):
    rng = np.random.RandomState(5)
    nodes, inits = _small_cnn(rng)
    shape = (4, 3, 8, 8)
    path = _write(tmp_path, nodes, inits, ["y"], list(shape))
    (jm, _), (tm, _) = _import(path, shape)
    assert [l.op_type.name for l in tm.layers] == [
        "OP_CONV2D", "OP_RELU", "OP_POOL2D", "OP_FLAT", "OP_LINEAR"]
    xv = rng.randn(*shape).astype(np.float32)
    np.testing.assert_allclose(tm.predict(xv, batch_size=4),
                               jm.predict(xv, batch_size=4), rtol=RTOL,
                               atol=ATOL)
    _train_two_steps(jm, tm, shape, (4, 5), 6)


def _model(p):
    rng = np.random.RandomState(8)
    nodes, inits = _small_cnn(rng)
    nodes = nodes + [p.make_node("Softmax", ["y"], ["s"], axis=-1)]
    graph = p.make_graph(
        nodes, "cnn", [p.make_tensor_value_info("x", 1, [4, 3, "h", 8])],
        [p.make_tensor_value_info("s", 1, [4, 5])],
        [p.from_array(a, n) for n, a in inits.items()])
    return p.make_model(graph, producer_name="ff")


def test_codec_round_trips_jax_bytes(tmp_path):
    """The JAX codec's bytes parse in the port's and write back equal; a
    model the port builds is byte-equal to the JAX codec's; the arrays
    read back equal, by `to_array` and through `load_model` of a file."""
    want = _model(jproto).dumps()
    assert proto.ModelProto.parse(want).dumps() == want
    assert _model(proto).dumps() == want
    path = tmp_path / "cnn.onnx"
    jproto.save_model(_model(jproto), str(path))
    got = proto.load_model(str(path))
    jgot = jproto.load_model(str(path))
    assert [n.op_type for n in got.graph.node] == \
        [n.op_type for n in jgot.graph.node]
    for t, j in zip(got.graph.initializer, jgot.graph.initializer):
        assert t.name == j.name
        np.testing.assert_array_equal(proto.to_array(t), jproto.to_array(j))
    dims = got.graph.input[0].type.tensor_type.shape.dim
    assert [d.dim_value or d.dim_param for d in dims] == [4, 3, "h", 8]
    assert proto.load_model(want).dumps() == want
