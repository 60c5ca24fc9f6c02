"""flexflow_tpu_torch's Keras frontend against the JAX package's, on the
CPU.

Each case builds the same Keras model with both packages' frontends
(`flexflow_tpu.frontends.keras` and `flexflow_tpu_torch.frontends.keras`),
compiles both (the port's `model.ffconfig.device = "cpu"`: a Keras Model
names the card until told otherwise), gives the port's layers the JAX
layers' weights through the Keras API (`get_weights`/`set_weights`, by
layer position) and fits both on the same numpy batches: the cases of
tests/test_keras_frontend.py (a functional MLP, a Sequential CNN, merges
with a LambdaCallback, get/set_weights) and flows of examples/python/
keras (L1 and L2 kernel regularizers, LearningRateScheduler over the
train scan, K.sum, K.internal.gather with two inputs, a nested
Sequential, net2net's get_layer, the datasets read from fixture files
under KERAS_DATA_DIR). The slice as a whole: the flagship Transformer
written as a Keras functional model (2 blocks, hidden 32, 4 heads, seq
16, batch 4), fit 2 steps against JAX's Keras model from the same
weights, and bit-equal to the port's `build_transformer` model given the
same weights through the native API. f32 on the CPU: rtol 1e-5 with atol
1e-6 on weights and metrics (the packages sum the same products in other
orders).
"""
import numpy as np
import pytest

from flexflow_tpu.frontends import keras as jk
from flexflow_tpu.frontends.keras import backend as jK
from flexflow_tpu.frontends.keras import datasets as jdatasets
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.ff_types import LossType, MetricsType
from flexflow_tpu_torch.frontends import keras as tk
from flexflow_tpu_torch.frontends.keras import backend as tK
from flexflow_tpu_torch.frontends.keras import datasets as tdatasets
from flexflow_tpu_torch.models import build_transformer

RTOL, ATOL = 1e-5, 1e-6


def synth(n, shape, classes, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, *shape).astype(np.float32)
    w = rng.randn(int(np.prod(shape)), classes).astype(np.float32)
    y = np.argmax(x.reshape(n, -1) @ w, 1).astype(np.int32)[:, None]
    return x, y


def _compile_pair(build):
    """`build(keras module)` -> (model, {compile kwargs}) for each package;
    both compiled (one worker, the port on the CPU), the port's weights
    set from JAX's layer by layer."""
    out = []
    for k in (jk, tk):
        model, kw = build(k)
        model.ffconfig.workersPerNode = 1
        if k is tk:
            model.ffconfig.device = "cpu"
        model.compile(**kw)
        out.append(model)
    jmodel, tmodel = out
    _carry(jmodel, tmodel)
    return jmodel, tmodel


def _carry(jmodel, tmodel):
    jl, tl = jmodel.layers, tmodel.layers
    assert [type(a).__name__ for a in tl] == [type(a).__name__ for a in jl]
    for a, b in zip(jl, tl):
        if getattr(a, "_ff_layer", None) is not None and a._ff_layer.weights:
            b.set_weights(a.get_weights())


def _assert_weights(jmodel, tmodel, rtol=RTOL, atol=ATOL):
    n = 0
    for a, b in zip(jmodel.layers, tmodel.layers):
        if getattr(a, "_ff_layer", None) is None or not a._ff_layer.weights:
            continue
        for wa, wb in zip(a.get_weights(), b.get_weights()):
            np.testing.assert_allclose(wb, np.asarray(wa), rtol=rtol,
                                       atol=atol, err_msg=a.name)
            n += 1
    assert n > 0


def _mlp(k, reg=None):
    inp = k.Input(shape=(16,))
    t = k.Dense(64, activation="relu", kernel_regularizer=reg)(inp)
    t = k.Dense(4, activation="softmax")(t)
    return k.Model(inputs=inp, outputs=t), dict(
        optimizer=k.SGD(learning_rate=0.05),
        loss="sparse_categorical_crossentropy", metrics=["accuracy"],
        batch_size=32)


def test_functional_mlp_matches_jax():
    jmodel, tmodel = _compile_pair(_mlp)
    x, y = synth(128, (16,), 4)
    jpm = jmodel.fit(x, y, batch_size=32, epochs=2, verbose=False)
    tpm = tmodel.fit(x, y, batch_size=32, epochs=2, verbose=False)
    assert (tpm.train_all, tpm.train_correct) == (jpm.train_all,
                                                  jpm.train_correct)
    _assert_weights(jmodel, tmodel)
    jev = jmodel.evaluate(x, y, batch_size=32)
    tev = tmodel.evaluate(x, y, batch_size=32)
    assert tev.get_accuracy() == jev.get_accuracy()
    np.testing.assert_allclose(tmodel.predict(x, batch_size=32),
                               jmodel.predict(x, batch_size=32), rtol=RTOL,
                               atol=ATOL)


def _cnn(k):
    model = k.Sequential()
    model.add(k.Input(shape=(1, 8, 8)))
    model.add(k.Conv2D(4, 3, padding="same", activation="relu"))
    model.add(k.MaxPooling2D(2))
    model.add(k.Flatten())
    model.add(k.Dense(3, activation="softmax"))
    return model, dict(optimizer="sgd",
                       loss="sparse_categorical_crossentropy",
                       metrics=["accuracy"], batch_size=16)


def test_sequential_cnn_matches_jax():
    jmodel, tmodel = _compile_pair(_cnn)
    x, y = synth(64, (1, 8, 8), 3)
    jpm = jmodel.fit(x, y, batch_size=16, epochs=2, verbose=False)
    tpm = tmodel.fit(x, y, batch_size=16, epochs=2, verbose=False)
    assert tpm.train_all == jpm.train_all == 64
    assert tpm.train_correct == jpm.train_correct
    _assert_weights(jmodel, tmodel)


def _merge(k):
    inp = k.Input(shape=(8,))
    a = k.Dense(8)(inp)
    b = k.Dense(8)(inp)
    t = k.Add()([a, b])
    t = k.Multiply()([t, k.Dense(8, activation="sigmoid")(inp)])
    t = k.Dense(2, activation="softmax")(t)
    return k.Model(inputs=inp, outputs=t), dict(
        optimizer=k.Adam(learning_rate=0.01),
        loss="sparse_categorical_crossentropy", metrics=["accuracy"],
        batch_size=16)


def test_merge_and_callbacks_match_jax():
    jmodel, tmodel = _compile_pair(_merge)
    x, y = synth(64, (8,), 2)
    calls = {"jax": [], "port": []}
    for key, model, k in (("jax", jmodel, jk), ("port", tmodel, tk)):
        cb = k.callbacks.LambdaCallback(
            on_epoch_begin=lambda e, logs=None, key=key:
                calls[key].append(("begin", e)),
            on_epoch_end=lambda e, logs, key=key:
                calls[key].append(("end", e, round(logs["accuracy"], 6))),
            on_train_end=lambda key=key: calls[key].append("done"))
        model.fit(x, y, batch_size=16, epochs=3, verbose=False,
                  callbacks=[cb])
    assert calls["port"] == calls["jax"]
    assert calls["port"][-1] == "done" and len(calls["port"]) == 7
    _assert_weights(jmodel, tmodel)


def test_get_set_weights_like_jax():
    for k in (jk, tk):
        inp = k.Input(shape=(4,))
        layer = k.Dense(3)
        model = k.Model(inputs=inp, outputs=layer(inp))
        model.ffconfig.workersPerNode = 1
        if k is tk:
            model.ffconfig.device = "cpu"
        model.compile(optimizer="sgd", loss="mse", metrics=[], batch_size=8)
        w = layer.get_weights()
        assert [a.shape for a in w] == [(4, 3), (3,)]
        layer.set_weights([np.ones((4, 3), np.float32),
                           np.zeros(3, np.float32)])
        np.testing.assert_allclose(layer.get_weights()[0], 1.0)
        x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
        np.testing.assert_allclose(model.predict(x, batch_size=8),
                                   x.sum(1, keepdims=True).repeat(3, 1),
                                   rtol=RTOL, atol=ATOL)


def test_a_keras_model_names_the_card_until_told_otherwise():
    """FFConfig's default device is the card: compile on a machine
    without one raises, it does not fall back to the CPU."""
    model, kw = _mlp(tk)
    assert model.ffconfig.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.compile(**kw)


@pytest.mark.parametrize("kind,lam", [("L1", 0.01), ("L2", 0.001)])
def test_regularizer_matches_jax(kind, lam):
    """examples/python/keras/regularizer.py: Dense(kernel_regularizer=
    L1/L2) under Adam, MSE, 2 epochs."""
    def build(k):
        inp = k.Input(shape=(32,), dtype="float32")
        x = k.Dense(20, activation="relu",
                    kernel_regularizer=getattr(k.regularizers, kind)(lam))(inp)
        out = k.Dense(1)(x)
        return k.Model(inp, out), dict(
            optimizer=k.Adam(learning_rate=0.01), loss="mean_squared_error",
            metrics=["mean_squared_error"], batch_size=16)

    jmodel, tmodel = _compile_pair(build)
    assert tmodel.ffmodel.layers[0].params.kernel_reg_type.name == \
        jmodel.ffmodel.layers[0].params.kernel_reg_type.name
    rng = np.random.RandomState(1)
    x = rng.randn(64, 32).astype(np.float32)
    y = rng.randn(64, 1).astype(np.float32)
    for m in (jmodel, tmodel):
        m.fit(x, y, epochs=2, verbose=False)
    _assert_weights(jmodel, tmodel)


def test_learning_rate_scheduler_over_the_scan_matches_jax():
    """examples/python/keras/callback.py's schedule (0.01, then 0.02) on
    a CNN, fit with iterations_per_dispatch=3: each epoch steps at its
    rate, as JAX's."""
    def build(k):
        inp = k.Input(shape=(3, 8, 8))
        x = k.Conv2D(filters=4, kernel_size=(3, 3), strides=(1, 1),
                     padding=(1, 1), activation="relu")(inp)
        x = k.MaxPooling2D(pool_size=(2, 2), strides=(2, 2))(x)
        x = k.Flatten()(x)
        x = k.Dense(16, activation="relu")(x)
        out = k.Activation("softmax")(k.Dense(5)(x))
        return k.Model(inp, out), dict(
            optimizer=k.SGD(learning_rate=0.01),
            loss="sparse_categorical_crossentropy",
            metrics=["accuracy", "sparse_categorical_crossentropy"],
            batch_size=8)

    rates = {"jax": [], "port": []}
    models = []
    for key, k in (("jax", jk), ("port", tk)):
        model, kw = build(k)
        model.ffconfig.workersPerNode = 1
        model.ffconfig.iterations_per_dispatch = 3
        if k is tk:
            model.ffconfig.device = "cpu"
        model.compile(**kw)
        models.append(model)
    _carry(*models)
    x, y = synth(48, (3, 8, 8), 5, seed=2)
    for key, model, k in zip(("jax", "port"), models, (jk, tk)):
        sched = k.callbacks.LearningRateScheduler(
            lambda e: 0.01 if e == 0 else 0.02)
        seen = k.callbacks.LambdaCallback(
            on_epoch_end=lambda e, logs, model=model, key=key:
                rates[key].append(model.ffmodel.get_learning_rate()))
        model.fit(x, y, epochs=3, verbose=False, callbacks=[sched, seen])
    assert rates["port"] == rates["jax"] == [0.01, 0.02, 0.02]
    _assert_weights(*models)


def test_backend_sum_and_gather_flows_match_jax():
    """examples/python/keras/reduce_sum.py (K.sum over one and two axes)
    and gather.py (K.internal.gather with an int32 index input)."""
    def one_axis(k, K):
        in0 = k.Input(shape=(32,), dtype="float32")
        x0 = k.Reshape((10, 2))(k.Dense(20, activation="relu")(in0))
        return k.Model(in0, K.sum(x0, axis=1))

    def two_axes(k, K):
        in0 = k.Input(shape=(32,), dtype="float32")
        x0 = k.Reshape((10, 2))(k.Dense(20, activation="relu")(in0))
        return k.Model(in0, K.sum(x0, axis=[1, 2], keepdims=True))

    def gather(k, K):
        in0 = k.Input(shape=(10,), dtype="float32")
        in1 = k.Input(shape=(6, 3), dtype="int32")
        x0 = k.Reshape((10, 3))(k.Dense(30, activation="relu")(in0))
        f0 = k.Reshape((18,))(K.internal.gather(x0, in1, axis=1))
        return k.Model([in0, in1], k.Dense(1)(f0))

    rng = np.random.RandomState(3)
    idx = np.array([[5, 7, 9], [8, 4, 0]]).reshape(-1, 1).repeat(3, 1)
    cases = {
        one_axis: ([rng.randn(32, 32).astype(np.float32)],
                   rng.randn(32, 2).astype(np.float32)),
        two_axes: ([rng.randn(32, 32).astype(np.float32)],
                   rng.randn(32, 1).astype(np.float32)),
        gather: ([rng.randn(32, 10).astype(np.float32),
                  idx[None].repeat(32, 0).astype(np.int32)],
                 rng.randn(32, 1).astype(np.float32)),
    }
    for fn, (xs, y) in cases.items():
        def build(k, fn=fn):
            return fn(k, jK if k is jk else tK), dict(
                optimizer=k.Adam(learning_rate=0.01),
                loss="mean_squared_error", metrics=["mean_squared_error"],
                batch_size=16)

        jmodel, tmodel = _compile_pair(build)
        for m in (jmodel, tmodel):
            m.fit(xs if len(xs) > 1 else xs[0], y, epochs=1, verbose=False)
        _assert_weights(jmodel, tmodel)
    assert tK.backend() == "flexflow_tpu_torch"
    assert (tK.epsilon(), tK.floatx(), tK.image_data_format()) == \
        (jK.epsilon(), jK.floatx(), jK.image_data_format())


def test_nested_sequential_and_net2net_get_layer_match_jax():
    """seq_mnist_cnn_nested.py: a Sequential holding a Model; and
    func_cifar10_cnn_net2net.py's student taking the teacher's weights by
    `get_layer(name=)`."""
    def build(k):
        inner = k.Sequential([k.Dense(12, activation="relu",
                                      input_shape=(10,), name="inner1")])
        outer = k.Sequential()
        outer.add(inner)
        outer.add(k.Dense(3, activation="softmax", name="head"))
        return outer, dict(optimizer=k.SGD(learning_rate=0.1),
                           loss="sparse_categorical_crossentropy",
                           metrics=["accuracy"], batch_size=8)

    jmodel, tmodel = _compile_pair(build)
    x, y = synth(32, (10,), 3, seed=4)
    for m in (jmodel, tmodel):
        m.fit(x, y, epochs=1, verbose=False)
    _assert_weights(jmodel, tmodel)
    # the student: fresh models given the trained ones' weights by name
    students = []
    for teacher, k in ((jmodel, jk), (tmodel, tk)):
        student, kw = build(k)
        student.ffconfig.workersPerNode = 1
        if k is tk:
            student.ffconfig.device = "cpu"
        student.compile(**kw)
        for name in ("inner1", "head"):
            student.get_layer(name=name).set_weights(
                teacher.get_layer(name=name).get_weights(teacher.ffmodel))
        student.fit(x, y, epochs=1, verbose=False)
        students.append(student)
    _assert_weights(*students)


def test_datasets_read_fixture_files_like_jax(tmp_path, monkeypatch):
    """mnist and cifar10 from `<name>.npz` under KERAS_DATA_DIR (fixture
    files the test writes), the synthetic fallback without them, and
    reuters: the same arrays as the JAX package's loaders."""
    rng = np.random.RandomState(5)
    np.savez(tmp_path / "mnist.npz",
             x_train=rng.randint(0, 256, (6, 28, 28)).astype(np.uint8),
             y_train=rng.randint(0, 10, (6,)), x_test=np.zeros((2, 28, 28)),
             y_test=np.ones(2))
    monkeypatch.setenv("KERAS_DATA_DIR", str(tmp_path))
    for name in ("mnist", "cifar10"):
        got = getattr(tdatasets, name).load_data(n_train=16, n_test=4)
        want = getattr(jdatasets, name).load_data(n_train=16, n_test=4)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    (x, _), _ = tdatasets.mnist.load_data()
    assert x.shape == (6, 28, 28)        # the fixture, not the fallback
    (x, y), _ = tdatasets.cifar10.load_data(n_train=16, n_test=4)
    assert x.shape == (16, 32, 32, 3) and y.shape == (16, 1)
    got = tdatasets.reuters.load_data(n_train=8, n_test=4, maxlen=10)
    want = jdatasets.reuters.load_data(n_train=8, n_test=4, maxlen=10)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


# -- the slice as a whole: the flagship as a Keras functional model ---------
FLAG = dict(batch=4, seq=16, hidden=32, heads=4, layers=2)


def _keras_flagship(k, batch=FLAG["batch"], seq=FLAG["seq"],
                    hidden=FLAG["hidden"], heads=FLAG["heads"],
                    layers=FLAG["layers"]):
    """The flagship Transformer (models/transformer.py: MHA with biases,
    then Dense RELU and Dense, no biases) as a Keras functional model."""
    inp = k.Input(shape=(seq, hidden))
    t = inp
    for _ in range(layers):
        t = k.MultiHeadAttention(heads, hidden // heads)([t, t, t])
        t = k.Dense(hidden, activation="relu", use_bias=False)(t)
        t = k.Dense(hidden, use_bias=False)(t)
    return k.Model(inp, t), dict(optimizer=k.SGD(learning_rate=0.01),
                                 loss="mse", metrics=["mse"],
                                 batch_size=batch)


def test_keras_flagship_fits_like_jax_and_like_build_transformer():
    jmodel, tmodel = _compile_pair(_keras_flagship)
    kinds = [l.op_type.name for l in tmodel.ffmodel.layers]
    assert kinds == [l.op_type.name for l in jmodel.ffmodel.layers]
    assert kinds == ["OP_MULTIHEAD_ATTENTION", "OP_LINEAR",
                     "OP_LINEAR"] * FLAG["layers"]
    # the port's build_transformer model, its weights set from the Keras
    # model's through the native API, layer by layer
    ref = FFModel(FFConfig(batch_size=FLAG["batch"], device="cpu"))
    build_transformer(ref, FLAG["batch"], FLAG["seq"], FLAG["hidden"],
                      FLAG["heads"], FLAG["layers"])
    ref.compile(SGDOptimizer(lr=0.01),
                LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
                [MetricsType.METRICS_MEAN_SQUARED_ERROR])
    for kl, rl in zip(tmodel.ffmodel.layers, ref.layers):
        for kw, rw in zip(kl.weights, rl.weights):
            rw.set_weights(ref, kw.get_weights())
    rng = np.random.RandomState(6)
    shape = (2 * FLAG["batch"], FLAG["seq"], FLAG["hidden"])
    x = rng.randn(*shape).astype(np.float32)
    y = rng.randn(*shape).astype(np.float32)
    losses = {}
    for key, m in (("jax", jmodel), ("port", tmodel)):
        pm = m.fit(x, y, epochs=1, verbose=False)
        losses[key] = pm.mse_loss
    rpm = ref.fit(x, y, epochs=1, verbose=False)
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=RTOL)
    assert rpm.mse_loss == losses["port"]
    _assert_weights(jmodel, tmodel)
    for kl, rl in zip(tmodel.ffmodel.layers, ref.layers):
        for kw, rw in zip(kl.weights, rl.weights):
            np.testing.assert_array_equal(kw.get_weights(), rw.get_weights())
