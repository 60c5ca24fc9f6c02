"""flexflow_tpu_torch's native Python API against the JAX package's, on
the CPU.

The calls of examples/python/native/*.py: a Tensor's `get_tensor`/
`set_tensor`, `attach_numpy_array`/`detach_numpy_array`, `inline_map`/
`get_array`/`inline_unmap`, `get_weights`/`set_weights`, `num_dims`/
`get_volume`; a Layer's `get_{output,input,weight,bias}_tensor`; the
FFModel lookups (`get_layers`, `get_layer_by_id`, `get_layer_by_name`,
`get_last_layer`, `print_layers`), `get_perf_metrics`/`reset_metrics`/
`compute_metrics`, `get_learning_rate`/`set_learning_rate`, the no-op
`prefetch`/`map_tensor`, and the dense layer's kernel regularizer (L1 and
L2, its penalty in the training loss).

Both packages build the same small MLP (16 -> 32 RELU -> 4 -> softmax,
biases on)
or the flagship Transformer (2 blocks, hidden 16, 2 heads, seq 8); the
JAX weights are carried into the port with `params_from_numpy`, the
batches made from a numpy seed. f32 on the CPU: rtol 1e-5 with atol 1e-6
on weights, logits and metrics, as in the training slice (the two sum the
same products in other orders). A weight written through `set_tensor` is
compared exactly: it is a copy.
"""
import numpy as np
import pytest
import torch

import flexflow_tpu as jff
from flexflow_tpu.ff_types import ActiMode as JActiMode
from flexflow_tpu.models.transformer import build_transformer as jbuild
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.core.optimizers import AdamOptimizer
from flexflow_tpu_torch.ff_types import (ActiMode, DataType, LossType,
                                         MetricsType)
from flexflow_tpu_torch.models import build_transformer
from flexflow_tpu_torch.runtime.weights import params_from_numpy

RTOL, ATOL = 1e-5, 1e-6
BATCH, IN, HID, OUT = 8, 16, 32, 4
SPARSE = "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY"
MSE = "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE"
TF = dict(batch=2, seq=8, hidden=16, heads=2, layers=2)


def _np_params(params):
    return {op: {n: np.array(a, np.float32) for n, a in ws.items()}
            for op, ws in params.items()}


def _jax_cfg(batch, **kw):
    cfg = jff.FFConfig()
    cfg.batch_size = batch
    cfg.workersPerNode = 1
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _mlp(ff, x, reg, acti):
    t = ff.dense(x, HID, acti.AC_MODE_RELU, kernel_regularizer=reg)
    return ff.softmax(ff.dense(t, OUT, kernel_regularizer=reg))


def _mlp_pair(reg=None, opt=None, metrics=True, loss=SPARSE):
    """The MLP compiled in both packages (SGD lr 0.1 unless `opt` names
    the JAX and port optimizers), JAX's weights carried over."""
    mets = ["METRICS_ACCURACY", "METRICS_SPARSE_CATEGORICAL_CROSSENTROPY"] \
        if metrics else []
    jm = jff.FFModel(_jax_cfg(BATCH))
    jx = jm.create_tensor((BATCH, IN), jff.DataType.DT_FLOAT)
    _mlp(jm, jx, reg, JActiMode)
    jopt, topt = opt or (jff.SGDOptimizer(lr=0.1), SGDOptimizer(lr=0.1))
    jm.compile(jopt, getattr(jff.LossType, loss),
               [getattr(jff.MetricsType, m) for m in mets])
    tm = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    tx = tm.create_tensor((BATCH, IN))
    _mlp(tm, tx, reg, ActiMode)
    tm.compile(topt, getattr(LossType, loss),
               [getattr(MetricsType, m) for m in mets])
    params_from_numpy(tm, _np_params(jm.state.params))
    return (jm, jx), (tm, tx)


def _data(seed, n=BATCH):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, IN).astype(np.float32),
            rng.randint(0, OUT, (n, 1)).astype(np.int32))


def _assert_params(tm, jm, rtol=RTOL, atol=ATOL):
    want = _np_params(jm.state.params)
    assert set(tm.params) == set(want)
    for op, ws in want.items():
        for n, a in ws.items():
            np.testing.assert_allclose(tm.params[op][n].float().numpy(), a,
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{op}.{n}")


def test_weight_access_matches_jax():
    """get_tensor/get_weights of every weight, num_dims and get_volume;
    set_tensor and set_weights of new values, then the same forward;
    inline_map/get_array/inline_unmap of an edited weight."""
    (jm, _), (tm, _) = _mlp_pair()
    for jl, tl in zip(jm.layers, tm.layers):
        for jw, tw in zip(jl.weights, tl.weights):
            assert (tw.num_dims, tw.get_volume()) == \
                (jw.num_dims, jw.get_volume())
            np.testing.assert_array_equal(tw.get_tensor(tm),
                                          np.asarray(jw.get_tensor(jm)))
            np.testing.assert_array_equal(tw.get_weights(),
                                          np.asarray(jw.get_weights()))
    rng = np.random.RandomState(7)
    first = tm.get_layer_by_id(0)
    kernel = rng.randn(IN, HID).astype(np.float32)
    bias = rng.randn(HID).astype(np.float32)
    first.get_weight_tensor().set_tensor(tm, kernel)
    jm.get_layer_by_id(0).get_weight_tensor().set_tensor(jm, kernel)
    first.get_bias_tensor().set_weights(tm, bias)
    jm.get_layer_by_id(0).get_bias_tensor().set_weights(jm, bias)
    np.testing.assert_array_equal(first.get_weight_tensor().get_tensor(),
                                  kernel)
    np.testing.assert_array_equal(first.get_bias_tensor().get_weights(),
                                  bias)
    # inline map, edit, unmap: the edit lands in both
    for m in (tm, jm):
        w = m.get_layer_by_id(1).get_weight_tensor()
        w.inline_map(m)
        arr = w.get_array(m)
        arr *= -0.5
        w.inline_unmap(m)
    _assert_params(tm, jm, rtol=0, atol=0)
    x, _ = _data(1)
    np.testing.assert_allclose(tm.predict(x), jm.predict(x), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(ValueError, match="shape mismatch"):
        first.get_weight_tensor().set_tensor(tm, kernel.T)


def test_attach_and_inline_map_drive_the_stepwise_loop_like_jax():
    """examples/python/native/mnist_mlp_attach.py's loop: the input and
    the label bound by attach_numpy_array and by set_tensor, read back by
    get_tensor and inline_map; forward, backward and update in both, for
    two batches, give JAX's weights."""
    (jm, jx), (tm, tx) = _mlp_pair()
    for m in (jm, tm):
        label = m.get_label_tensor()
        label.inline_map(m)     # before any batch: zeros of its shape
        np.testing.assert_array_equal(
            label.get_array(m), np.zeros(label.dims,
                                         label.data_type.np_dtype))
        label.inline_unmap(m)
    for seed in (2, 3):
        x, y = _data(seed)
        for m, t in ((jm, jx), (tm, tx)):
            if seed == 2:
                t.attach_numpy_array(m, None, x)
                m.get_label_tensor().attach_numpy_array(m, None, y)
            else:
                t.set_tensor(m, x)
                m.get_label_tensor().set_tensor(m, y)
            np.testing.assert_array_equal(t.get_tensor(m), x)
            m.get_label_tensor().inline_map(m)
            np.testing.assert_array_equal(
                m.get_label_tensor().get_array(m), y)
            m.get_label_tensor().inline_unmap(m)
            m.forward()
            m.zero_gradients()
            m.backward()
            m.update()
            t.detach_numpy_array(m)
    _assert_params(tm, jm)
    hidden = tm.get_layer_by_id(0).get_output_tensor()
    with pytest.raises(KeyError, match="activations are not retained"):
        hidden.get_tensor()


def test_set_tensor_writes_the_weight_in_place():
    """The parameter keeps its storage (a captured graph reads it by
    address) and its version moves (the serving caches refresh)."""
    (_, _), (tm, _) = _mlp_pair()
    w = tm.get_layer_by_id(1).get_weight_tensor()
    dst = tm.params[tm.layers[1].name]["kernel"]
    ptr, ver = dst.data_ptr(), dst._version
    new = np.full(w.dims, 0.25, np.float32)
    w.set_weights(tm, new)
    assert dst.data_ptr() == ptr and dst._version > ver
    assert tm.params[tm.layers[1].name]["kernel"] is dst
    np.testing.assert_array_equal(dst.numpy(), new)


def _tf_pair(spd, opt):
    jm = jff.FFModel(_jax_cfg(TF["batch"], iterations_per_dispatch=spd))
    jbuild(jm, TF["batch"], TF["seq"], TF["hidden"], TF["heads"],
           TF["layers"])
    jm.compile(opt[0], getattr(jff.LossType, MSE), [])
    tm = FFModel(FFConfig(batch_size=TF["batch"], device="cpu",
                          iterations_per_dispatch=spd))
    build_transformer(tm, TF["batch"], TF["seq"], TF["hidden"], TF["heads"],
                      TF["layers"])
    tm.compile(opt[1], getattr(LossType, MSE))
    params_from_numpy(tm, _np_params(jm.state.params))
    return jm, tm


def _tf_data(seed, n=6):
    rng = np.random.RandomState(seed)
    shape = (n, TF["seq"], TF["hidden"])
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def test_set_tensor_after_a_scanned_fit_is_seen_by_the_next_fit():
    """fit with iterations_per_dispatch=3 (two chunks of the train scan),
    set_tensor of the first block's output projection, fit again: JAX's
    weights."""
    jm, tm = _tf_pair(3, (jff.SGDOptimizer(lr=0.01), SGDOptimizer(lr=0.01)))
    x, y = _tf_data(0)
    for m in (jm, tm):
        m.fit(x, y, epochs=1, verbose=False)
    w = np.random.RandomState(9).randn(
        *tm.layers[1].get_weight_tensor().dims).astype(np.float32) * 0.1
    for m in (jm, tm):
        m.get_layer_by_id(1).get_weight_tensor().set_tensor(m, w)
        m.fit(x, y, epochs=1, verbose=False)
    _assert_params(tm, jm)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_set_learning_rate_between_scanned_fits_matches_jax(kind):
    """get_learning_rate, then set_learning_rate between two fits with
    iterations_per_dispatch=3: the second fit steps at the new rate, as
    JAX's (SGD's lr, Adam's alpha)."""
    opt = ((jff.SGDOptimizer(lr=0.01), SGDOptimizer(lr=0.01))
           if kind == "sgd" else
           (jff.AdamOptimizer(alpha=0.001), AdamOptimizer(alpha=0.001)))
    jm, tm = _tf_pair(3, opt)
    assert tm.get_learning_rate() == jm.get_learning_rate()
    x, y = _tf_data(1)
    for m in (jm, tm):
        m.fit(x, y, epochs=1, verbose=False)
        m.set_learning_rate(m.get_learning_rate() * 4)
        m.fit(x, y, epochs=1, verbose=False)
    assert tm.get_learning_rate() == jm.get_learning_rate()
    _assert_params(tm, jm)


def test_layer_lookups_and_print_layers_match_jax(capsys):
    (jm, jx), (tm, tx) = _mlp_pair()
    assert list(tm.get_layers()) == list(jm.get_layers())
    assert [layer.name for layer in tm.get_layers().values()] == \
        [layer.name for layer in jm.get_layers().values()]
    for i, jl in enumerate(jm.layers):
        tl = tm.get_layer_by_id(i)
        assert tm.get_layer_by_name(jl.name) is tl
        assert tl.get_output_tensor().dims == jl.get_output_tensor().dims
        assert tl.get_input_tensor().dims == jl.get_input_tensor().dims
        assert [w.dims for w in tl.weights] == [w.dims for w in jl.weights]
    assert tm.get_layer_by_id(0).get_input_tensor() is tx
    assert tm.get_last_layer() is tm.layers[-1]
    with pytest.raises(KeyError):
        tm.get_layer_by_name("nope")
    for m in (jm, tm):
        m.prefetch()
        m.map_tensor(m.get_last_layer().get_output_tensor())
    jm.print_layers()
    want = capsys.readouterr().out
    tm.print_layers()
    assert capsys.readouterr().out == want != ""
    jm.print_layers(1)
    want = capsys.readouterr().out
    tm.print_layers(1)
    assert capsys.readouterr().out == want
    assert want.startswith("layer 1: ")


def test_compute_metrics_after_a_stepwise_forward_matches_jax():
    """set_iteration_batch, forward, compute_metrics over two batches
    (accuracy and sparse CE partials folded in), then reset_metrics."""
    (jm, _), (tm, _) = _mlp_pair()
    for m in (jm, tm):
        m.reset_metrics()
    for seed in (4, 5):
        x, y = _data(seed)
        for m in (jm, tm):
            m.set_iteration_batch([x], y)
            m.forward()
            m.compute_metrics()
    jp, tp = jm.get_perf_metrics(), tm.get_perf_metrics()
    assert (tp.train_all, tp.train_correct) == (jp.train_all,
                                                jp.train_correct)
    assert tp.train_all == 2 * BATCH
    np.testing.assert_allclose(tp.sparse_cce_loss, jp.sparse_cce_loss,
                               rtol=RTOL, atol=ATOL)
    assert tp.get_accuracy() == jp.get_accuracy()
    tm.reset_metrics()
    assert tm.get_perf_metrics().train_all == 0


@pytest.mark.parametrize("reg", [
    ("l1", 0.01), ("l2", 0.05), 0.02,
], ids=["l1", "l2", "l2_float"])
def test_regularized_dense_trains_to_jax_weights(reg):
    """dense(kernel_regularizer=) in L1 and L2 (a tuple, or a bare number
    for L2): three fit steps and a stepwise step give JAX's weights, and
    the fit's loss includes the penalty."""
    (jm, jx), (tm, tx) = _mlp_pair(reg=reg)
    assert [l.params.kernel_reg_type.name for l in tm.layers[:2]] == \
        [l.params.kernel_reg_type.name for l in jm.layers[:2]]
    assert tm.layers[0].params.kernel_reg_lambda == \
        jm.layers[0].params.kernel_reg_lambda
    x, y = _data(6, 3 * BATCH)
    for m in (jm, tm):
        m.fit(x, y, epochs=1, verbose=False)
    _assert_params(tm, jm)
    for m in (jm, tm):
        m.set_iteration_batch([x[:BATCH]], y[:BATCH])
        m.backward()
        m.update()
    _assert_params(tm, jm)
    # the penalty moves the weights: without it they differ
    (jm0, _), (tm0, _) = _mlp_pair()
    tm0.fit(x, y, epochs=1, verbose=False)
    assert not np.allclose(tm0.params[tm0.layers[0].name]["kernel"].numpy(),
                           tm.params[tm.layers[0].name]["kernel"].numpy())
    terms = tm.executor._reg_penalty(tm.params)
    assert len(terms) == 2 and all(float(t) > 0 for t in terms)


def test_regularizer_of_the_keras_kind_is_read_like_jax():
    """A regularizer object with `.type` and `._lambda` (the Keras
    frontend's) reads to JAX's (mode, lambda)."""
    from flexflow_tpu.core.model import _to_regularizer as jread
    from flexflow_tpu_torch.core.model import _to_regularizer as tread
    from flexflow_tpu_torch.frontends.keras import regularizers

    for reg in (regularizers.L1(0.3), regularizers.L2(0.7), None, 0.5,
                ("L1", 2.0)):
        tmode, tlam = tread(reg)
        jmode, jlam = jread(reg)
        assert (tmode.name, tlam) == (jmode.name, jlam)


def test_bf16_weights_read_back_as_floats():
    """A weight declared bf16 reads back as f32 numpy values equal to the
    stored bf16 ones, and a write rounds to bf16."""
    tm = FFModel(FFConfig(batch_size=2, device="cpu"))
    x = tm.create_tensor((2, 4))
    tm.dense(x, 3, datatype=DataType.DT_BF16)
    tm.compile(SGDOptimizer(lr=0.0), getattr(LossType, MSE))
    w = tm.layers[0].get_weight_tensor()
    got = w.get_tensor()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got, tm.params[tm.layers[0].name]["kernel"].float().numpy())
    w.set_tensor(tm, np.full((4, 3), 1.0 / 3, np.float32))
    assert tm.params[tm.layers[0].name]["kernel"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.get_tensor(),
        np.full((4, 3), float(torch.tensor(1.0 / 3).bfloat16()), np.float32))
