"""The stepwise API of flexflow_tpu_torch (`set_iteration_batch`,
`forward(seq_length=-1)`, `zero_gradients`, `backward`, `update`) and the
config surface it brings, against the JAX package, on the CPU.

The flagship Transformer (2 blocks) in both packages, JAX's weights
carried over. f32 on the CPU, tolerances as in the training slice: rtol
1e-5 with atol 1e-6 on logits and weights (the two packages sum the same
products in other orders). Port against port (the stepwise loop against
`fit`'s step) is bit for bit: both run the same ops without dropout.
"""
import inspect

import numpy as np
import pytest
import torch

import flexflow_tpu as jff
from flexflow_tpu.models.transformer import build_transformer as jbuild
from flexflow_tpu.parallel.executor import truncate_labels as jtruncate
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.ff_types import LossType, MetricsType
from flexflow_tpu_torch.models import build_transformer
from flexflow_tpu_torch.parallel.executor import truncate_labels
from flexflow_tpu_torch.runtime.weights import params_from_numpy

BATCH, SEQ, HIDDEN, HEADS, LAYERS = 2, 8, 16, 2, 2
RTOL, ATOL = 1e-5, 1e-6
MSE = "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE"


def _pair():
    cfg = jff.FFConfig()
    cfg.batch_size = BATCH
    cfg.workersPerNode = 1
    jm = jff.FFModel(cfg)
    jbuild(jm, BATCH, SEQ, HIDDEN, HEADS, LAYERS)
    jm.compile(jff.SGDOptimizer(lr=0.05, momentum=0.9),
               getattr(jff.LossType, MSE),
               [jff.MetricsType.METRICS_MEAN_SQUARED_ERROR])
    tm = _port()
    params_from_numpy(tm, _np_params(jm.state.params))
    return jm, tm


def _port():
    tm = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    build_transformer(tm, BATCH, SEQ, HIDDEN, HEADS, LAYERS)
    tm.compile(SGDOptimizer(lr=0.05, momentum=0.9), getattr(LossType, MSE),
               [MetricsType.METRICS_MEAN_SQUARED_ERROR])
    return tm


def _np_params(params):
    return {op: {n: np.asarray(a, np.float32) for n, a in ws.items()}
            for op, ws in params.items()}


def _batches(seed, n=2):
    rng = np.random.RandomState(seed)
    return [(rng.randn(BATCH, SEQ, HIDDEN).astype(np.float32),
             rng.randn(BATCH, SEQ, HIDDEN).astype(np.float32))
            for _ in range(n)]


def _assert_params_close(tparams, jparams):
    j = _np_params(jparams)
    assert set(tparams) == set(j)
    for op, ws in tparams.items():
        for n, w in ws.items():
            np.testing.assert_allclose(w.numpy(), j[op][n], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{op}.{n}")


def test_forward_has_the_jax_signature():
    assert (inspect.signature(FFModel.forward)
            == inspect.signature(jff.FFModel.forward))
    assert (list(inspect.signature(FFModel.backward).parameters)
            == list(inspect.signature(jff.FFModel.backward).parameters))
    for name in ("set_iteration_batch", "zero_gradients", "update"):
        assert (list(inspect.signature(getattr(FFModel, name)).parameters)
                == list(inspect.signature(getattr(jff.FFModel, name))
                        .parameters)), name


def test_stepwise_loop_matches_jax():
    """Two iterations of set_iteration_batch / forward / zero_gradients /
    backward / update in both packages (SGD with momentum): the same
    logits before each update and the same weights after."""
    jm, tm = _pair()
    for x, y in _batches(0):
        for m in (jm, tm):
            m.set_iteration_batch([x], y)
        jo, to = jm.forward(), tm.forward()
        assert to.shape == (BATCH, SEQ, HIDDEN) and to.grad_fn is None
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                                   atol=ATOL)
        for m in (jm, tm):
            m.zero_gradients()
            m.backward()
            m.update()
        _assert_params_close(tm.params, jm.state.params)
    assert tm.state.step == jm.state.step == 2


def test_stepwise_loop_equals_fit_bit_for_bit():
    """Without dropout the stepwise loop is fit's step: the same weights
    after the same batches, to the last bit."""
    a, b = _port(), _port()
    batches = _batches(1, 3)
    for x, y in batches:
        a.set_iteration_batch([x], y)
        a.backward()
        a.update()
    b.fit(np.concatenate([x for x, _ in batches]),
          np.concatenate([y for _, y in batches]), verbose=False)
    assert a.state.step == b.state.step == 3
    for op, ws in a.params.items():
        for n, w in ws.items():
            assert torch.equal(w, b.params[op][n]), f"{op}.{n}"


def test_forward_and_backward_take_seq_length_like_jax():
    """seq_length reaches the ops' context (no ported op truncates, as
    none of the Transformer's does in JAX): forward(seq_length) and the
    gradients of backward(seq_length) match JAX's."""
    jm, tm = _pair()
    (x, y), = _batches(2, 1)
    for m in (jm, tm):
        m.set_iteration_batch([x], y)
    np.testing.assert_allclose(tm.forward(seq_length=4).numpy(),
                               np.asarray(jm.forward(seq_length=4)),
                               rtol=RTOL, atol=ATOL)
    tm.backward(seq_length=4)
    jm.backward(seq_length=4)
    _assert_params_close(tm._pending_grads, jm._pending_grads)


@pytest.mark.parametrize("labels_shape,logits_shape", [
    ((2, 8, 16), (2, 4, 16)), ((2, 8, 1), (2, 4, 10)), ((2, 8), (2, 4, 10)),
    ((2, 8, 16), (2, 8, 16))])
def test_truncate_labels_is_jax_truncate_labels(labels_shape, logits_shape):
    labels = np.arange(np.prod(labels_shape), dtype=np.float32) \
        .reshape(labels_shape)
    logits = np.zeros(logits_shape, np.float32)
    want = np.asarray(jtruncate(labels, logits))
    got = truncate_labels(torch.from_numpy(labels), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def test_stepwise_calls_out_of_order_raise():
    m = _port()
    with pytest.raises(RuntimeError, match="set_iteration_batch"):
        m.forward()
    with pytest.raises(RuntimeError, match="backward"):
        m.update()
    (x, _), = _batches(3, 1)
    m.set_iteration_batch([x], None)
    assert m.forward().shape == (BATCH, SEQ, HIDDEN)
    with pytest.raises(ValueError, match="label"):
        m.backward()
    m.set_iteration_batch([None], x)
    with pytest.raises(ValueError, match="never attached"):
        m.forward()


def test_config_rejects_unported_fields_and_carries_the_new_ones():
    """FFConfig has slots: a JAX field the port does not read raises
    instead of being dropped; iterations_per_dispatch and remat carry
    JAX's names and defaults and reach fit and the executor."""
    cfg = FFConfig(device="cpu")
    jcfg = jff.FFConfig()
    for name in ("iterations_per_dispatch", "remat"):
        assert getattr(cfg, name) == getattr(jcfg, name)
        setattr(cfg, name, getattr(cfg, name))
    for name in ("pipeline_parallelism_degree", "anything"):
        with pytest.raises(AttributeError):
            setattr(cfg, name, 2)
    # the overlapped gradient sync is a field, on by default as JAX's
    for name in ("overlap_backward_update",
                 "search_overlap_backward_update"):
        assert getattr(cfg, name) == getattr(jcfg, name)
    assert FFConfig(device="cpu").overlap_backward_update is True
    # the parallel degrees are fields (JAX's names and defaults)
    for name in ("tensor_parallel_degree", "fsdp_degree",
                 "pipeline_parallel_degree"):
        assert getattr(cfg, name) == getattr(jcfg, name) == 1
    cfg.remat = True
    cfg.iterations_per_dispatch = 4
    m = FFModel(cfg)
    build_transformer(m, BATCH, SEQ, HIDDEN, HEADS, 1)
    m.compile(SGDOptimizer(), getattr(LossType, MSE))
    assert m.executor.remat
