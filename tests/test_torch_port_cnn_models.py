"""The CNN models of flexflow_tpu_torch against the JAX package's, trained:
AlexNet (models/alexnet.py) at 67x67, ResNet (models/resnet.py) at 32x32
with one block a stage, and a ResNeXt block with 32 groups, each built in
both packages (as tests/test_model_zoo.py builds them), the JAX weights
and BatchNorm running statistics carried into the port
(runtime/weights.py), then the same numpy batches through `fit`, the
train step, eval, predict, the stepwise API and the train scan.

f32 on the CPU, where the two differ only in the order of their sums
(XLA's convolutions against oneDNN's): losses and metrics within rtol
1e-5; weights and running statistics after the steps within rtol 1e-4
and atol 1e-5 (a few f32 ulps of a gradient, carried through up to
three SGD steps and, for the running statistics, through every layer
below). The scan against stepwise `fit` is bit for bit: the same
kernels on the same data.
"""
import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as jff
from flexflow_tpu.models import alexnet as jalex
from flexflow_tpu.models import resnet as jres
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.ff_types import LossType, MetricsType
from flexflow_tpu_torch.models import (build_alexnet, build_resnet,
                                       resnext_block)
from flexflow_tpu_torch.runtime.weights import (net_state_from_numpy,
                                                params_from_numpy)

RTOL, W_RTOL, W_ATOL = 1e-5, 1e-4, 1e-5
SPARSE = "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY"
METRICS = ("METRICS_ACCURACY", "METRICS_SPARSE_CATEGORICAL_CROSSENTROPY")


def _alexnet(ff, m, batch, classes=10):
    (jalex.build_alexnet if ff is jff else build_alexnet)(
        m, batch, num_classes=classes, height=67, width=67)


def _resnet(ff, m, batch, classes=4):
    (jres.build_resnet if ff is jff else build_resnet)(
        m, batch, num_classes=classes, height=32, width=32,
        blocks_per_stage=(1, 1, 1, 1))


def _resnext(ff, m, batch, classes=4):
    block = jres.resnext_block if ff is jff else resnext_block
    t = m.create_tensor((batch, 64, 8, 8))
    t = block(m, t, 1, 64, groups=32, projection=True)
    t = m.flat(t)
    t = m.dense(t, classes)
    m.softmax(t)


def _np(tree):
    return {op: {n: np.asarray(a, np.float32) for n, a in ws.items()}
            for op, ws in tree.items()}


def _port_model(build, batch, spd=1, lr=0.01):
    m = FFModel(FFConfig(batch_size=batch, device="cpu",
                         iterations_per_dispatch=spd))
    build(None, m, batch)
    m.compile(SGDOptimizer(lr=lr), getattr(LossType, SPARSE),
              [getattr(MetricsType, k) for k in METRICS])
    return m


def _pair(build, batch, lr=0.01):
    """The model compiled in both packages, the JAX weights and running
    statistics in the port."""
    cfg = jff.FFConfig()
    cfg.batch_size = batch
    cfg.workersPerNode = 1
    jm = jff.FFModel(cfg)
    build(jff, jm, batch)
    jm.compile(jff.SGDOptimizer(lr=lr), getattr(jff.LossType, SPARSE),
               [getattr(jff.MetricsType, k) for k in METRICS])
    tm = _port_model(build, batch, lr=lr)
    params_from_numpy(tm, _np(jm.state.params))
    net_state_from_numpy(tm, _np(jm.state.net_state))
    return jm, tm


def _data(seed, n, shape, classes):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, *shape).astype(np.float32)
    y = rng.randint(0, classes, (n, 1)).astype(np.int32)
    return x, y


def _assert_close(ttree, jtree, what):
    j = _np(jtree)
    assert set(ttree) == set(j), what
    for op, ws in ttree.items():
        assert set(ws) == set(j[op]), f"{what} {op}"
        for n, w in ws.items():
            np.testing.assert_allclose(w.float().numpy(), j[op][n],
                                       rtol=W_RTOL, atol=W_ATOL,
                                       err_msg=f"{what} {op}.{n}")


def _perf(pm):
    return (pm.train_all, pm.train_correct, pm.sparse_cce_loss)


def test_alexnet_three_train_steps_match_jax():
    """Three train steps at 67x67, batch 8: each step's loss and accuracy
    partials, then the weights."""
    jm, tm = _pair(_alexnet, 8)
    jstep, tstep = jm.executor.build_train_step(), tm.executor.build_train_step()
    jst, tst = jm.state, tm.state
    x, y = _data(0, 24, (3, 67, 67), 10)
    for i in range(3):
        bx, by = x[8 * i:8 * i + 8], y[8 * i:8 * i + 8]
        jst, jp = jstep(jst, [bx], by, jax.random.PRNGKey(0))
        tst, tp = tstep(tst, [bx], by)
        assert set(tp) == set(jp)
        for k in tp:
            np.testing.assert_allclose(float(tp[k]), float(jp[k]), rtol=RTOL,
                                       err_msg=k)
    _assert_close(tst.params, jst.params, "alexnet")


def test_alexnet_fit_matches_jax(capsys):
    """`fit` over three batches (and a dropped tail of 3): the epoch's
    folded accuracy and CE partials and the final weights."""
    jm, tm = _pair(_alexnet, 8)
    x, y = _data(1, 27, (3, 67, 67), 10)
    jpm, tpm = jm.fit(x, y, epochs=1), tm.fit(x, y, epochs=1)
    out = capsys.readouterr().out
    assert out.count("dropping 3 tail samples (dataset 27 % batch 8)") == 2
    assert tpm.train_all == jpm.train_all == 24
    assert tpm.train_correct == jpm.train_correct
    np.testing.assert_allclose(tpm.sparse_cce_loss, jpm.sparse_cce_loss,
                               rtol=RTOL)
    assert tm.state.step == 3
    _assert_close(tm.params, jm.state.params, "alexnet fit")


@pytest.mark.parametrize("build,batch,steps,epochs", [(_resnet, 8, 1, 1),
                                                      (_resnext, 4, 2, 2)],
                         ids=["resnet", "resnext_groups32"])
def test_fit_weights_and_running_stats_match_jax(build, batch, steps,
                                                 epochs):
    """`fit` over `steps` batches for `epochs` epochs: the weights and
    every BatchNorm's running mean and variance, then eval (on the running
    statistics) and predict.

    ResNet at 32x32 reaches its last stage at 1x1, where each BatchNorm
    normalizes over the batch's 8 values alone, and SGD on it is chaotic:
    a 1e-7 relative change of one weight moves the port's own loss at
    the third step by 0.1% and at the fourth by 3%, so the two packages'
    weights part after the first step (1% of the second step's update).
    ResNet is held over one step, the ResNeXt block (8x8) over four. The
    conv biases that feed a BatchNorm have no gradient (BatchNorm takes
    the mean out): each package's is rounding noise, held by the atol."""
    jm, tm = _pair(build, batch)
    shape = (3, 32, 32) if build is _resnet else (64, 8, 8)
    x, y = _data(2, steps * batch, shape, 4)
    jpm, tpm = jm.fit(x, y, epochs=epochs), tm.fit(x, y, epochs=epochs)
    assert _perf(tpm)[:2] == _perf(jpm)[:2]
    np.testing.assert_allclose(tpm.sparse_cce_loss, jpm.sparse_cce_loss,
                               rtol=RTOL)
    assert tm.state.net_state and set(tm.state.net_state) == set(
        jm.state.net_state)
    _assert_close(tm.params, jm.state.params, "params")
    _assert_close(tm.state.net_state, jm.state.net_state, "net_state")
    # the running statistics moved from their (0, 1) start
    rm = next(iter(tm.state.net_state.values()))["running_mean"]
    assert rm.abs().max() > 0
    jev, tev = jm.eval(x, y), tm.eval(x, y)
    np.testing.assert_allclose(tev.sparse_cce_loss, jev.sparse_cce_loss,
                               rtol=RTOL)
    np.testing.assert_allclose(tm.predict(x), np.asarray(jm.predict(x)),
                               rtol=RTOL, atol=1e-6)


def test_eval_reads_the_running_stats():
    """Eval normalizes with the running statistics: moving them moves its
    loss, and the forward with batch statistics (no state) differs."""
    _, tm = _pair(_resnext, 4)
    x, y = _data(3, 4, (64, 8, 8), 4)
    tm.fit(x, y, epochs=3)
    ev = tm.executor.build_eval_step()
    _, with_state = ev(tm.params, [x], y, tm.state.net_state)
    _, batch_stats = ev(tm.params, [x], y)
    assert float(with_state["loss"]) != float(batch_stats["loss"])
    np.testing.assert_allclose(tm.eval(x, y).sparse_cce_loss,
                               float(with_state["loss"]) * 4, rtol=1e-6)
    for bufs in tm.state.net_state.values():
        bufs["running_var"].mul_(4.0)
    _, moved = ev(tm.params, [x], y, tm.state.net_state)
    assert float(moved["loss"]) != float(with_state["loss"])


@pytest.mark.parametrize("build,shape", [(_resnext, (64, 8, 8)),
                                         (_resnet, (3, 32, 32))],
                         ids=["resnext_groups32", "resnet"])
def test_scan_with_batchnorm_equals_stepwise_fit(build, shape, capsys):
    """`fit` with iterations_per_dispatch 3 over 7 batches (two chunks
    and a tail) equals stepwise `fit` bit for bit: the epoch lines, the
    weights and the running statistics."""
    a, b = _port_model(build, 2), _port_model(build, 2, spd=3)
    x, y = _data(4, 14, shape, 4)
    a.fit(x, y, epochs=2)
    lines_a = [ln.split("throughput")[0] for ln in
               capsys.readouterr().out.splitlines() if ln.startswith("epoch")]
    b.fit(x, y, epochs=2)
    lines_b = [ln.split("throughput")[0] for ln in
               capsys.readouterr().out.splitlines() if ln.startswith("epoch")]
    assert lines_a == lines_b and len(lines_a) == 2
    assert a.state.step == b.state.step == 14
    for tree in ("params", "net_state"):
        ta, tb = getattr(a.state, tree), getattr(b.state, tree)
        assert set(ta) == set(tb) and ta
        for op in ta:
            for n in ta[op]:
                assert torch.equal(ta[op][n], tb[op][n]), f"{tree} {op}.{n}"


def test_stepwise_api_threads_running_stats_like_jax():
    """set_iteration_batch / forward / backward / update: the running
    statistics move only at update, to JAX's values, and forward reads
    them."""
    jm, tm = _pair(_resnext, 4)
    x, y = _data(5, 4, (64, 8, 8), 4)
    before = {op: {k: v.clone() for k, v in bufs.items()}
              for op, bufs in tm.state.net_state.items()}
    for m in (jm, tm):
        m.set_iteration_batch([x], y)
        m.forward()
        m.zero_gradients()
        m.backward()
    for op, bufs in tm.state.net_state.items():
        for k, v in bufs.items():
            assert torch.equal(v, before[op][k])
    jm.update()
    tm.update()
    _assert_close(tm.state.net_state, jm.state.net_state, "net_state")
    _assert_close(tm.params, jm.state.params, "params")
    assert tm.state.step == 1
    np.testing.assert_allclose(tm.forward().numpy(),
                               np.asarray(jm.forward()), rtol=RTOL,
                               atol=1e-6)


def test_net_state_from_numpy_checks_names_and_shapes():
    _, tm = _pair(_resnext, 4)
    good = {op: {k: np.full(v.shape, 0.5, np.float32)
                 for k, v in bufs.items()}
            for op, bufs in tm.state.net_state.items()}
    addr = {op: {k: v.data_ptr() for k, v in bufs.items()}
            for op, bufs in tm.state.net_state.items()}
    net_state_from_numpy(tm, good)
    for op, bufs in tm.state.net_state.items():
        for k, v in bufs.items():
            assert v.data_ptr() == addr[op][k]  # in place
            assert torch.equal(v, torch.full_like(v, 0.5))
    op = next(iter(good))
    bad = dict(good, **{op: {"running_mean": good[op]["running_mean"]}})
    with pytest.raises(ValueError, match="running_var"):
        net_state_from_numpy(tm, bad)
    bad = dict(good, **{op: dict(good[op], running_mean=np.zeros(3))})
    with pytest.raises(ValueError, match="shape"):
        net_state_from_numpy(tm, bad)
