"""The training slice of flexflow_tpu_torch against the JAX package: the
flagship Transformer (models/transformer.py) built small in both packages
(batch 2, seq 16, hidden 32, 4 heads, 2 blocks), the JAX weights carried
into the port by params_from_numpy, then the same numpy batches through
both packages' gradient step, train steps, losses, metrics, fit and eval.

f32 on the CPU, where both take the dense attention path. Tolerance
rtol 1e-5 with atol 1e-6 on weights and 1e-7 on gradients: the two
packages compute the same products but sum them in other orders (XLA's
fused einsums against torch's), which moves each result by a few f32 ulps
(the worst gradient reading is 1.3e-7 absolute on gradients up to 0.45,
the worst weight after three Adam steps 2e-6 on weights of ~0.3). Also:
the dropout and impl guards, the params dict that training and serving
share, bf16 gradients under mixed precision, and the package boundary.
"""
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as jff
from flexflow_tpu.core import losses as jlosses
from flexflow_tpu.core import metrics as jmetrics
from flexflow_tpu.models.transformer import build_transformer as jbuild
from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel,
                                SGDOptimizer)
from flexflow_tpu_torch.core import losses as tlosses
from flexflow_tpu_torch.core import metrics as tmetrics
from flexflow_tpu_torch.ff_types import LossType, MetricsType
from flexflow_tpu_torch.models import build_transformer
from flexflow_tpu_torch.runtime.weights import params_from_numpy

BATCH, SEQ, HIDDEN, HEADS, LAYERS = 2, 16, 32, 4, 2
RTOL, ATOL, GRAD_ATOL = 1e-5, 1e-6, 1e-7
MSE = "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE"
PORT_DIR = pathlib.Path(__file__).resolve().parent.parent / "flexflow_tpu_torch"


def _pair(jopt=None, topt=None, mixed=False, metrics=("METRICS_MEAN_SQUARED_ERROR",)):
    """The Transformer compiled in both packages with the JAX weights in
    the port."""
    cfg = jff.FFConfig()
    cfg.batch_size = BATCH
    cfg.workersPerNode = 1
    cfg.allow_mixed_precision = mixed
    jm = jff.FFModel(cfg)
    jbuild(jm, BATCH, SEQ, HIDDEN, HEADS, LAYERS)
    jm.compile(jopt or jff.SGDOptimizer(lr=0.01), getattr(jff.LossType, MSE),
               [getattr(jff.MetricsType, m) for m in metrics])
    tm = FFModel(FFConfig(batch_size=BATCH, device="cpu",
                          allow_mixed_precision=mixed))
    build_transformer(tm, BATCH, SEQ, HIDDEN, HEADS, LAYERS)
    tm.compile(topt or SGDOptimizer(lr=0.01), getattr(LossType, MSE),
               [getattr(MetricsType, m) for m in metrics])
    params_from_numpy(tm, _np_params(jm.state.params))
    return jm, tm


def _np_params(params):
    return {op: {n: np.asarray(a, np.float32) for n, a in ws.items()}
            for op, ws in params.items()}


def _batches(seed, n=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(BATCH, SEQ, HIDDEN).astype(np.float32),
             rng.randn(BATCH, SEQ, HIDDEN).astype(np.float32))
            for _ in range(n)]


def _assert_params_close(tparams, jparams, **tol):
    j = _np_params(jparams)
    assert set(tparams) == set(j)
    for op, ws in tparams.items():
        for n, w in ws.items():
            np.testing.assert_allclose(w.float().numpy(), j[op][n],
                                       err_msg=f"{op}.{n}", **tol)


@pytest.fixture(scope="module")
def sgd_pair():
    return _pair()


def test_grad_step_matches_jax_per_weight(sgd_pair):
    jm, tm = sgd_pair
    (x, y), = _batches(0, 1)
    jg, _ = jm.executor.build_grad_step()(jm.state.params, [x], y)
    tg = tm.executor.build_grad_step()(tm.params, [x], y)
    _assert_params_close(tg, jg, rtol=RTOL, atol=GRAD_ATOL)
    # every weight gets a nonzero gradient (bias_o starts at zero)
    assert all(g.abs().max() > 0 for gs in tg.values() for g in gs.values())


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "sgd_nesterov",
                                  "adam"])
def test_three_train_steps_match_jax(name):
    kw = {"sgd": {}, "sgd_momentum": {"momentum": 0.9, "weight_decay": 1e-3},
          "sgd_nesterov": {"momentum": 0.9, "nesterov": True}}
    if name == "adam":
        jopt = jff.AdamOptimizer(alpha=1e-3, weight_decay=1e-3)
        topt = AdamOptimizer(alpha=1e-3, weight_decay=1e-3)
    else:
        jopt = jff.SGDOptimizer(lr=0.01, **kw[name])
        topt = SGDOptimizer(lr=0.01, **kw[name])
    jm, tm = _pair(jopt, topt)
    jstep, tstep = jm.executor.build_train_step(), tm.executor.build_train_step()
    jst, tst = jm.state, tm.state
    for x, y in _batches(1):
        jst, jp = jstep(jst, [x], y, jax.random.PRNGKey(0))
        tst, tp = tstep(tst, [x], y)
        np.testing.assert_allclose(float(tp["loss"]), float(jp["loss"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tp["mse_loss"]),
                                   float(jp["mse_loss"]), rtol=RTOL)
    assert tst.step == 3
    _assert_params_close(tst.params, jst.params, rtol=RTOL, atol=ATOL)
    # the weights did move, and in place: the model's dict is the state's
    moved = _np_params(jm.executor.init_params())
    assert any(not np.allclose(w.numpy(), moved[op][n])
               for op, ws in tst.params.items() for n, w in ws.items())
    assert tm.params is tst.params


@pytest.mark.parametrize("loss", list(LossType))
def test_losses_and_their_gradients_match_jax(loss):
    rng = np.random.RandomState(2)
    probs = rng.dirichlet(np.ones(5), size=(3, 4)).astype(np.float32)
    if loss == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
        labels = rng.randint(0, 5, (3, 4, 1)).astype(np.int32)
    elif loss == LossType.LOSS_CATEGORICAL_CROSSENTROPY:
        labels = np.eye(5, dtype=np.float32)[rng.randint(0, 5, (3, 4))]
    else:
        labels = rng.randn(3, 4, 5).astype(np.float32)
    jfn = jlosses.get_loss_fn(getattr(jff.LossType, loss.name))
    tfn = tlosses.get_loss_fn(loss)
    jv, jg = jax.value_and_grad(jfn)(probs, labels)
    p = torch.from_numpy(probs).requires_grad_()
    tv = tfn(p, torch.from_numpy(labels))
    (tg,) = torch.autograd.grad(tv, p)
    assert tv.dtype == torch.float32
    np.testing.assert_allclose(tv.item(), float(jv), rtol=RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=1e-7)
    assert tlosses.to_loss_type("mse") == \
        LossType[jlosses.to_loss_type("mse").name]


@pytest.mark.parametrize("labels_kind", ["one_hot", "sparse"])
def test_metrics_match_jax(labels_kind):
    rng = np.random.RandomState(3)
    probs = rng.dirichlet(np.ones(6), size=(2, 5)).astype(np.float32)
    ids = rng.randint(0, 6, (2, 5, 1)).astype(np.int32)
    if labels_kind == "sparse":
        labels, names = ids, ["accuracy", "sparse_categorical_crossentropy"]
    else:
        labels = np.eye(6, dtype=np.float32)[ids[..., 0]]
        names = ["accuracy", "categorical_crossentropy", "mean_squared_error",
                 "root_mean_squared_error", "mean_absolute_error"]
    loss = "LOSS_CATEGORICAL_CROSSENTROPY"
    jp = jmetrics.Metrics(getattr(jff.LossType, loss), names).compute(
        probs, labels)
    tp = tmetrics.Metrics(getattr(LossType, loss), names).compute(
        torch.from_numpy(probs), torch.from_numpy(labels))
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k].item(), float(jp[k]), rtol=RTOL,
                                   err_msg=k)
    jpm, tpm = jmetrics.PerfMetrics(), tmetrics.PerfMetrics()
    jpm.update({k: float(v) for k, v in jp.items()})
    tpm.update({k: float(v) for k, v in tp.items()})
    strip = lambda s: s.split("samples/s")[1]  # noqa: E731 (throughput is timing)
    assert strip(tpm.report()) == strip(jpm.report())


def test_fit_epoch_partials_and_eval_match_jax(capsys):
    """Two epochs over 5 samples at batch 2: the tail sample is dropped
    with the same warning, and each epoch's folded partials agree."""
    jm, tm = _pair()
    rng = np.random.RandomState(4)
    x = rng.randn(5, SEQ, HIDDEN).astype(np.float32)
    y = rng.randn(5, SEQ, HIDDEN).astype(np.float32)
    jpm = jm.fit(x, y, epochs=2)
    tpm = tm.fit(x, y, epochs=2)
    out = capsys.readouterr().out
    assert out.count("dropping 1 tail samples (dataset 5 % batch 2)") == 2
    assert out.count("ELAPSED TIME = ") == 2 and "THROUGHPUT = " in out
    assert out.count("epoch 1: loss=") == 2
    assert (tpm.train_all, tpm.train_rows) == (jpm.train_all,
                                               jpm.train_rows) == (4, 64)
    np.testing.assert_allclose(tpm.mse_loss, jpm.mse_loss, rtol=RTOL)
    assert tm.state.step == 4
    _assert_params_close(tm.params, jm.state.params, rtol=RTOL, atol=ATOL)
    jev, tev = jm.eval(x, y), tm.eval(x, y)
    np.testing.assert_allclose(tev.mse_loss, jev.mse_loss, rtol=RTOL)
    assert tev.train_all == jev.train_all == 4


def test_mixed_precision_grads_are_bf16_like_jax():
    """Under mixed precision JAX rounds every gradient to bf16 before the
    update (_cast_grads); the port's do too. Their values agree within
    four bf16 steps (rtol 2^-5) plus 2^-8 of the weight's largest
    gradient: the bf16 products round at other places in the two
    frameworks (XLA keeps f32 between fused einsums, torch rounds each
    einsum's output), which moves an element by up to 1.2% of its weight's
    largest gradient (the worst reading, a bias_o)."""
    jm, tm = _pair(mixed=True)
    (x, y), = _batches(5, 1)
    jg, _ = jm.executor.build_grad_step()(jm.state.params, [x], y)
    tg = tm.executor.build_grad_step()(tm.params, [x], y)
    for op, gs in tg.items():
        for n, g in gs.items():
            assert g.dtype == torch.bfloat16 and jg[op][n].dtype == "bfloat16"
            j = np.asarray(jg[op][n], np.float32)
            np.testing.assert_allclose(
                g.float().numpy(), j, rtol=2.0 ** -5,
                atol=2.0 ** -8 * np.abs(j).max(), err_msg=f"{op}.{n}")
    # the weights stay f32 masters
    assert all(w.dtype == torch.float32 for ws in tm.params.values()
               for w in ws.values())


def _mha_model(dropout):
    m = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    x = m.create_tensor((BATCH, SEQ, HIDDEN))
    t = m.multihead_attention(x, x, x, HIDDEN, HEADS, dropout=dropout)
    m.dense(t, HIDDEN)
    m.compile(SGDOptimizer(), LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    return m


def test_training_with_dropout_raises_where_jax_would_apply_it():
    m = _mha_model(0.1)
    (x, y), = _batches(6, 1)
    with pytest.raises(NotImplementedError, match="dropout hash"):
        m.fit(x, y, verbose=False)
    with pytest.raises(NotImplementedError, match="dropout hash"):
        m.executor.build_train_step()(m.state, [x], y, torch.Generator())
    # JAX applies no dropout without an rng (its gradient step passes
    # none) or outside training: both run
    m.executor.build_grad_step()(m.params, [x], y)
    assert torch.isfinite(m.forward([x])).all()
    m.eval(x, y)


def test_attention_impl_env(monkeypatch):
    """FF_ATTENTION_IMPL as in JAX: unknown values raise ValueError, the
    unported streaming kernels NotImplementedError; "flash" runs the
    folded path through the flash autograd Function (on the CPU its plain
    versions) and gives the dense path's gradients."""
    m = _mha_model(0.0)
    (x, y), = _batches(7, 1)
    grad = m.executor.build_grad_step()
    monkeypatch.setenv("FF_ATTENTION_IMPL", "bogus")
    with pytest.raises(ValueError, match="FF_ATTENTION_IMPL"):
        m.forward([x])
    for impl in ("chunked", "ring", "ulysses"):
        monkeypatch.setenv("FF_ATTENTION_IMPL", impl)
        with pytest.raises(NotImplementedError):
            grad(m.params, [x], y)
    monkeypatch.setenv("FF_ATTENTION_IMPL", "dense")
    dense = grad(m.params, [x], y)
    monkeypatch.setenv("FF_ATTENTION_IMPL", "flash")
    flash = grad(m.params, [x], y)
    _assert_params_close(flash, dense, rtol=RTOL, atol=GRAD_ATOL)


def test_apply_is_differentiable_and_serving_records_no_graph():
    m = _mha_model(0.0)
    (x, _), = _batches(8, 1)
    ex = m.executor
    leaves = {op: {n: w.detach().requires_grad_() for n, w in ws.items()}
              for op, ws in m.params.items()}
    out = ex.apply(leaves, ex._input_vals([x]), training=True)[
        ex.logits_pt.guid]
    assert out.grad_fn is not None
    served = m.forward([x])
    assert served.grad_fn is None and served.is_inference()
    assert not any(w.requires_grad for ws in m.params.values()
                   for w in ws.values())
    torch.testing.assert_close(served, out.detach(), rtol=0, atol=0)


def test_model_served_after_fit_serves_the_trained_weights():
    m = _mha_model(0.0)
    (x, y), = _batches(9, 1)
    assert m.state.params is m.params
    before = {op: {n: w.clone() for n, w in ws.items()}
              for op, ws in m.params.items()}
    out0 = m.forward([x])
    m.fit(x, y, epochs=2, verbose=False)
    assert m.state.params is m.params and m.state.step == 2
    out1 = m.forward([x])
    assert not torch.equal(out0, out1)
    # the served output is the forward of the trained weights, and of no
    # stale copy: restoring the old weights restores the old output
    torch.testing.assert_close(
        m.executor.build_forward()(m.state.params, [x]), out1, rtol=0, atol=0)
    params_from_numpy(m, _np_params(before))
    torch.testing.assert_close(m.forward([x]), out0, rtol=0, atol=0)


def test_fit_needs_a_loss():
    m = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    m.dense(m.create_tensor((BATCH, 4)), 3)
    m.compile()
    with pytest.raises(RuntimeError, match="loss_type"):
        m.fit(np.zeros((BATCH, 4), np.float32), np.zeros((BATCH, 3), np.float32))
    with pytest.raises(TypeError):
        m.fit(np.zeros((BATCH, 4), np.float32),
              np.zeros((BATCH, 3), np.float32), checkpoint_dir="x")


def test_training_modules_import_no_jax():
    code = ("import sys, flexflow_tpu_torch, flexflow_tpu_torch.models,"
            " flexflow_tpu_torch.core.losses, flexflow_tpu_torch.core.metrics,"
            " flexflow_tpu_torch.core.optimizers,"
            " flexflow_tpu_torch.parallel.executor;"
            " bad = sorted(m for m in sys.modules if m == 'jax'"
            " or m.startswith(('jax.', 'flexflow_tpu.')) or m == 'flexflow_tpu');"
            " print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=PORT_DIR.parent, timeout=120, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
