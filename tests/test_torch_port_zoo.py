"""The rest of the model zoo on flexflow_tpu_torch against the JAX
package's, trained: DLRM, XDL, MLP_Unify, CANDLE-Uno, the MoE classifier
(build_moe), the BERT proxy, Inception-v3's stem with each of its five
block types, a graph with a Cache op, and the MoE Transformer, at the
sizes of tests/test_model_zoo.py and tests/test_workload_zoo.py. Each is
built in both packages, the JAX weights and buffers carried into the
port (runtime/weights.py), then three train steps on the same numpy
batches: each step's loss (the MoE balance loss included) and metric
partials, then every weight and buffer.

f32 on the CPU, where the two differ only in the order of their sums:
losses and partials within rtol 1e-5; weights and buffers after three
steps within rtol 1e-4 and atol 1e-5, as the CNN models' tests hold
them (a few f32 ulps of a gradient carried through three updates). The
MoE routing is compared through its effect: a token routed elsewhere
moves an expert's weights by a whole gradient.
"""
import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as jff
from flexflow_tpu import models as jzoo
from flexflow_tpu.models import inception as jinc
from flexflow_tpu_torch import (ActiMode, AdamOptimizer, DataType, FFConfig,
                                FFModel, SGDOptimizer)
from flexflow_tpu_torch import models as tzoo
from flexflow_tpu_torch.ff_types import LossType, MetricsType
from flexflow_tpu_torch.models import inception as tinc
from flexflow_tpu_torch.parallel.executor import truncate_labels
from flexflow_tpu_torch.runtime.weights import (net_state_from_numpy,
                                                params_from_numpy)

RTOL, W_RTOL, W_ATOL = 1e-5, 1e-4, 1e-5
SPARSE = ("LOSS_SPARSE_CATEGORICAL_CROSSENTROPY", ("METRICS_ACCURACY",))
MSE = ("LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE",
       ("METRICS_MEAN_SQUARED_ERROR",))


def _dlrm(ff, m, b):
    return (jzoo if ff is jff else tzoo).build_dlrm(
        m, b, embedding_sizes=(1000,) * 4)


def _xdl(ff, m, b):
    return (jzoo if ff is jff else tzoo).build_xdl(
        m, b, embedding_sizes=(500,) * 4)


def _mlp_unify(ff, m, b):
    return (jzoo if ff is jff else tzoo).build_mlp_unify(
        m, b, input_dims=(64, 64), hidden_dims=(128, 128))


def _candle_uno(ff, m, b):
    return (jzoo if ff is jff else tzoo).build_candle_uno(
        m, b, feature_shapes=(32, 48), dense_feature_layers=(64,),
        dense_layers=(64, 32))


def _moe(ff, m, b, lambda_bal=0.04):
    return (jzoo if ff is jff else tzoo).build_moe(
        m, b, input_dim=32, num_classes=4, num_exp=4, num_select=2,
        hidden=16, lambda_bal=lambda_bal)


def _bert_proxy(ff, m, b):
    return (jzoo if ff is jff else tzoo).build_bert_proxy(
        m, b, seq_length=16, hidden_size=64, num_heads=4, num_layers=2)


def _moe_transformer(ff, m, b, **kw):
    size = dict(seq_length=64, hidden_size=768, num_heads=4, num_layers=2)
    size.update(kw)
    return (jzoo if ff is jff else tzoo).build_moe_transformer(
        m, b, num_experts=4, top_k=2, capacity_factor=1.2, lambda_bal=0.04,
        **size)


def _inception(block):
    """Inception-v3's stem (its first conv_bn) and one block at 35x35,
    then the pool, flat, dense and softmax head (tests/test_model_zoo.py
    test_inception_tiny, one case per block type)."""
    def build(ff, m, b):
        inc = jinc if ff is jff else tinc
        t = m.create_tensor((b, 3, 35, 35))
        t = inc.conv_bn(m, t, 32, 3, 3, 2, 2)
        args = {"a": (32,), "c": (16,)}.get(block, ())
        t = getattr(inc, f"inception_{block}")(m, t, *args)
        t = m.pool2d(t, t.dims[2], t.dims[3], 1, 1, 0, 0)
        t = m.flat(t)
        t = m.dense(t, 4)
        return None, m.softmax(t)

    return build


def _cache(ff, m, b):
    """dense -> Cache -> dense -> softmax: the Cache op's buffers in
    net_state."""
    t = m.create_tensor((b, 16))
    t = m.dense(t, 16, (jff.ActiMode if ff is jff
                        else ActiMode).AC_MODE_RELU)
    t = m.cache(t, num_batches=2)
    t = m.dense(t, 4)
    return None, m.softmax(t)


def _prelu(ff, m, b):
    """dense -> PReLU -> dense -> softmax: PReLU's slope carried across
    by params_from_numpy and trained."""
    t = m.create_tensor((b, 12))
    t = m.prelu(m.dense(t, 16))
    t = m.dense(t, 4)
    return None, m.softmax(t)


def _np(tree):
    return {op: {n: np.asarray(a, np.float32) for n, a in ws.items()}
            for op, ws in tree.items()}


def _opt(ff, adam):
    if adam:
        return ff.AdamOptimizer(alpha=1e-3)
    return ff.SGDOptimizer(lr=0.01)


def _port(build, batch, loss=SPARSE, adam=False, spd=1, **kw):
    m = FFModel(FFConfig(batch_size=batch, device="cpu",
                         iterations_per_dispatch=spd, **kw))
    build(None, m, batch)
    m.compile(AdamOptimizer(alpha=1e-3) if adam else SGDOptimizer(lr=0.01),
              getattr(LossType, loss[0]),
              [getattr(MetricsType, k) for k in loss[1]])
    return m


def _pair(build, batch, loss=SPARSE, adam=False):
    cfg = jff.FFConfig()
    cfg.batch_size = batch
    cfg.workersPerNode = 1
    jm = jff.FFModel(cfg)
    build(jff, jm, batch)
    jm.compile(_opt(jff, adam), getattr(jff.LossType, loss[0]),
               [getattr(jff.MetricsType, k) for k in loss[1]])
    tm = _port(build, batch, loss, adam)
    params_from_numpy(tm, _np(jm.state.params))
    if jm.state.net_state:
        net_state_from_numpy(tm, _np(jm.state.net_state))
    return jm, tm


def _data(model, n, seed):
    """n samples of every input (ids below the smallest table for int
    inputs) and labels for the model's label tensor."""
    rng = np.random.RandomState(seed)
    xs = []
    for t in model._fit_input_tensors:
        shape = (n,) + t.dims[1:]
        if t.data_type == DataType.DT_INT32:
            xs.append(rng.randint(0, 500, shape).astype(np.int32))
        else:
            xs.append(rng.randn(*shape).astype(np.float32))
    lab = model.get_label_tensor()
    if lab.data_type == DataType.DT_INT32:
        classes = model.executor.logits_pt.material_shape()[-1]
        y = rng.randint(0, classes, (n,) + lab.dims[1:]).astype(np.int32)
    else:
        y = rng.randn(n, *lab.dims[1:]).astype(np.float32)
    return xs, y


def _assert_close(ttree, jtree, what):
    j = _np(jtree)
    assert set(ttree) == set(j), what
    for op, ws in ttree.items():
        assert set(ws) == set(j[op]), f"{what} {op}"
        for n, w in ws.items():
            np.testing.assert_allclose(w.float().numpy(), j[op][n],
                                       rtol=W_RTOL, atol=W_ATOL,
                                       err_msg=f"{what} {op}.{n}")


_MODELS = {
    "dlrm": (_dlrm, 16, SPARSE, False),
    "xdl": (_xdl, 16, SPARSE, False),
    "mlp_unify": (_mlp_unify, 16, SPARSE, False),
    "candle_uno": (_candle_uno, 8, MSE, True),
    "moe": (_moe, 16, SPARSE, False),
    "bert_proxy": (_bert_proxy, 4, MSE, False),
    "cache": (_cache, 8, SPARSE, False),
    "prelu": (_prelu, 8, SPARSE, False),
    **{f"inception_{b}": (_inception(b), 2, SPARSE, False)
       for b in "abcde"},
}


def _three_steps(jm, tm, seed, batch):
    jstep, tstep = jm.executor.build_train_step(), \
        tm.executor.build_train_step()
    jst, tst = jm.state, tm.state
    xs, y = _data(tm, 3 * batch, seed)
    for i in range(3):
        bx = [a[i * batch:(i + 1) * batch] for a in xs]
        by = y[i * batch:(i + 1) * batch]
        jst, jp = jstep(jst, bx, by, jax.random.PRNGKey(0))
        tst, tp = tstep(tst, bx, by)
        assert set(tp) == set(jp)
        for k in tp:
            np.testing.assert_allclose(float(tp[k]), float(jp[k]), rtol=RTOL,
                                       err_msg=f"step {i} {k}")
    return jst, tst


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_three_train_steps_match_jax(name):
    build, batch, loss, adam = _MODELS[name]
    jm, tm = _pair(build, batch, loss, adam)
    jst, tst = _three_steps(jm, tm, 0, batch)
    _assert_close(tst.params, jst.params, name)
    if jst.net_state:
        _assert_close(tst.net_state, jst.net_state, f"{name} buffers")


def test_moe_transformer_three_train_steps_match_jax():
    """tests/test_workload_zoo.py's MoE Transformer size (batch 16, seq
    64, hidden 768, 4 heads, 2 layers; 4 experts, top-2, capacity 1.2,
    lambda_bal 0.04): 2048 (token, choice) pairs, 615 slots per
    expert."""
    jm, tm = _pair(_moe_transformer, 16)
    jst, tst = _three_steps(jm, tm, 1, 16)
    _assert_close(tst.params, jst.params, "moe transformer")


def test_fit_of_the_moe_classifier_matches_jax():
    """`fit` over three batches: the folded accuracy, the last loss (the
    balance loss included) and the weights."""
    jm, tm = _pair(_moe, 16)
    xs, y = _data(tm, 48, 3)
    jpm, tpm = jm.fit(xs, y, epochs=1), tm.fit(xs, y, epochs=1)
    assert tpm.train_all == jpm.train_all == 48
    assert tpm.train_correct == jpm.train_correct
    _assert_close(tm.params, jm.state.params, "moe fit")


def test_moe_lambda_bal_reaches_gradient():
    """tests/test_workload_zoo.py's check on the port: two models with
    the same weights, differing only in lambda_bal, give different
    gradients on the same batch (the balance loss reaches the
    objective)."""
    m0 = _port(lambda ff, m, b: _moe(ff, m, b, 0.0), 8)
    m1 = _port(lambda ff, m, b: _moe(ff, m, b, 5.0), 8)
    for op, ws in m0.params.items():
        for n, w in ws.items():
            assert torch.equal(w, m1.params[op][n])
    xs, y = _data(m0, 8, 7)
    g0, g1 = (m.executor.build_grad_step()(m.params, xs, y)
              for m in (m0, m1))
    diff = max(float((g0[op][n] - g1[op][n]).abs().max())
               for op in g0 for n in g0[op])
    assert diff > 1e-8, "the balance loss never reached the objective"
    gate = "op_linear_0"  # the first dense layer is the gate
    assert not torch.equal(g0[gate]["kernel"], g1[gate]["kernel"])


@pytest.mark.parametrize("lambda_bal", [0.0, 5.0])
def test_moe_gradients_with_lambda_bal_match_jax(lambda_bal):
    build = (lambda ff, m, b: _moe(ff, m, b, lambda_bal))
    jm, tm = _pair(build, 8)
    xs, y = _data(tm, 8, 8)
    jg = jm.executor.build_grad_step()(jm.state.params, xs, y)
    if isinstance(jg, tuple):
        jg = jg[0]
    tg = tm.executor.build_grad_step()(tm.params, xs, y)
    _assert_close(tg, jg, f"grads lambda_bal {lambda_bal}")


def test_stepwise_api_adds_the_balance_loss_like_the_train_step():
    a, b = _port(_moe, 8), _port(_moe, 8)
    xs, y = _data(a, 8, 9)
    a.state, _ = a.executor.build_train_step()(a.state, xs, y)
    b.set_iteration_batch(xs, y)
    b.zero_gradients()
    b.backward()
    b.update()
    for op, ws in a.params.items():
        for n, w in ws.items():
            assert torch.equal(w, b.params[op][n]), f"{op}.{n}"


def _fit_lines(model, xs, y, capsys, epochs=2):
    model.fit(xs, y, epochs=epochs)
    return [ln.split("throughput")[0] for ln in
            capsys.readouterr().out.splitlines() if ln.startswith("epoch")]


@pytest.mark.parametrize("name", ["dlrm", "moe_transformer", "cache"])
def test_scan_equals_stepwise_fit_bit_for_bit(name, capsys):
    """`fit` with iterations_per_dispatch 3 over 7 batches (two chunks and
    a tail) against stepwise `fit`: DLRM (int32 ids beside f32
    features), the MoE Transformer (the balance loss in every step's
    objective) and the Cache graph (its buffers in net_state)."""
    build, batch = {"dlrm": (_dlrm, 4),
                    "moe_transformer": (lambda ff, m, b: _moe_transformer(
                        ff, m, b, seq_length=8, hidden_size=32,
                        num_heads=2), 2),
                    "cache": (_cache, 4)}[name]
    a, b = _port(build, batch), _port(build, batch, spd=3)
    xs, y = _data(a, 7 * batch, 4)
    lines_a = _fit_lines(a, xs, y, capsys)
    lines_b = _fit_lines(b, xs, y, capsys)
    assert lines_a == lines_b and len(lines_a) == 2
    assert a.state.step == b.state.step == 14
    for tree in ("params", "net_state"):
        ta, tb = getattr(a.state, tree), getattr(b.state, tree)
        assert set(ta) == set(tb)
        for op in ta:
            for n in ta[op]:
                assert torch.equal(ta[op][n], tb[op][n]), f"{tree} {op}.{n}"
    if name == "cache":
        (op,) = a.state.net_state
        assert float(a.state.net_state[op]["filled"]) == 1.0


def test_cache_model_evaluates_on_the_cached_value():
    """After training, eval and predict read the cache, not the batch:
    two different batches give the same output rows."""
    m = _port(_cache, 4)
    xs, y = _data(m, 8, 5)
    m.fit(xs, y, epochs=1)
    p1 = m.predict([xs[0][:4]])
    p2 = m.predict([xs[0][4:]])
    np.testing.assert_array_equal(p1, p2)


def test_ops_with_several_outputs_return_lists_through_the_pcg():
    """split, top_k and group_by return lists from their builders, as in
    JAX; the PCG keeps every output, the executor computes each, and the
    graph's output is still the last op's."""
    m = FFModel(FFConfig(batch_size=4, device="cpu"))
    x = m.create_tensor((4, 8))
    halves = m.split(x, 2, axis=1)
    vals, idx = m.top_k(m.dense(halves[0], 4), 2)
    groups = m.group_by(halves[1], idx, 4, 1.0)
    assert len(groups) == 4 and all(g.dims == (2, 4) for g in groups)
    assert idx.data_type == DataType.DT_INT32
    t = m.add(halves[0], halves[1])
    out = m.softmax(m.dense(t, 3))
    m.compile(SGDOptimizer(lr=0.01), LossType.LOSS_CATEGORICAL_CROSSENTROPY)
    graph = m.graph
    assert [len(op.outputs) for op in graph.ops[:4]] == [2, 1, 2, 4]
    assert tuple(m.executor.logits_pt.material_shape()) == out.dims
    vals = m.executor.apply(m.params, m.executor._input_vals(
        [np.ones((4, 8), np.float32)]))
    for op in graph.ops:
        for pt in op.outputs:
            assert tuple(vals[pt.guid].shape) == tuple(pt.material_shape())


def test_truncate_labels_with_a_multi_output_graph():
    m = _port(lambda ff, mm, b: _moe_transformer(
        ff, mm, b, seq_length=8, hidden_size=16, num_heads=2), 2)
    logits = m.executor.build_forward(seq_length=4)(
        m.params, [np.zeros((2, 8, 16), np.float32)])
    assert tuple(logits.shape) == (2, 8, 10)  # no op truncates yet
    labels = torch.zeros(2, 8, 1, dtype=torch.int32)
    assert truncate_labels(labels, logits[:, :5]).shape == (2, 5, 1)


def test_forward_with_seq_length_slices_batch_matmul_like_jax():
    """The stepwise forward(seq_length) reaches batch_matmul's
    a_seq_length_dim (the reference's iteration config), as in JAX."""
    def build(ff, m, b):
        a = m.create_tensor((b, 6, 4))
        w = m.create_tensor((b, 4, 5))
        return None, m.batch_matmul(a, w, a_seq_length_dim=1)

    jm, tm = _pair(build, 2, MSE)
    rng = np.random.RandomState(6)
    xs = [rng.randn(2, 6, 4).astype(np.float32),
          rng.randn(2, 4, 5).astype(np.float32)]
    for seq in (-1, 3):
        jout = np.asarray(jm.executor.build_forward(seq)(jm.state.params,
                                                         xs))
        tout = tm.executor.build_forward(seq)(tm.params, xs).numpy()
        assert tout.shape == jout.shape == (2, 6 if seq < 0 else 3, 5)
        np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=1e-6)
