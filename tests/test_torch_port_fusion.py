"""--fusion on flexflow_tpu_torch against the JAX package's: `apply_fusion`
packs the same chains into OP_FUSED nodes with the same names, op types,
chain steps, weight names, tags and initializers, on
tests/test_regressions.py's model and on the small flagship Transformer;
a fused model trains as the unfused one does bit for bit (stepwise and
as a scan), and as JAX's fused model within tolerance; its softmax tail
still reads as probabilities; JAX's fused weights carry across as they
are; and decoding a fused graph raises DecodeExactnessError at the same
op as JAX's decode.

f32 on the CPU: losses and partials within rtol 1e-5 of JAX's, weights
after three steps within rtol 1e-4, atol 1e-5 (the sums' orders); fused
against unfused in the port, bit for bit (the same forwards run).
"""
import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as jff
from flexflow_tpu.models.transformer import build_transformer as jbuild_tf
from flexflow_tpu.parallel.decode import DecodeExactnessError as JDecodeError
from flexflow_tpu_torch import ActiMode, FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.ff_types import (AggrMode, DataType, LossType,
                                         MetricsType, OperatorType)
from flexflow_tpu_torch.models import build_transformer
from flexflow_tpu_torch.parallel.decode import DecodeExactnessError
from flexflow_tpu_torch.runtime.weights import params_from_numpy

RTOL, W_RTOL, W_ATOL = 1e-5, 1e-4, 1e-5
B = 4


def _enums(ff):
    """(ActiMode, DataType, AggrMode) of the JAX package or the port."""
    if ff is jff:
        return jff.ActiMode, jff.DataType, jff.AggrMode
    return ActiMode, DataType, AggrMode


def _regressions_model(ff, m):
    """tests/test_regressions.py test_fusion_pass_trains's chain."""
    acti, dt, _ = _enums(ff)
    t = m.dense(m.create_tensor((B, 8), dt.DT_FLOAT), 32, acti.AC_MODE_RELU)
    t = m.relu(t)
    t = m.scalar_multiply(t, 0.5)
    t = m.dense(t, 4)
    return m.softmax(t)


def _flagship(ff, m):
    (jbuild_tf if ff is jff else build_transformer)(m, B, 8, 16, 2, 2)


_MODELS = {
    "regressions": (_regressions_model, "sparse"),
    "flagship": (_flagship, "mse"),
}


def _loss(ff, kind):
    lt = (jff.LossType if ff is jff else LossType)
    mt = (jff.MetricsType if ff is jff else MetricsType)
    if kind == "sparse":
        return (lt.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                [mt.METRICS_ACCURACY])
    return (lt.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
            [mt.METRICS_MEAN_SQUARED_ERROR])


def _jax(name, fusion):
    build, kind = _MODELS[name]
    cfg = jff.FFConfig()
    cfg.batch_size = B
    cfg.workersPerNode = 1
    cfg.perform_fusion = fusion
    m = jff.FFModel(cfg)
    build(jff, m)
    m.compile(jff.SGDOptimizer(lr=0.05), *_loss(jff, kind))
    return m


def _port(name, fusion, spd=1):
    build, kind = _MODELS[name]
    m = FFModel(FFConfig(batch_size=B, device="cpu", perform_fusion=fusion,
                         iterations_per_dispatch=spd))
    build(None, m)
    m.compile(SGDOptimizer(lr=0.05), *_loss(None, kind))
    return m


def _graph(m):
    """Each op's name and type; a fused op's chain steps (type, params,
    input slots) and output slots; its weight names, tags and
    initializers."""
    out = []
    for op in m.graph.ops:
        row = [op.name, op.op_type.name, list(op.weight_names),
               [tuple(t) for t in op.weight_tags],
               [op.initializers.get(n, "glorot_uniform")
                for n in op.weight_names]]
        if op.op_type.name == "OP_FUSED":
            row.append([(t.name, {k: getattr(v, "name", v)
                                  for k, v in vars(p).items()
                                  if not k.startswith("kernel_reg")},
                         slots)
                        for t, p, slots in op.params.chain])
            row.append((op.params.num_inputs, op.params.output_slots))
        out.append(row)
    return out


def _np(params):
    return {op: {n: np.asarray(a) for n, a in ws.items()}
            for op, ws in params.items()}


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_apply_fusion_packs_the_chains_jax_packs(name):
    jm, tm = _jax(name, True), _port(name, True)
    assert _graph(tm) == _graph(jm)
    fused = [op for op in tm.graph.ops if op.op_type == OperatorType.OP_FUSED]
    assert fused and len(tm.graph.ops) < len(tm.layers)
    # the same weights: JAX's fused params carry over in its flat layout
    params_from_numpy(tm, _np(jm.state.params))


def test_flagship_fuses_each_block_mlp():
    """Each block's two dense layers form one chain (attention is not
    fusable): one fused op a block."""
    tm = _port("flagship", True)
    assert [op.op_type.name for op in tm.graph.ops] == \
        ["OP_MULTIHEAD_ATTENTION", "OP_FUSED"] * 2
    assert tm.graph.ops[1].name == "fused_op_linear_1__op_linear_2"
    assert tm.graph.ops[1].weight_names == ["step0/kernel", "step1/kernel"]


def _mapped(fused, unfused):
    """The unfused model's weights under the fused model's names."""
    out = {}
    for op in fused.executor.topo:
        chain = getattr(op, "fused_from", None)
        if chain is None:
            out[op.name] = unfused.params.get(op.name, {})
            continue
        out[op.name] = {f"step{i}/{n}": w for i, name in enumerate(chain)
                        for n, w in unfused.params.get(name, {}).items()}
    return {op: ws for op, ws in out.items() if ws}


def _data(m, n, seed, kind):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, *m._fit_input_tensors[0].dims[1:]).astype(np.float32)
    lab = m.get_label_tensor()
    if kind == "sparse":
        y = rng.randint(0, 4, (n,) + lab.dims[1:]).astype(np.int32)
    else:
        y = rng.randn(n, *lab.dims[1:]).astype(np.float32)
    return x, y


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_fused_training_is_unfused_bit_for_bit(name):
    """From the same weights (the same seed draws them in the same order:
    a fused op's weights are its chain's, in order), `fit` of the fused
    model, stepwise and as a scan of 2 over 5 batches, equals the unfused
    model's: the same epoch metrics and every weight bit for bit."""
    kind = _MODELS[name][1]
    ref = _port(name, False)
    runs = [_port(name, True), _port(name, True, spd=2)]
    for m in runs:
        mapped = _mapped(m, ref)
        assert mapped.keys() == m.params.keys()
        for op, ws in mapped.items():
            assert ws.keys() == m.params[op].keys()
            assert all(torch.equal(m.params[op][n], w) for n, w in ws.items())
    x, y = _data(ref, 5 * B, 0, kind)
    pr = ref.fit(x, y, epochs=2, verbose=False)
    for m in runs:
        pm = m.fit(x, y, epochs=2, verbose=False)
        assert vars(pm).keys() == vars(pr).keys()
        for k, v in vars(pr).items():
            if k != "start_time":
                assert getattr(pm, k) == v, k
        for op, ws in _mapped(m, ref).items():
            for n, w in ws.items():
                assert torch.equal(m.params[op][n], w), f"{op}.{n}"


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_fused_training_matches_jax_fused(name):
    kind = _MODELS[name][1]
    jm, tm = _jax(name, True), _port(name, True)
    params_from_numpy(tm, _np(jm.state.params))
    x, y = _data(tm, 3 * B, 1, kind)
    jstep, tstep = jm.executor.build_train_step(), \
        tm.executor.build_train_step()
    jst, tst = jm.state, tm.state
    for i in range(3):
        bx, by = [x[i * B:(i + 1) * B]], y[i * B:(i + 1) * B]
        jst, jp = jstep(jst, bx, by, jax.random.PRNGKey(0))
        tst, tp = tstep(tst, bx, by)
        for k in tp:
            np.testing.assert_allclose(float(tp[k]), float(jp[k]), rtol=RTOL,
                                       err_msg=f"step {i} {k}")
    for op, ws in tst.params.items():
        for n, w in ws.items():
            np.testing.assert_allclose(w.numpy(),
                                       np.asarray(jst.params[op][n]),
                                       rtol=W_RTOL, atol=W_ATOL,
                                       err_msg=f"{op}.{n}")


def test_a_fused_softmax_tail_reads_as_probabilities(recwarn):
    """The regressions model's tail (dense -> softmax) is inside a fused
    op: both packages still see a probability output and do not warn
    about the cross-entropy loss; a model ending in raw logits warns in
    both."""
    jm, tm = _jax("regressions", True), _port("regressions", True)
    assert tm.graph.ops[-1].op_type == OperatorType.OP_FUSED
    assert jm.output_probability_like() is True
    assert not [w for w in recwarn if "cross-entropy" in str(w.message)]
    for fusion in (False, True):
        m = FFModel(FFConfig(batch_size=B, device="cpu",
                             perform_fusion=fusion))
        m.dense(m.relu(m.dense(m.create_tensor((B, 8)), 16)), 4)
        with pytest.warns(UserWarning, match="cross-entropy"):
            m.compile(SGDOptimizer(), *_loss(None, "sparse"))


def test_jax_fused_weights_carry_as_they_are():
    """params_from_numpy takes JAX's fused params (flat `step<i>/<name>`
    keys under `fused_<first>__<last>`) and refuses the unfused names."""
    jm, tm = _jax("regressions", True), _port("regressions", True)
    params_from_numpy(tm, _np(jm.state.params))
    for op, ws in jm.state.params.items():
        for n, a in ws.items():
            assert np.array_equal(tm.params[op][n].numpy(), np.asarray(a))
    unfused = _np(_jax("regressions", False).state.params)
    with pytest.raises(ValueError, match="op names differ"):
        params_from_numpy(tm, unfused)


VOCAB, HIDDEN, HEADS = 16, 8, 2


def _lm(ff, m):
    """The served LM's block (tests/test_torch_port_slice.py): embedding,
    causal MHA, dense RELU, dense, the vocabulary projection, softmax."""
    acti, dt, aggr = _enums(ff)
    ids = m.create_tensor((2, 6), dt.DT_INT32)
    t = m.embedding(ids, VOCAB, HIDDEN, aggr.AGGR_MODE_NONE)
    t = m.multihead_attention(t, t, t, HIDDEN, HEADS, causal=True)
    t = m.dense(t, HIDDEN, acti.AC_MODE_RELU, use_bias=False)
    t = m.dense(t, HIDDEN, use_bias=False)
    return m.softmax(m.dense(t, VOCAB))


@pytest.mark.parametrize("fusion", [False, True])
def test_decoding_a_fused_graph_does_what_jax_does(fusion):
    """Unfused, both build the decode step; fused, both raise
    DecodeExactnessError at the first fused op (it has no decode rule)."""
    cfg = jff.FFConfig()
    cfg.batch_size = 2
    cfg.workersPerNode = 1
    cfg.perform_fusion = fusion
    jm = jff.FFModel(cfg)
    _lm(jff, jm)
    jm.compile(jff.SGDOptimizer(),
               jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY, [])
    tm = FFModel(FFConfig(batch_size=2, device="cpu", perform_fusion=fusion))
    _lm(None, tm)
    tm.compile(SGDOptimizer(), LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    if not fusion:
        jm.executor.build_decode(2, 6)
        tm.executor.build_decode(2, 6)
        return
    with pytest.raises(JDecodeError) as jerr:
        jm.executor.build_decode(2, 6)
    with pytest.raises(DecodeExactnessError) as terr:
        tm.executor.build_decode(2, 6)
    first = next(op.name for op in tm.executor.topo
                 if op.op_type == OperatorType.OP_FUSED)
    assert str(terr.value).startswith(f"{first} (OP_FUSED)")
    assert str(jerr.value).startswith(f"{first} (OP_FUSED)")
