"""flexflow_tpu_torch's PyTorch frontend against the JAX package's.

A small BERT encoder (flexflow_tpu_torch/models/bert.py: 2 post-LN layers,
hidden 64, 4 heads, FFN 256) as a plain torch.nn.Module is imported into
both packages with `PyTorchModel(module).torch_to_ff`; the JAX weights are
carried into the port with `params_from_numpy`. Then the same numpy batch
(batch 2, seq 16) goes through both: the eval forward, and one training
step with attention dropout 0.1 under the same two seeds in both packages
(`dropout_seeds` monkeypatched) and hidden dropout 0. The new ops
(LayerNorm, the unary table with GELU's tanh approximation, the scalar
ops, broadcasting binary ops) are also held against JAX op by op. f32 on
the CPU: the two differ only in the order of their sums, atol 1e-5; the
gradient comparison adds rtol 1e-5 (gradients reach ~1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import flexflow_tpu as jff
from flexflow_tpu.frontends.torch import PyTorchModel as JPyTorchModel
from flexflow_tpu.kernels import attention as jka
from flexflow_tpu.ops import elementwise as jew
from flexflow_tpu.ops import normalization as jnorm
from flexflow_tpu.ops.registry import FwdCtx as JCtx
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.ff_types import DataType, LossType, OperatorType
from flexflow_tpu_torch.frontends.torch import PyTorchModel
from flexflow_tpu_torch.kernels import attention as tka
from flexflow_tpu_torch.models import BertEncoder
from flexflow_tpu_torch.ops import elementwise as tew
from flexflow_tpu_torch.ops import normalization as tnorm
from flexflow_tpu_torch.ops.registry import FwdCtx as TCtx
from flexflow_tpu_torch.runtime.weights import params_from_numpy

BATCH, SEQ, HIDDEN, HEADS, FFN, LAYERS = 2, 16, 64, 4, 256, 2
ATOL = 1e-5
MSE = "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE"
SEEDS = (0x2545F491, 0x6C078965)


def _bert(attention_dropout=0.1, hidden_dropout=0.1):
    torch.manual_seed(0)
    return BertEncoder(LAYERS, HIDDEN, HEADS, FFN, attention_dropout,
                       hidden_dropout)


def _np_params(params):
    return {op: {n: np.array(a, np.float32) for n, a in ws.items()}
            for op, ws in params.items()}


def _pair(module):
    """The module imported into both packages and compiled (MSE, SGD);
    the JAX weights carried into the port."""
    cfg = jff.FFConfig()
    cfg.batch_size = BATCH
    cfg.workersPerNode = 1
    jm = jff.FFModel(cfg)
    jx = jm.create_tensor((BATCH, SEQ, HIDDEN), jff.DataType.DT_FLOAT)
    jpt = JPyTorchModel(module)
    (jout,) = jpt.torch_to_ff(jm, [jx])
    jm.compile(jff.SGDOptimizer(lr=0.01), getattr(jff.LossType, MSE), [])
    tm = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    tpt = PyTorchModel(module)
    (tout,) = tpt.torch_to_ff(tm, [tm.create_tensor((BATCH, SEQ, HIDDEN))])
    tm.compile(SGDOptimizer(lr=0.01), getattr(LossType, MSE))
    assert tuple(tout.dims) == tuple(jout.dims) == (BATCH, SEQ, HIDDEN)
    assert [layer.name for layer in tm.layers] == \
        [layer.name for layer in jm.layers]
    params_from_numpy(tm, _np_params(jm.state.params))
    return (jm, jpt), (tm, tpt)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(BATCH, SEQ, HIDDEN).astype(np.float32),
            rng.randn(BATCH, SEQ, HIDDEN).astype(np.float32))


@pytest.fixture(scope="module")
def bert_pair():
    return _pair(_bert())


def test_bert_import_builds_the_same_graph_as_jax(bert_pair):
    (jm, _), (tm, _) = bert_pair
    assert [layer.op_type.name for layer in tm.layers] == \
        [layer.op_type.name for layer in jm.layers]
    kinds = [layer.op_type for layer in tm.layers]
    per_layer = len(kinds) // LAYERS
    assert kinds.count(OperatorType.OP_MULTIHEAD_ATTENTION) == LAYERS
    assert kinds.count(OperatorType.OP_LAYERNORM) == 2 * LAYERS
    assert kinds.count(OperatorType.OP_DROPOUT) == 2 * LAYERS
    assert kinds.count(OperatorType.OP_EW_ADD) == 2 * LAYERS
    assert kinds.count(OperatorType.OP_GELU) == LAYERS and per_layer == 10
    mha = [layer.params for layer in tm.layers
           if layer.op_type == OperatorType.OP_MULTIHEAD_ATTENTION]
    assert all(p.dropout == 0.1 and p.num_heads == HEADS for p in mha)


def test_bert_forward_in_eval_matches_jax(bert_pair):
    (jm, _), (tm, _) = bert_pair
    x, _ = _batch(1)
    jo = np.asarray(jm.executor.build_forward()(jm.state.params, [x]))
    to = tm.executor.build_forward()(tm.params, [x])
    assert to.shape == (BATCH, SEQ, HIDDEN) and torch.isfinite(to).all()
    np.testing.assert_allclose(to.numpy(), jo, atol=ATOL)


def test_bert_training_step_with_attention_dropout_matches_jax(monkeypatch):
    """Attention dropout 0.1 with the same seeds in both packages, hidden
    dropout 0: equal loss and gradients of every weight. The seeds act:
    without an rng the gradients differ."""
    monkeypatch.setattr(jka, "dropout_seeds",
                        lambda rng: jnp.asarray(np.asarray(SEEDS, np.uint32)))
    monkeypatch.setattr(tka, "dropout_seeds", lambda rng: SEEDS)
    monkeypatch.delenv("FF_ATTENTION_IMPL", raising=False)
    (jm, _), (tm, _) = _pair(_bert(attention_dropout=0.1, hidden_dropout=0.0))
    x, y = _batch(2)
    jex = jm.executor

    def jloss(p):
        vals = jex.apply(p, jex._input_vals([x]), training=True,
                         rng=jax.random.PRNGKey(0))
        return jex.loss_fn(vals[jex.logits_pt.guid], jnp.asarray(y))

    jl, jg = jax.value_and_grad(jloss)(jm.state.params)
    tex = tm.executor
    tl, _, tg = tex._loss_and_grads(tm.params, [x], tex._as_labels(y), 0)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jg = _np_params(jg)
    assert set(tg) == set(jg)
    for op, gs in tg.items():
        for n, g in gs.items():
            np.testing.assert_allclose(g.numpy(), jg[op][n], rtol=1e-5,
                                       atol=ATOL, err_msg=f"{op}.{n}")
    g0 = tex._loss_and_grads(tm.params, [x], tex._as_labels(y), None)[2]
    mha = next(op for op in tg if "attn" in op)
    assert not torch.allclose(g0[mha]["wq"], tg[mha]["wq"])


def test_bert_fits_with_both_dropouts_on_the_cpu():
    """The full dropout configuration trains through fit on the CPU: each
    step draws new masks, the loss stays finite, eval (no dropout) runs."""
    tm = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    PyTorchModel(_bert()).torch_to_ff(tm, [tm.create_tensor((BATCH, SEQ,
                                                             HIDDEN))])
    tm.compile(SGDOptimizer(lr=0.01), getattr(LossType, MSE))
    x, y = _batch(3)
    pm = tm.fit(np.concatenate([x, x]), np.concatenate([y, y]), epochs=2,
                verbose=False)
    assert tm.state.step == 4 and np.isfinite(pm.mse_loss)
    assert np.isfinite(tm.eval(x, y).mse_loss)


def test_load_weights_carries_torch_linear_and_layernorm_like_jax():
    module = _bert()
    with torch.no_grad():     # LayerNorm starts at (1, 0): make it visible
        for mod in module.modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.uniform_(0.5, 1.5)
                mod.bias.uniform_(-0.5, 0.5)
    (jm, jpt), (tm, tpt) = _pair(module)
    before = tm.params
    tpt.load_weights(tm)
    jpt.load_weights(jm)
    assert tm.params is before        # written in place
    sd = module.state_dict()
    for i in range(LAYERS):
        p = f"layers_{i}_"
        np.testing.assert_array_equal(tm.params[p + "fc1"]["kernel"].numpy(),
                                      sd[f"layers.{i}.fc1.weight"].numpy().T)
        np.testing.assert_array_equal(tm.params[p + "fc2"]["bias"].numpy(),
                                      sd[f"layers.{i}.fc2.bias"].numpy())
        np.testing.assert_array_equal(
            tm.params[p + "attn_norm"]["scale"].numpy(),
            sd[f"layers.{i}.attn_norm.weight"].numpy())
        np.testing.assert_array_equal(
            tm.params[p + "ffn_norm"]["bias"].numpy(),
            sd[f"layers.{i}.ffn_norm.bias"].numpy())
    jp = _np_params(jm.state.params)
    for op, ws in tm.params.items():
        for n, w in ws.items():   # attention keeps its own (JAX) init
            np.testing.assert_array_equal(w.numpy(), jp[op][n],
                                          err_msg=f"{op}.{n}")
    x, _ = _batch(4)
    np.testing.assert_allclose(
        tm.executor.build_forward()(tm.params, [x]).numpy(),
        np.asarray(jm.executor.build_forward()(jm.state.params, [x])),
        atol=ATOL)


class _Conv(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv1d(3, 4, 3)

    def forward(self, x):
        return self.conv(x)


class _Matmul(nn.Module):
    """A matmul variant the frontend has no row for (torch.matmul and
    bmm have one since the batch_matmul op was ported)."""

    def forward(self, x):
        return torch.chain_matmul(x, x, x)


class _Const(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("c", torch.ones(4))

    def forward(self, x):
        return x + self.c


@pytest.mark.parametrize("module,shape,name", [
    (_Conv(), (2, 3, 8), "Conv1d"),
    (nn.Sequential(nn.Linear(4, 4), nn.BatchNorm1d(4)), (2, 4), "BatchNorm1d"),
    (_Matmul(), (2, 4, 4), "matmul"),
    (_Const(), (2, 4), "constant tensors"),
])
def test_unsupported_module_raises_with_its_name(module, shape, name):
    m = FFModel(FFConfig(batch_size=2, device="cpu"))
    x = m.create_tensor(shape)
    with pytest.raises(NotImplementedError, match=name):
        PyTorchModel(module).torch_to_ff(m, [x])
    with pytest.raises(NotImplementedError, match="Hugging Face"):
        PyTorchModel(module, is_hf_model=True)


def test_functional_arithmetic_matches_jax_import():
    """Scalar and reversed-scalar arithmetic, a functional activation,
    softmax and F.dropout(training=False) through both frontends."""

    class Funky(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(8, 8)

        def forward(self, x):
            a = torch.sigmoid(self.fc(x)) + 0.5
            b = 2.0 / a - 1.0 + x * 3.0 - a / 4.0
            b = nn.functional.dropout(b, 0.5, training=False)
            return torch.softmax(-b, dim=-1)

    module = Funky()
    cfg = jff.FFConfig()
    cfg.batch_size = 4
    jm = jff.FFModel(cfg)
    jpt = JPyTorchModel(module)
    jpt.torch_to_ff(jm, [jm.create_tensor((4, 8), jff.DataType.DT_FLOAT)])
    jm.compile(jff.SGDOptimizer(lr=0.0), getattr(jff.LossType, MSE), [])
    jpt.load_weights(jm)
    tm = FFModel(FFConfig(batch_size=4, device="cpu"))
    tpt = PyTorchModel(module)
    tpt.apply(tm, [tm.create_tensor((4, 8))])
    tm.compile(SGDOptimizer(lr=0.0), getattr(LossType, MSE))
    tpt.load_weights()
    x = np.random.RandomState(5).randn(4, 8).astype(np.float32)
    want = module(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(
        tm.executor.build_forward()(tm.params, [x]).numpy(), want, atol=ATOL)
    np.testing.assert_allclose(
        tm.executor.build_forward()(tm.params, [x]).numpy(),
        np.asarray(jm.executor.build_forward()(jm.state.params, [x])),
        atol=ATOL)


# -- the new ops, op by op against JAX --------------------------------------

def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("axes,eps", [((-1,), 1e-5), ((-2, -1), 1e-3)])
def test_layer_norm_matches_jax(axes, eps):
    x = 3.0 * _x(0, 2, 5, 8) + 1.0
    jp = jnorm.LayerNormParams(axes=axes, eps=eps)
    tp = tnorm.LayerNormParams(axes=axes, eps=eps)
    specs = tnorm._weights(tp, [x.shape], [None])
    assert [(s.name, s.initializer) for s in specs] == \
        [(s.name, s.initializer)
         for s in jnorm._ln_weights(jp, [x.shape], [None])] == \
        [("scale", "one"), ("bias", "zero")]
    w = {s.name: _x(i + 1, *s.shape) for i, s in enumerate(specs)}
    (j,) = jnorm._ln_forward(jp, {n: jnp.asarray(a) for n, a in w.items()},
                             [jnp.asarray(x)], JCtx())
    (t,) = tnorm._forward(tp, {n: torch.from_numpy(a) for n, a in w.items()},
                          [torch.from_numpy(x)], TCtx())
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    (tb,) = tnorm._forward(tp, {n: torch.from_numpy(a) for n, a in w.items()},
                           [torch.from_numpy(x).bfloat16()], TCtx())
    assert tb.dtype == torch.bfloat16     # f32 statistics, input's dtype out


_UNARY = [t for t in tew._UNARY_FNS if t != OperatorType.OP_LOGICAL_NOT]


@pytest.mark.parametrize("op", _UNARY, ids=lambda t: t.name)
def test_unary_ops_match_jax(op):
    x = _x(6, 3, 7)
    if op in (OperatorType.OP_LOG, OperatorType.OP_SQRT,
              OperatorType.OP_RSQRT):
        x = np.abs(x) + 0.1
    jop = getattr(jff.OperatorType, op.name)
    (j,) = jew._unary_forward(jew.ElementUnaryParams(op_type=jop), {},
                              [jnp.asarray(x)], JCtx())
    (t,) = tew._unary_forward(tew.ElementUnaryParams(op_type=op), {},
                              [torch.from_numpy(x)], TCtx())
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                               rtol=1e-6)


def test_gelu_is_the_tanh_approximation_like_jax():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    (t,) = tew._unary_forward(
        tew.ElementUnaryParams(op_type=OperatorType.OP_GELU), {},
        [torch.from_numpy(x)], TCtx())
    np.testing.assert_allclose(t.numpy(), np.asarray(jax.nn.gelu(x)),
                               atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(t.numpy() - exact).max() > 1e-4   # not torch's erf GELU


@pytest.mark.parametrize("op", list(tew._SCALAR_FNS), ids=lambda t: t.name)
@pytest.mark.parametrize("scalar", [2.0, -0.75])
def test_scalar_ops_match_jax(op, scalar):
    x = _x(7, 4, 5)
    if op == OperatorType.OP_POW:
        x = np.abs(x) + 0.1
    jop = getattr(jff.OperatorType, op.name)
    (j,) = jew._unary_forward(
        jew.ElementUnaryParams(op_type=jop, scalar=scalar), {},
        [jnp.asarray(x)], JCtx())
    (t,) = tew._unary_forward(
        tew.ElementUnaryParams(op_type=op, scalar=scalar), {},
        [torch.from_numpy(x)], TCtx())
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                               rtol=1e-6)


@pytest.mark.parametrize("op", list(tew._BINARY_FNS), ids=lambda t: t.name)
@pytest.mark.parametrize("sa,sb", [((2, 3, 4), (4,)), ((2, 1, 4), (3, 1)),
                                   ((1,), (2, 3))])
def test_binary_ops_broadcast_like_jax(op, sa, sb):
    a, b = _x(8, *sa), _x(9, *sb)
    if op == OperatorType.OP_EW_DIV:
        b = np.abs(b) + 0.5
    jop = getattr(jff.OperatorType, op.name)
    jp = jew.ElementBinaryParams(op_type=jop)
    tp = tew.ElementBinaryParams(op_type=op)
    (j,) = jew._binary_forward(jp, {}, [jnp.asarray(a), jnp.asarray(b)],
                               JCtx())
    (t,) = tew._binary_forward(tp, {}, [torch.from_numpy(a),
                                        torch.from_numpy(b)], TCtx())
    (js,), (jd,) = jew._binary_infer(jp, [sa, sb], [jff.DataType.DT_FLOAT] * 2)
    (ts,), (td,) = tew._binary_infer(tp, [sa, sb], [DataType.DT_FLOAT] * 2)
    assert ts == js == t.shape and td.name == jd.name
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
