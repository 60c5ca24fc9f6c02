"""The shape ops, reductions, top_k, batch_matmul, PReLU and the MoE ops
of flexflow_tpu_torch against the JAX package's, op by op.

Inputs, weights and cotangents are made with numpy from a seed and
carried into both packages; forwards and the gradients of
sum_i <out_i, cot_i> with respect to every float input and weight are
compared. f32 on the CPU: the data-movement ops move values unchanged
and must agree exactly; the sums (reductions, products, the MoE
combine) differ only in the order of their terms, within atol 1e-5 on
values of order one. Integer outputs (argmax, top_k's indices, the
routing) are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ff_types import DataType as JDT
from flexflow_tpu.ff_types import OperatorType as JOp
from flexflow_tpu.ops import batch_matmul as jbmm
from flexflow_tpu.ops import elementwise as jew
from flexflow_tpu.ops import moe as jmoe
from flexflow_tpu.ops import reduce as jred
from flexflow_tpu.ops import softmax as jsm
from flexflow_tpu.ops import tensor_ops as jto
from flexflow_tpu.ops.registry import FwdCtx as JCtx
from flexflow_tpu.ops.registry import get_op_def as jget
from flexflow_tpu_torch.ff_types import DataType, OperatorType
from flexflow_tpu_torch.ops import batch_matmul as tbmm
from flexflow_tpu_torch.ops import elementwise as tew
from flexflow_tpu_torch.ops import moe as tmoe
from flexflow_tpu_torch.ops import reduce as tred
from flexflow_tpu_torch.ops import softmax as tsm
from flexflow_tpu_torch.ops import tensor_ops as tto
from flexflow_tpu_torch.ops.registry import FwdCtx as TCtx
from flexflow_tpu_torch.ops.registry import get_op_def

ATOL = 1e-5


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _run(op, jp, tp, ins, ws=None, jctx=None, tctx=None):
    """Both forwards on the same numpy inputs and weights. Returns (jax
    outputs, torch outputs, jax grads, torch grads): the grads of
    sum_i <out_i, cot_i> over the float outputs, with respect to each
    float input and then each weight."""
    ws = ws or {}
    jfwd, tfwd = jget(JOp[op.name]).forward, get_op_def(op).forward
    jctx = jctx or JCtx(training=True)
    tctx = tctx or TCtx(training=True)
    fidx = [i for i, a in enumerate(ins) if _is_float(a)]
    names = sorted(ws)

    def jfn(*vals):
        xs = [jnp.asarray(a) for a in ins]
        for i, v in zip(fidx, vals):
            xs[i] = v
        w = dict(zip(names, vals[len(fidx):]))
        return jfwd(jp, w, xs, jctx)

    jvals = [jnp.asarray(ins[i]) for i in fidx] + [jnp.asarray(ws[n])
                                                  for n in names]
    jouts = jfn(*jvals)
    rng = np.random.RandomState(99)
    cots = [rng.randn(*np.shape(o)).astype(np.float32) if _is_float(o)
            else None for o in jouts]

    def jloss(*vals):
        return sum(jnp.vdot(o.astype(jnp.float32), c)
                   for o, c in zip(jfn(*vals), cots) if c is not None)

    jgrads = (jax.grad(jloss, argnums=tuple(range(len(jvals))))(*jvals)
              if jvals and any(c is not None for c in cots) else ())
    tvals = [torch.from_numpy(np.array(ins[i])).requires_grad_()
             for i in fidx] + [torch.from_numpy(np.array(ws[n]))
                               .requires_grad_() for n in names]
    xs = [torch.from_numpy(np.array(a)) for a in ins]
    for i, v in zip(fidx, tvals):
        xs[i] = v
    touts = tfwd(tp, dict(zip(names, tvals[len(fidx):])), xs, tctx)
    terms = [(o.float() * torch.from_numpy(c)).sum()
             for o, c in zip(touts, cots) if c is not None]
    tgrads = (torch.autograd.grad(sum(terms), tvals, allow_unused=True)
              if tvals and terms else ())
    return jouts, touts, jgrads, tgrads


def _check(op, jp, tp, ins, ws=None, atol=ATOL, exact=False, **kw):
    jouts, touts, jgrads, tgrads = _run(op, jp, tp, ins, ws, **kw)
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        if not _is_float(j):
            assert str(t.dtype).split(".")[-1] == str(j.dtype), (t.dtype,
                                                                 j.dtype)
            np.testing.assert_array_equal(t.numpy(), j)
        elif exact:
            np.testing.assert_array_equal(t.detach().float().numpy(),
                                          j.astype(np.float32))
        else:
            np.testing.assert_allclose(t.detach().float().numpy(), j,
                                       atol=atol, rtol=0)
    for j, t in zip(jgrads, tgrads):
        t = np.zeros(np.shape(j), np.float32) if t is None else t.numpy()
        np.testing.assert_allclose(t, np.asarray(j), atol=atol, rtol=0)
    return jouts, touts


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- shape ops ---------------------------------------------------------------
@pytest.mark.parametrize("shape", [(6, -1), (4, 3, 2), (-1,)])
def test_reshape_matches_jax(shape):
    _check(OperatorType.OP_RESHAPE, jto.ReshapeParams(shape),
           tto.ReshapeParams(shape), [_x(2, 3, 4)], exact=True)


@pytest.mark.parametrize("perm", [(2, 0, 1), (0, 2, 1), (1, 0, 2)])
def test_transpose_matches_jax(perm):
    _check(OperatorType.OP_TRANSPOSE, jto.TransposeParams(perm),
           tto.TransposeParams(perm), [_x(2, 3, 4)], exact=True)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_reverse_matches_jax(axis):
    _check(OperatorType.OP_REVERSE, jto.ReverseParams(axis),
           tto.ReverseParams(axis), [_x(2, 3, 4)], exact=True)


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_concat_every_axis_matches_jax(axis):
    shapes = []
    for i, extra in enumerate((1, 2, 3)):
        s = [2, 3, 4]
        s[axis] = extra
        shapes.append(_x(*s, seed=i))
    _check(OperatorType.OP_CONCAT, jto.ConcatParams(axis),
           tto.ConcatParams(axis), shapes, exact=True)


@pytest.mark.parametrize("sizes,axis", [((1, 2, 3), 1), ((3, 3), 1),
                                        ((2, 2), -1), ((1, 1), 0)])
def test_split_matches_jax(sizes, axis):
    x = _x(2, 6, 4)
    jouts, touts = _check(OperatorType.OP_SPLIT,
                          jto.SplitParams(sizes, axis),
                          tto.SplitParams(sizes, axis), [x], exact=True)
    assert len(touts) == len(sizes)


def test_split_builder_by_count_and_by_sizes_returns_lists():
    from flexflow_tpu_torch import FFConfig, FFModel

    m = FFModel(FFConfig(device="cpu"))
    t = m.create_tensor((2, 6, 4))
    by_count = m.split(t, 3, axis=1)
    by_sizes = m.split(t, [1, 5], axis=1)
    assert [o.dims for o in by_count] == [(2, 2, 4)] * 3
    assert [o.dims for o in by_sizes] == [(2, 1, 4), (2, 5, 4)]
    assert isinstance(m.split(t, 1, axis=1), list)
    with pytest.raises(ValueError, match="divisible"):
        m.split(t, 4, axis=1)
    with pytest.raises(ValueError, match="sum"):
        m.split(t, [2, 2], axis=1)


@pytest.mark.parametrize("dt", ["DT_HALF", "DT_INT32", "DT_FLOAT"])
def test_cast_matches_jax(dt):
    x = 3 * _x(2, 5)
    _check(OperatorType.OP_CAST, jto.CastParams(getattr(JDT, dt)),
           tto.CastParams(getattr(DataType, dt)), [x], exact=True)


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_gather_matches_jax(dim):
    """torch.gather semantics, repeated indices (their gradients add), all
    in range: JAX clamps an index out of range, torch raises (and a card
    device-asserts), so no test hands one over."""
    x = _x(4, 5)
    size = x.shape[dim]
    idx = np.random.RandomState(1).randint(0, size, (3, 5) if dim == 0
                                           else (4, 7)).astype(np.int32)
    _check(OperatorType.OP_GATHER, jto.GatherParams(dim),
           tto.GatherParams(dim), [x, idx])


def test_gather_backward_is_deterministic_and_restores_the_flag():
    x = torch.from_numpy(_x(4, 5)).requires_grad_()
    idx = torch.zeros(9, 5, dtype=torch.int32)
    (y,) = get_op_def(OperatorType.OP_GATHER).forward(
        tto.GatherParams(0), {}, [x, idx], TCtx(training=True))
    assert not torch.are_deterministic_algorithms_enabled()
    (g,) = torch.autograd.grad(y.sum(), [x])
    assert not torch.are_deterministic_algorithms_enabled()
    np.testing.assert_array_equal(g[0].numpy(), np.full(5, 9.0, np.float32))


def test_pad_and_slice_match_jax():
    pads = ((1, 2), (0, 1), (2, 0))
    _check(OperatorType.OP_PAD, jto.PadParams(pads, 0.5),
           tto.PadParams(pads, 0.5), [_x(2, 3, 4)], exact=True)
    _check(OperatorType.OP_SLICE, jto.SliceParams((0, 1, 1), (2, 3, 4)),
           tto.SliceParams((0, 1, 1), (2, 3, 4)), [_x(2, 3, 4)], exact=True)
    _check(OperatorType.OP_NOOP, jto.NoOpParams(), tto.NoOpParams(),
           [_x(2, 3)], exact=True)


@pytest.mark.parametrize("axes", [(), (1,), (-1,), (1, 3)])
def test_squeeze_matches_jax(axes):
    _check(OperatorType.OP_SQUEEZE, jto.SqueezeParams(axes),
           tto.SqueezeParams(axes), [_x(2, 1, 3, 1)], exact=True)


@pytest.mark.parametrize("axes", [(0,), (-1,), (1, 3), (0, -1)])
def test_unsqueeze_matches_jax(axes):
    _check(OperatorType.OP_UNSQUEEZE, jto.UnsqueezeParams(axes),
           tto.UnsqueezeParams(axes), [_x(2, 3)], exact=True)


def test_where_matches_jax():
    rng = np.random.RandomState(3)
    cond = rng.rand(1, 3, 4) > 0.5
    _check(OperatorType.OP_WHERE, jto.WhereParams(), tto.WhereParams(),
           [cond, _x(2, 3, 4), _x(2, 1, 4, seed=1)], exact=True)


@pytest.mark.parametrize("shape,out", [
    ((2, 3, 5, 7), (2, 3, 10, 4)),   # up on one axis, down on another
    ((2, 3, 2, 2), (2, 3, 3, 5)),    # 2 -> 3: source positions on .5
    ((2, 3, 4), (3, 3, 8)),          # a batch axis resized too
    ((1, 2, 9, 9), (1, 2, 4, 4)),
])
def test_resize_matches_jax_image_resize(shape, out):
    """Nearest at half-pixel centres on every axis that changes (torch's
    "nearest-exact"), against jax.image.resize(method="nearest")."""
    _check(OperatorType.OP_RESIZE, jto.ResizeParams(out),
           tto.ResizeParams(out), [_x(*shape)])
    x = _x(*shape)
    (t,) = get_op_def(OperatorType.OP_RESIZE).forward(
        tto.ResizeParams(out), {}, [torch.from_numpy(x)], TCtx())
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(jax.image.resize(x, out, method="nearest")))


# -- reductions --------------------------------------------------------------
_REDUCE = ["OP_REDUCE_SUM", "OP_REDUCE_MEAN", "OP_REDUCE_MAX",
           "OP_REDUCE_MIN", "OP_REDUCE_PROD", "OP_MEAN"]


@pytest.mark.parametrize("op", _REDUCE)
@pytest.mark.parametrize("axes,keep", [((1,), False), ((0, 2), True),
                                       ((-1,), False), ((), False)])
def test_reductions_match_jax(op, axes, keep):
    x = _x(2, 3, 4) * 0.5 + 1.0  # away from 0 for prod's gradient
    _check(getattr(OperatorType, op), jred.ReduceParams(axes, keep),
           tred.ReduceParams(axes, keep), [x])


@pytest.mark.parametrize("op", ["OP_REDUCE_MAX", "OP_REDUCE_MIN"])
def test_max_min_spread_the_gradient_over_ties_as_jax(op):
    x = np.array([[1.0, 3.0, 3.0, -2.0], [-2.0, -2.0, 0.5, 3.0]],
                 np.float32)
    _check(getattr(OperatorType, op), jred.ReduceParams((1,)),
           tred.ReduceParams((1,)), [x])


@pytest.mark.parametrize("op", ["OP_REDUCE_ARGMAX", "OP_REDUCE_ARGMIN"])
@pytest.mark.parametrize("axis,keep", [(1, False), (0, True), (-1, False)])
def test_argmax_argmin_take_the_first_of_ties_as_jax(op, axis, keep):
    x = np.array([[1.0, 3.0, 3.0, -2.0], [-2.0, -2.0, 3.0, 3.0],
                  [0.0, 0.0, 0.0, 0.0]], np.float32)
    _check(getattr(OperatorType, op), jred.ReduceParams((axis,), keep),
           tred.ReduceParams((axis,), keep), [x])


def test_top_k_ties_on_relu_gate_rows_match_jax_exactly():
    """RELU'd gate rows where fewer than k (and none) of the gates are
    positive: the zeros tie, and the lower index must come first, as
    lax.top_k orders them."""
    rng = np.random.RandomState(4)
    g = np.maximum(rng.randn(64, 6).astype(np.float32), 0.0)
    g[:8] = 0.0                      # every gate zero
    g[8:16, 1:] = 0.0                # one positive gate
    g[16:20, ::2] = 1.25             # ties among positive values too
    for k in (1, 2, 3, 6):
        jouts, touts = _check(OperatorType.OP_TOPK, jred.TopKParams(k),
                              tred.TopKParams(k), [g])
        np.testing.assert_array_equal(touts[1].numpy(), np.asarray(jouts[1]))
        assert touts[1].dtype == torch.int32


def test_top_k_order_is_stable_under_permutations_of_equal_values():
    x = torch.zeros(3, 8)
    x[:, 5] = 1.0
    v, i = tred.top_k(x, 4)
    assert i.tolist() == [[5, 0, 1, 2]] * 3
    assert v.tolist() == [[1.0, 0.0, 0.0, 0.0]] * 3


# -- batch_matmul and PReLU --------------------------------------------------
@pytest.mark.parametrize("seq", [-1, 3, 10])
def test_batch_matmul_with_seq_length_matches_jax(seq):
    a, b = _x(2, 6, 4), _x(2, 4, 5, seed=1)
    p = dict(a_seq_length_dim=1, b_seq_length_dim=-1)
    _check(OperatorType.OP_BATCHMATMUL, jbmm.BatchMatmulParams(**p),
           tbmm.BatchMatmulParams(**p), [a, b],
           jctx=JCtx(training=True, seq_length=seq),
           tctx=TCtx(training=True, seq_length=seq))


def test_batch_matmul_leading_axes_match_jax():
    _check(OperatorType.OP_BATCHMATMUL, jbmm.BatchMatmulParams(),
           tbmm.BatchMatmulParams(), [_x(2, 3, 5, 4), _x(2, 3, 4, 6, seed=1)])


@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (4, 6), (2, 3, 6)])
def test_prelu_matches_jax(shape):
    x = _x(*shape)
    c = shape[1] if len(shape) == 4 else shape[-1]
    alpha = np.random.RandomState(5).rand(c).astype(np.float32)
    specs = tew._prelu_weights(None, [shape], [DataType.DT_FLOAT])
    assert [(s.name, s.shape, s.initializer) for s in specs] == [
        ("alpha", (c,), "constant:0.25")]
    _check(OperatorType.OP_PRELU, jew.PReluParams(), tew.PReluParams(),
           [x], {"alpha": alpha})


def test_prelu_initial_slope_is_a_quarter():
    from flexflow_tpu_torch.core.initializers import get_initializer

    w = get_initializer("constant:0.25")(None, (3,), torch.float32)
    assert w.tolist() == [0.25] * 3


# -- the MoE ops ---------------------------------------------------------------
def _routing(b, k, n, seed, skew=True):
    """[b, k] assignments, distinct per row, skewed toward expert 0 so
    that it overflows its capacity."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(b):
        p = np.array([4.0] + [1.0] * (n - 1)) if skew else np.ones(n)
        rows.append(rng.choice(n, k, replace=False, p=p / p.sum()))
    return np.array(rows, np.int32)


@pytest.mark.parametrize("b,k,n,alpha", [(16, 2, 4, 1.0), (12, 1, 3, 0.5),
                                         (8, 2, 4, 2.0)])
def test_dispatch_mask_routes_and_drops_as_jax(b, k, n, alpha):
    assign = _routing(b, k, n, seed=b + k)
    cap = jmoe._capacity(b, k, n, alpha)
    assert tmoe._capacity(b, k, n, alpha) == cap
    jm = np.asarray(jmoe._dispatch_mask(jnp.asarray(assign), n, cap))
    tm = tmoe.dispatch_mask(torch.from_numpy(assign), n, cap)
    np.testing.assert_array_equal(tm.numpy(), jm)
    dropped = tmoe.dropped_share(torch.from_numpy(assign), n, cap)
    assert dropped == pytest.approx(1 - jm.sum() / (b * k))
    if alpha < 2.0:
        assert dropped > 0  # the skewed routing overflows expert 0


def test_dispatch_mask_ignores_out_of_range_slots_without_one_hot():
    """pos - 1 is -1 for pairs not chosen and >= capacity for dropped
    ones: both give zero rows (JAX's one_hot), never an error."""
    assign = torch.zeros(5, 1, dtype=torch.int32)  # 5 tokens to expert 0
    m = tmoe.dispatch_mask(assign, 2, 2)
    assert m.shape == (5, 2, 2)
    assert m[:, 1].sum() == 0 and m[2:].sum() == 0
    assert m[0, 0].tolist() == [1, 0] and m[1, 0].tolist() == [0, 1]


@pytest.mark.parametrize("alpha", [0.5, 1.0, 2.0])
def test_group_by_matches_jax(alpha):
    b, k, n, d = 16, 2, 4, 8
    _check(OperatorType.OP_GROUP_BY, jmoe.GroupByParams(n, alpha),
           tmoe.GroupByParams(n, alpha),
           [_x(b, d), _routing(b, k, n, seed=1)])


@pytest.mark.parametrize("lambda_bal", [0.0, 0.5])
def test_aggregate_matches_jax_with_balance_loss(lambda_bal):
    b, k, n, d = 16, 2, 4, 8
    cap = jmoe._capacity(b, k, n, 1.0)
    assign = _routing(b, k, n, seed=2)
    gates = np.abs(_x(b, k, seed=3))
    full = _x(b, n, seed=4)
    experts = [_x(cap, d, seed=10 + e) for e in range(n)]
    jaux, taux = [], []
    _check(OperatorType.OP_AGGREGATE, jmoe.AggregateParams(n, lambda_bal),
           tmoe.AggregateParams(n, lambda_bal),
           [gates, assign, assign, full] + experts,
           jctx=JCtx(training=True, aux_losses=jaux),
           tctx=TCtx(training=True, aux_losses=taux))
    # JAX's forward ran twice (once more under jax.grad), the port's once
    assert len(taux) == (1 if lambda_bal else 0)
    assert len(jaux) == 2 * len(taux)
    for t in taux:
        np.testing.assert_allclose(float(t.detach()), float(jaux[0]),
                                   atol=ATOL,
                                   rtol=0)


def test_balance_loss_gradient_reaches_the_full_gate_as_jax():
    """The aux loss alone: its value and its gradient with respect to the
    full gate (through P_e; f_e is detached)."""
    b, k, n, d = 16, 2, 4, 8
    cap = jmoe._capacity(b, k, n, 1.0)
    assign = _routing(b, k, n, seed=5)
    gates, full = np.abs(_x(b, k, seed=6)), _x(b, n, seed=7)
    experts = [_x(cap, d, seed=20 + e) for e in range(n)]

    def jaux(f):
        aux = []
        jmoe._agg_forward(jmoe.AggregateParams(n, 0.3), {},
                          [jnp.asarray(gates), jnp.asarray(assign),
                           jnp.asarray(assign), f]
                          + [jnp.asarray(e) for e in experts],
                          JCtx(training=True, aux_losses=aux))
        return aux[0]

    jv, jg = jax.value_and_grad(jaux)(jnp.asarray(full))
    tf = torch.from_numpy(full).requires_grad_()
    aux = []
    tmoe._agg_forward(tmoe.AggregateParams(n, 0.3), {},
                      [torch.from_numpy(gates), torch.from_numpy(assign),
                       torch.from_numpy(assign), tf]
                      + [torch.from_numpy(e) for e in experts],
                      TCtx(training=True, aux_losses=aux))
    (tg,) = torch.autograd.grad(aux[0], [tf])
    np.testing.assert_allclose(float(aux[0]), float(jv), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=ATOL, rtol=0)
    assert np.abs(tg.numpy()).max() > 0


def test_aggregate_spec_matches_jax():
    b, k, n, d = 12, 2, 3, 8
    cap = jmoe._capacity(b, k, n, 1.0)
    assign = _routing(b, k, n, seed=8)
    experts = [_x(cap, d, seed=30 + e) for e in range(n)]
    _check(OperatorType.OP_AGG_SPEC, jmoe.AggregateSpecParams(n),
           tmoe.AggregateSpecParams(n),
           [np.abs(_x(b, k, seed=9)), assign] + experts)


def test_moe_layer_gradients_for_gate_and_experts_match_jax():
    """gate dense (RELU) -> top_k -> group_by -> expert dense -> aggregate
    with the balance loss, composed from each package's op forwards:
    the output, the loss and the gradients of the input, the gate and
    every expert, with tokens dropped by capacity."""
    b, d, n, k, h, alpha = 24, 8, 4, 2, 6, 0.75
    rng = np.random.RandomState(11)
    x = rng.randn(b, d).astype(np.float32)
    wg = rng.randn(d, n).astype(np.float32)
    wes = [rng.randn(d, h).astype(np.float32) for _ in range(n)]
    cot = rng.randn(b, h).astype(np.float32)

    def layer(lib, x, wg, *wes):
        if lib is jnp:
            get, ot, red, moe, sm = jget, JOp, jred, jmoe, jsm
            aux = []
            ctx = JCtx(training=True, aux_losses=aux)
            relu, mm = jax.nn.relu, jnp.matmul
        else:
            get, ot, red, moe, sm = get_op_def, OperatorType, tred, tmoe, tsm
            aux = []
            ctx = TCtx(training=True, aux_losses=aux)
            relu, mm = torch.relu, torch.matmul
        gate = relu(mm(x, wg))
        vals, idx = get(ot.OP_TOPK).forward(red.TopKParams(k), {}, [gate],
                                             ctx)
        groups = get(ot.OP_GROUP_BY).forward(moe.GroupByParams(n, alpha),
                                             {}, [x, idx], ctx)
        (probs,) = get(ot.OP_SOFTMAX).forward(sm.SoftmaxParams(-1), {},
                                              [vals], ctx)
        outs = [relu(mm(g, w)) for g, w in zip(groups, wes)]
        (y,) = get(ot.OP_AGGREGATE).forward(
            moe.AggregateParams(n, 0.2), {}, [probs, idx, idx, gate] + outs,
            ctx)
        return y, aux[0], idx

    def jloss(*a):
        y, aux, _ = layer(jnp, *a)
        return jnp.vdot(y, cot) + aux

    args = [x, wg] + wes
    jy, jaux, jidx = layer(jnp, *[jnp.asarray(a) for a in args])
    jg = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    ty, taux, tidx = layer(torch, *targs)
    tg = torch.autograd.grad((ty * torch.from_numpy(cot)).sum() + taux,
                             targs)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    cap = tmoe._capacity(b, k, n, alpha)
    assert tmoe.dropped_share(tidx, n, cap) > 0
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL, rtol=0)
    for name, t, j in zip(["x", "gate"] + [f"expert{e}" for e in range(n)],
                          tg, jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=0, err_msg=name)
        assert np.abs(t.numpy()).max() > 0, name


def test_cache_blends_in_training_and_serves_in_eval_as_jax():
    params_j, params_t = jmoe.CacheParams(3), tmoe.CacheParams(3)
    shape = (4, 5)
    specs = tmoe._cache_state(params_t, [shape], [DataType.DT_FLOAT])
    assert [(s.name, s.shape, s.dtype) for s in specs] == [
        ("cached", shape, DataType.DT_FLOAT),
        ("filled", (1,), DataType.DT_FLOAT)]
    jst = {"cached": jnp.zeros(shape), "filled": jnp.zeros((1,))}
    tst = {"cached": torch.zeros(shape), "filled": torch.zeros(1)}
    for i in range(3):
        x = _x(*shape, seed=40 + i)
        (jo,), jst = jmoe._cache_forward_stateful(
            params_j, {}, jst, [jnp.asarray(x)], JCtx(training=True))
        (to,), tst = tmoe._cache_forward_stateful(
            params_t, {}, tst, [torch.from_numpy(x)], TCtx(training=True))
        np.testing.assert_array_equal(to.numpy(), x)  # passes through
        for n in ("cached", "filled"):
            np.testing.assert_allclose(tst[n].numpy(), np.asarray(jst[n]),
                                       atol=1e-6, rtol=0)
    x = _x(*shape, seed=50)
    (jo,), _ = jmoe._cache_forward_stateful(params_j, {}, jst,
                                            [jnp.asarray(x)],
                                            JCtx(training=False))
    (to,), st = tmoe._cache_forward_stateful(params_t, {}, tst,
                                             [torch.from_numpy(x)], TCtx())
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(to.numpy(), tst["cached"].numpy())
    assert st is tst
    # never written: inference passes the input through
    empty = {"cached": torch.zeros(shape), "filled": torch.zeros(1)}
    (to,), _ = tmoe._cache_forward_stateful(params_t, {}, empty,
                                            [torch.from_numpy(x)], TCtx())
    np.testing.assert_array_equal(to.numpy(), x)
