"""The CNN ops of flexflow_tpu_torch against the JAX package's, op by op:
Conv2D, Pool2D, Flat and BatchNorm (with its running statistics), and
the glorot initializer of a conv kernel.

Inputs, weights and cotangents are made with numpy from a seed and
carried into both packages; forwards and the gradients of <out, cot>
are compared. f32 on the CPU, where the two differ only in the order of
their sums (XLA's convolutions against oneDNN's): rtol 1e-5 with atol
1e-5 on outputs of order one, 1e-4 on gradients, which sum up to a few
thousand products of order one. bf16 (a compute dtype over f32 inputs
and weights): both round the convolution's inputs and its output to
bf16 but sum in f32 inside in other orders, so an output can land one
bf16 step (2^-8 relative) away; the checks allow two steps of the
element plus two steps of the output's largest element. One bf16
gradient is summed in another precision: the conv bias's (see
`test_conv2d_bf16_compute_matches_jax`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.core.initializers import GlorotUniformInitializer as JGlorot
from flexflow_tpu.ff_types import ActiMode as JActi
from flexflow_tpu.ff_types import OperatorType as JOp
from flexflow_tpu.ff_types import PoolType as JPool
from flexflow_tpu.ops import conv2d as jconv
from flexflow_tpu.ops import normalization as jnorm
from flexflow_tpu.ops import pool2d as jpool
from flexflow_tpu.ops.registry import FwdCtx as JCtx
from flexflow_tpu.ops.registry import get_op_def as jget
from flexflow_tpu_torch.core.initializers import GlorotUniformInitializer
from flexflow_tpu_torch.ff_types import ActiMode, OperatorType, PoolType
from flexflow_tpu_torch.ops import conv2d as tconv
from flexflow_tpu_torch.ops import normalization as tnorm
from flexflow_tpu_torch.ops import pool2d as tpool
from flexflow_tpu_torch.ops.registry import FwdCtx as TCtx
from flexflow_tpu_torch.ops.registry import get_op_def

RTOL, ATOL, GRAD_ATOL = 1e-5, 1e-5, 1e-4
BF16_STEP = 2.0 ** -8


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


def _jax_vjp(fn, arrays, cot):
    """fn's output and the gradients of <fn(*arrays), cot>, as numpy."""
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    grads = vjp(jnp.asarray(cot, out.dtype))
    return (np.asarray(out, np.float32),
            [np.asarray(g, np.float32) for g in grads])


def _torch_vjp(fn, arrays, cot):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot).to(
        out.dtype))
    return (out.detach().float().numpy(),
            [g.float().numpy() for g in grads])


def _close_bf16(got, want, what):
    np.testing.assert_allclose(
        got, want, rtol=2 * BF16_STEP,
        atol=2 * BF16_STEP * float(np.abs(want).max()), err_msg=what)


# -- Conv2D -----------------------------------------------------------------
CONV_CASES = [
    # (cin, cout, k, stride, pad, groups, bias, activation)
    (3, 8, 3, 1, 1, 1, True, "AC_MODE_NONE"),
    (3, 8, 5, 2, 2, 1, False, "AC_MODE_RELU"),
    (4, 6, 3, 2, 0, 2, True, "AC_MODE_RELU"),
    (64, 64, 3, 1, 1, 32, False, "AC_MODE_NONE"),
    (64, 32, 3, 2, 1, 32, True, "AC_MODE_RELU"),
    (6, 4, 1, 1, 0, 1, True, "AC_MODE_SIGMOID"),
    (3, 4, (3, 5), (2, 1), (1, 2), 1, True, "AC_MODE_TANH"),
]


def _conv_params(cin, cout, k, stride, pad, groups, bias, act):
    k, stride, pad = (v if isinstance(v, tuple) else (v, v)
                      for v in (k, stride, pad))
    kw = dict(out_channels=cout, kernel_h=k[0], kernel_w=k[1],
              stride_h=stride[0], stride_w=stride[1], padding_h=pad[0],
              padding_w=pad[1], groups=groups, use_bias=bias)
    return (jconv.Conv2DParams(activation=JActi[act], **kw),
            tconv.Conv2DParams(activation=ActiMode[act], **kw))


def _conv_arrays(case, seed, n=2, hw=(11, 9)):
    jp, tp = _conv_params(*case)
    rng = np.random.RandomState(seed)
    x = _rand(rng, n, case[0], *hw)
    specs = tconv._weights(tp, [x.shape], [None])
    ws = [_rand(rng, *s.shape, scale=0.3) for s in specs]
    out_shape = tconv._infer(tp, [x.shape], [None])[0][0]
    cot = _rand(rng, *out_shape)
    return jp, tp, [s.name for s in specs], x, ws, cot


def _conv_fns(jp, tp, names, jcdt=None, tcdt=None):
    def jfn(x, *ws):
        (y,) = jconv._forward(jp, dict(zip(names, ws)), [x],
                              JCtx(training=True, compute_dtype=jcdt))
        return y

    def tfn(x, *ws):
        (y,) = tconv._forward(tp, dict(zip(names, ws)), [x],
                              TCtx(training=True, compute_dtype=tcdt))
        return y

    return jfn, tfn


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv2d_forward_and_gradients_match_jax(case):
    jp, tp, names, x, ws, cot = _conv_arrays(case, 0)
    jfn, tfn = _conv_fns(jp, tp, names)
    jy, jg = _jax_vjp(jfn, [x] + ws, cot)
    ty, tg = _torch_vjp(tfn, [x] + ws, cot)
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty, jy, rtol=RTOL, atol=ATOL)
    for n, a, b in zip(["input"] + names, tg, jg):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=GRAD_ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("case", [CONV_CASES[0], CONV_CASES[2],
                                  CONV_CASES[4]], ids=str)
def test_conv2d_bf16_compute_matches_jax(case):
    """Under a bf16 compute dtype both cast the input and the kernel and
    keep the output in bf16; the gradients reach the f32 masters.

    The bias gradient sums the bf16 cotangent over N*H*W terms: torch
    sums in f32 and rounds once, JAX's reduction keeps bf16 throughout
    (0.56 off the exact sum where torch is 0.06 off, on sums of ~24).
    So each is held to the exact (f64) sum of the bf16 cotangent: the
    port within one bf16 step of the result, JAX within the bound of a
    pairwise bf16 sum, ceil(log2 n) rounding steps (2^-9) of sum|cot|."""
    jp, tp, names, x, ws, cot = _conv_arrays(case, 1)
    jfn, tfn = _conv_fns(jp, tp, names, jnp.bfloat16, torch.bfloat16)
    jy, jg = _jax_vjp(jfn, [x] + ws, cot)
    ty, tg = _torch_vjp(tfn, [x] + ws, cot)
    leaves = [torch.from_numpy(a) for a in [x] + ws]
    assert tfn(*leaves).dtype == torch.bfloat16
    _close_bf16(ty, jy, "output")
    for n, a, b in zip(["input"] + names, tg, jg):
        if n != "bias":
            _close_bf16(a, b, n)
            continue
        cb = torch.from_numpy(cot).to(torch.bfloat16).double().numpy()
        terms = cb.size // cb.shape[1]
        for got, y, tol in ((a, ty, None), (b, jy, "pairwise")):
            # the cotangent that reaches the bias: through each one's
            # own RELU mask
            c = cb * (y > 0) if tp.activation == ActiMode.AC_MODE_RELU else cb
            exact = c.sum(axis=(0, 2, 3))
            if tol is None:
                np.testing.assert_allclose(got, exact, rtol=BF16_STEP, atol=0)
                continue
            bound = np.ceil(np.log2(terms)) * 2.0 ** -9 * np.abs(c).sum(
                axis=(0, 2, 3))
            assert (np.abs(got - exact) <= bound).all(), (got, exact, bound)


def test_conv2d_runs_exact_and_restores_the_cudnn_flags():
    """The op's convolutions run without TF32 and deterministic; the
    caller's flags come back after the forward and the backward."""
    cudnn = torch.backends.cudnn
    seen = []
    real = torch.nn.functional.conv2d

    def spy(*a, **k):
        seen.append((cudnn.allow_tf32, cudnn.deterministic))
        return real(*a, **k)

    saved = (cudnn.allow_tf32, cudnn.deterministic)
    try:
        cudnn.allow_tf32, cudnn.deterministic = True, False
        tconv.F.conv2d = spy
        x = torch.randn(1, 2, 5, 5, requires_grad=True)
        k = torch.randn(3, 2, 3, 3, requires_grad=True)
        tconv.conv2d(x, k).sum().backward()
        assert seen == [(False, True)]
        assert (cudnn.allow_tf32, cudnn.deterministic) == (True, False)
        with tconv.exact_conv():
            assert (cudnn.allow_tf32, cudnn.deterministic) == (False, True)
        assert (cudnn.allow_tf32, cudnn.deterministic) == (True, False)
        assert x.grad is not None and k.grad is not None
    finally:
        tconv.F.conv2d = real
        cudnn.allow_tf32, cudnn.deterministic = saved


@pytest.mark.parametrize("shape", [(8, 3, 11, 11), (64, 2, 3, 3),
                                   (16, 32, 1, 1), (6, 5)])
def test_glorot_fans_and_variance_match_jax(shape):
    """The port's draws come from torch's generator, JAX's from its PRNG;
    both are uniform on [-limit, limit] with JAX's fans (an OIHW kernel:
    receptive field times channels), so the variance is limit^2 / 3."""
    t = GlorotUniformInitializer()(torch.Generator().manual_seed(0),
                                   shape, torch.float32).numpy()
    j = np.asarray(JGlorot()(jax.random.PRNGKey(0), shape, jnp.float32))
    if len(shape) == 4:
        receptive = shape[2] * shape[3]
        fans = shape[1] * receptive + shape[0] * receptive
    else:
        fans = shape[0] + shape[1]
    limit = np.sqrt(6.0 / fans)
    for a in (t, j):
        assert np.abs(a).max() <= limit
        assert np.abs(a).max() > 0.95 * limit
    # variance within 4 standard errors of limit^2/3 for uniform draws
    # (the variance of u^2 is 4 limit^4 / 45)
    se = np.sqrt(4 * limit ** 4 / 45 / t.size)
    for a in (t, j):
        assert abs(a.var() - limit ** 2 / 3) < 4 * se


# -- Pool2D -----------------------------------------------------------------
POOL_CASES = [
    # (kernel, stride, pad, pool, activation)
    (3, 2, 0, "POOL_MAX", "AC_MODE_NONE"),
    (3, 2, 1, "POOL_MAX", "AC_MODE_RELU"),
    (2, 2, 0, "POOL_AVG", "AC_MODE_NONE"),
    (3, 2, 1, "POOL_AVG", "AC_MODE_NONE"),
    (3, 1, 1, "POOL_AVG", "AC_MODE_TANH"),
    (5, 1, 0, "POOL_AVG", "AC_MODE_NONE"),
    # wider than half a window: written out with F.pad
    (2, 1, 1, "POOL_MAX", "AC_MODE_NONE"),
    (3, 2, 2, "POOL_AVG", "AC_MODE_SIGMOID"),
]


@pytest.mark.parametrize("case", POOL_CASES, ids=str)
def test_pool2d_forward_and_gradient_match_jax(case):
    """Average pooling divides by the window's count of real elements
    (padding left out), as JAX's second reduce_window counts them."""
    k, s, p, pool, act = case
    kw = dict(kernel_h=k, kernel_w=k, stride_h=s, stride_w=s, padding_h=p,
              padding_w=p)
    jp = jpool.Pool2DParams(pool_type=JPool[pool], activation=JActi[act],
                            **kw)
    tp = tpool.Pool2DParams(pool_type=PoolType[pool], activation=ActiMode[act],
                            **kw)
    rng = np.random.RandomState(2)
    x = _rand(rng, 2, 3, 7, 6)
    out_shape = tpool._infer(tp, [x.shape], [None])[0][0]
    cot = _rand(rng, *out_shape)
    jy, (jg,) = _jax_vjp(lambda a: jpool._forward(jp, {}, [a], JCtx())[0],
                         [x], cot)
    ty, (tg,) = _torch_vjp(lambda a: tpool._forward(tp, {}, [a], TCtx())[0],
                           [x], cot)
    assert ty.shape == jy.shape == out_shape
    np.testing.assert_allclose(ty, jy, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)


def test_avg_pool_leaves_padding_out_of_the_count():
    """A corner window of a 3x3 pool with padding 1 over ones holds four
    real elements: their mean is 1 (torch's default would give 4/9)."""
    tp = tpool.Pool2DParams(3, 3, 1, 1, 1, 1, PoolType.POOL_AVG)
    (y,) = tpool._forward(tp, {}, [torch.ones(1, 1, 4, 4)], TCtx())
    assert torch.equal(y, torch.ones(1, 1, 4, 4))


def test_flat_matches_jax():
    rng = np.random.RandomState(3)
    x = _rand(rng, 2, 3, 4, 5)
    cot = _rand(rng, 2, 60)
    jy, (jg,) = _jax_vjp(
        lambda a: jget(JOp.OP_FLAT).forward(None, {}, [a], JCtx())[0], [x],
        cot)
    flat = get_op_def(OperatorType.OP_FLAT)
    ty, (tg,) = _torch_vjp(lambda a: flat.forward(None, {}, [a], TCtx())[0],
                           [x], cot)
    assert ty.shape == (2, 60)
    assert flat.infer(None, [x.shape], [None])[0] == [(2, 60)]
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tg, jg)


# -- BatchNorm --------------------------------------------------------------
def _bn_arrays(seed, c=5, shape=(4, 5, 6, 3)):
    rng = np.random.RandomState(seed)
    x = (1.5 + 2.0 * rng.randn(*shape)).astype(np.float32)
    w = {"scale": (1 + 0.3 * rng.randn(c)).astype(np.float32),
         "bias": (0.2 * rng.randn(c)).astype(np.float32)}
    st = {"running_mean": (0.1 * rng.randn(c)).astype(np.float32),
          "running_var": (1 + 0.1 * rng.rand(c)).astype(np.float32)}
    return x, w, st, _rand(rng, *shape)


def _bn_run(jax_side, relu, training, x, w, st, cot, cdt=None):
    """BatchNorm's stateful forward in one package: (out, grads of x,
    scale, bias, new state)."""
    names = ["scale", "bias"]
    if jax_side:
        p = jnorm.BatchNormParams(relu=relu)
        state = {k: jnp.asarray(v) for k, v in st.items()}
        ctx = JCtx(training=training, compute_dtype=cdt)

        def fn(xa, *ws):
            return jnorm._bn_forward_stateful(p, dict(zip(names, ws)), state,
                                              [xa], ctx)[0][0]

        xin = jnp.asarray(x, jnp.bfloat16) if cdt is not None else x
        y, grads = _jax_vjp(fn, [xin, w["scale"], w["bias"]], cot)
        _, new = jnorm._bn_forward_stateful(
            p, {k: jnp.asarray(v) for k, v in w.items()}, state,
            [jnp.asarray(xin)], ctx)
        new = {k: np.asarray(v) for k, v in new.items()}
    else:
        p = tnorm.BatchNormParams(relu=relu)
        state = {k: torch.from_numpy(v) for k, v in st.items()}
        holder = {}

        def fn(xa, *ws):
            outs, new = tnorm._bn_forward_stateful(
                p, dict(zip(names, ws)), state,
                [xa.to(torch.bfloat16) if cdt is not None else xa],
                TCtx(training=training))
            holder.update(new)
            return outs[0]

        y, grads = _torch_vjp(fn, [x, w["scale"], w["bias"]], cot)
        new = {k: v.detach().numpy() for k, v in holder.items()}
    return y, grads, new


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_matches_jax(relu, training):
    """Training: batch statistics normalize and the running ones move by
    FF's momentum with the BIASED variance; eval: the running statistics
    normalize and come back unchanged."""
    x, w, st, cot = _bn_arrays(4)
    jy, jg, jnew = _bn_run(True, relu, training, x, w, st, cot)
    ty, tg, tnew = _bn_run(False, relu, training, x, w, st, cot)
    np.testing.assert_allclose(ty, jy, rtol=RTOL, atol=ATOL)
    for n, a, b in zip(("x", "scale", "bias"), tg, jg):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=GRAD_ATOL,
                                   err_msg=n)
    assert set(tnew) == set(jnew) == {"running_mean", "running_var"}
    for k in tnew:
        np.testing.assert_allclose(tnew[k], jnew[k], rtol=RTOL, atol=1e-6,
                                   err_msg=k)
    if training:
        xf = x.astype(np.float64)
        biased = xf.var(axis=(0, 2, 3))
        np.testing.assert_allclose(
            tnew["running_var"], 0.9 * st["running_var"] + 0.1 * biased,
            rtol=1e-5)
        np.testing.assert_allclose(
            tnew["running_mean"],
            0.9 * st["running_mean"] + 0.1 * xf.mean(axis=(0, 2, 3)),
            rtol=1e-5, atol=1e-7)
    else:
        for k in tnew:
            np.testing.assert_array_equal(tnew[k], st[k])


@pytest.mark.parametrize("relu", [False, True])
def test_batchnorm_bf16_matches_jax(relu):
    """A bf16 input: statistics and normalization in f32, the output cast
    back to bf16 (one bf16 step apart at most)."""
    x, w, st, cot = _bn_arrays(5)
    jy, jg, jnew = _bn_run(True, relu, True, x, w, st, cot, jnp.bfloat16)
    ty, tg, tnew = _bn_run(False, relu, True, x, w, st, cot, torch.bfloat16)
    _close_bf16(ty, jy, "output")
    for n, a, b in zip(("x", "scale", "bias"), tg, jg):
        _close_bf16(a, b, n)
    for k in tnew:
        np.testing.assert_allclose(tnew[k], jnew[k], rtol=RTOL, atol=1e-6)


def test_batchnorm_without_state_uses_batch_statistics():
    """A caller without state (the stateless forward, or no net_state)
    gets batch statistics and no new state, as in JAX."""
    x, w, _, _ = _bn_arrays(6)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    p = tnorm.BatchNormParams(relu=False)
    outs, new = tnorm._bn_forward_stateful(p, tw, {}, [torch.from_numpy(x)],
                                           TCtx(training=False))
    (plain,) = tnorm._bn_forward(p, tw, [torch.from_numpy(x)], TCtx())
    (jy,) = jnorm._bn_forward(jnorm.BatchNormParams(relu=False),
                              {k: jnp.asarray(v) for k, v in w.items()},
                              [jnp.asarray(x)], JCtx())
    assert new == {}
    assert torch.equal(outs[0], plain)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)


def test_batchnorm_specs_match_jax():
    shapes, dts = [(2, 7, 3, 3)], [None]
    jp, tp = jnorm.BatchNormParams(), tnorm.BatchNormParams()
    assert (tp.relu, tp.momentum, tp.eps) == (jp.relu, jp.momentum, jp.eps)
    for jspecs, tspecs in ((jnorm._bn_weights(jp, shapes, dts),
                            tnorm._bn_weights(tp, shapes, dts)),
                           (jnorm._bn_state(jp, shapes, dts),
                            tnorm._bn_state(tp, shapes, dts))):
        assert ([(s.name, s.shape, s.initializer) for s in tspecs]
                == [(s.name, s.shape, s.initializer) for s in jspecs])
    assert get_op_def(OperatorType.OP_BATCHNORM).forward_stateful is not None
