"""Single-device streaming attention on flexflow_tpu_torch against the JAX
package's: `chunked_attention`/`_chunk_scan` (causal and not, a key count
that is not a multiple of the chunk, dv != d, query and key offsets,
fully masked rows, gradients), the MHA op's one-device dispatch
(FF_ATTENTION_IMPL=chunked, "auto" past the 256 MiB score budget on the
CPU, dropout falling back to the dense path), and
`build_long_context_transformer` at 64 positions trained three steps,
with "auto" and with "chunked".

Inputs are made with numpy from a seed. f32 on the CPU, where the two
packages differ only in the order of their sums: outputs and the running
max/sum within rtol 1e-5 (atol 1e-6; 1e-5 at 8200 positions, where an
output sums 8200 terms); gradients within rtol 1e-4 (atol
1e-6: a gradient sums a chunk's worth more terms than its output); bf16
outputs within one bf16 step of their value (2^-7, the f32 values they
round from agree to 1e-5); the model's losses and partials within rtol
1e-5 and its weights after three steps within rtol 1e-4, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as jff
from flexflow_tpu import models as jzoo
from flexflow_tpu.kernels import attention as jka
from flexflow_tpu.ops import attention as jattn
from flexflow_tpu.ops.registry import FwdCtx as JCtx
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch import models as tzoo
from flexflow_tpu_torch.ff_types import LossType, MetricsType
from flexflow_tpu_torch.kernels import attention as tka
from flexflow_tpu_torch.ops import attention as tattn
from flexflow_tpu_torch.ops.registry import FwdCtx as TCtx
from flexflow_tpu_torch.runtime.weights import params_from_numpy

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4
# 8200 positions: each output sums 8200 f32 terms (of |v| up to ~4) in
# two orders, so an output near 0 reads up to ~2e-6 apart (measured 1.7e-6)
LONG_ATOL = 1e-5
W_RTOL, W_ATOL = 1e-4, 1e-5
BF16_STEP = 2.0 ** -7


def _qkv(b, sq, sk, h, d, dv, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, sk, h, d).astype(np.float32),
            rng.randn(b, sk, h, dv).astype(np.float32))


_SCANS = {
    # name: (b, sq, sk, h, d, dv, causal, chunk, q_offset, kv_offset)
    "multiple": (2, 64, 64, 3, 16, 16, False, 16, 0, 0),
    "multiple_causal": (2, 64, 64, 3, 16, 16, True, 16, 0, 0),
    "ragged": (2, 50, 50, 2, 16, 16, False, 16, 0, 0),
    "ragged_causal": (2, 50, 50, 2, 16, 16, True, 16, 0, 0),
    "dv_ne_d": (1, 40, 70, 2, 8, 24, True, 32, 0, 0),
    "offsets": (2, 24, 40, 2, 16, 16, True, 16, 16, 0),
    # every key of a row past its query: the row stays at m = -1e30
    "masked_rows": (1, 20, 36, 2, 16, 16, True, 16, 0, 10),
    "one_chunk": (1, 12, 12, 1, 8, 8, False, 64, 0, 0),
}


@pytest.mark.parametrize("name", sorted(_SCANS))
def test_chunk_scan_matches_jax(name):
    b, sq, sk, h, d, dv, causal, chunk, qo, ko = _SCANS[name]
    q, k, v = _qkv(b, sq, sk, h, d, dv, 0)
    chunk = min(chunk, sk)
    jo, jm, jl = jka._chunk_scan(*(jnp.asarray(a) for a in (q, k, v)),
                                 causal=causal, chunk_size=chunk,
                                 q_offset=qo, kv_offset=ko)
    to, tm, tl = tka._chunk_scan(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=causal, chunk_size=chunk,
                                 q_offset=qo, kv_offset=ko)
    assert to.shape == (b, sq, h, dv) and to.dtype == torch.float32
    for t, j, what in ((to, jo, "out"), (tm, jm, "m"), (tl, jl, "l")):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} {what}")


@pytest.mark.parametrize("causal", [False, True])
def test_chunked_attention_matches_jax_in_bf16(causal):
    """bf16 operands: both take the scores from the bf16 values in f32
    and round the output to bf16 once."""
    q, k, v = _qkv(2, 48, 48, 2, 16, 16, 1)
    jo = jka.chunked_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=causal,
        chunk_size=16)
    to = tka.chunked_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal=causal, chunk_size=16)
    assert to.dtype == torch.bfloat16
    j = np.asarray(jo.astype(jnp.float32))
    np.testing.assert_allclose(to.float().numpy(), j, rtol=BF16_STEP,
                               atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_chunked_attention_gradients_match_jax(causal):
    """d(sum(out * w))/d(q, k, v) through autograd and jax.grad, with a
    key count that is not a multiple of the chunk."""
    q, k, v = _qkv(2, 30, 30, 2, 8, 12, 2)
    w = np.random.RandomState(3).randn(2, 30, 2, 12).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(jka.chunked_attention(q_, k_, v_, causal=causal,
                                             chunk_size=8) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tka.chunked_attention(*ts, causal=causal, chunk_size=8)
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for t, j, what in zip(tg, jg, "qkv"):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=GRAD_RTOL,
                                   atol=ATOL, err_msg=f"d{what}")


def test_local_attention_off_the_card_is_chunked_attention():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 40, 40, 2, 8, 8, 4))
    for causal in (False, True):
        assert torch.equal(tka.local_attention(q, k, v, causal=causal),
                           tka.chunked_attention(q, k, v, causal=causal))


def test_flash_attention_in_bshd_is_the_folded_core():
    """`flash_attention` folds (b, s, h, d) into the kernels' layout and
    back: on the CPU, the plain versions against the dense reference."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 24, 24, 3, 8, 8, 5))
    out = tka.flash_attention(q, k, v, True)
    keep = torch.ones(24, 24, dtype=torch.bool).tril()
    ref = tattn._dense_attention(q, k, v, keep)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=RTOL,
                               atol=ATOL)


# -- the MHA op's one-device dispatch ---------------------------------------

E, HEADS = 8, 1


def _mha_weights(causal, seed=0):
    kw = dict(embed_dim=E, num_heads=HEADS, causal=causal)
    jp, tp = (jattn.MultiHeadAttentionParams(**kw),
              tattn.MultiHeadAttentionParams(**kw))
    rng = np.random.RandomState(seed)
    w = {s.name: (0.5 * rng.randn(*s.shape)).astype(np.float32)
         for s in tattn._weights(tp, [(1, 1, E)] * 3, [None] * 3)}
    return (jp, {n: jnp.asarray(a) for n, a in w.items()},
            tp, {n: torch.from_numpy(a) for n, a in w.items()})


class _Spy:
    """Counts the calls of a kernels.attention function (and runs it)."""

    def __init__(self, monkeypatch, name):
        self.calls = 0
        fn = getattr(tka, name)

        def spy(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)

        monkeypatch.setattr(tka, name, spy)


@pytest.mark.parametrize("causal", [False, True])
def test_forced_chunked_runs_chunked_attention_like_jax(causal, monkeypatch):
    jp, jw, tp, tw = _mha_weights(causal)
    x = np.random.RandomState(6).randn(2, 40, E).astype(np.float32)
    monkeypatch.setenv("FF_ATTENTION_IMPL", "chunked")
    spy = _Spy(monkeypatch, "chunked_attention")
    (jo,) = jattn._forward(jp, jw, [jnp.asarray(x)] * 3, JCtx(training=False))
    (to,) = tattn._forward(tp, tw, [torch.from_numpy(x)] * 3, TCtx())
    assert spy.calls == 1
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                               atol=ATOL)


def test_auto_past_the_score_budget_streams_on_the_cpu(monkeypatch):
    """One row of one head at 8200 positions: 4 * 8200^2 B of f32 scores
    (269 MB) pass the 256 MiB budget, so "auto" streams through
    chunked_attention, as JAX's auto does on its CPU backend; the dense
    path is never reached."""
    s = 8200
    assert 4 * s * s > tattn.STREAMING_SCORE_BYTES == 256 * 1024 * 1024
    jp, jw, tp, tw = _mha_weights(True, 7)
    x = np.random.RandomState(8).randn(1, s, E).astype(np.float32)
    monkeypatch.delenv("FF_ATTENTION_IMPL", raising=False)
    chunked = _Spy(monkeypatch, "chunked_attention")
    dense = []
    monkeypatch.setattr(tattn, "_dense_attention",
                        lambda *a, **kw: dense.append(1))
    (jo,) = jattn._forward(jp, jw, [jnp.asarray(x)] * 3, JCtx(training=False))
    (to,) = tattn._forward(tp, tw, [torch.from_numpy(x)] * 3, TCtx())
    assert (chunked.calls, dense) == (1, [])
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                               atol=LONG_ATOL)


def test_auto_under_the_budget_stays_dense_on_the_cpu(monkeypatch):
    jp, jw, tp, tw = _mha_weights(False)
    x = np.random.RandomState(9).randn(2, 32, E).astype(np.float32)
    monkeypatch.delenv("FF_ATTENTION_IMPL", raising=False)
    chunked = _Spy(monkeypatch, "chunked_attention")
    (to,) = tattn._forward(tp, tw, [torch.from_numpy(x)] * 3, TCtx())
    assert chunked.calls == 0
    (jo,) = jattn._forward(jp, jw, [jnp.asarray(x)] * 3, JCtx(training=False))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                               atol=ATOL)


def test_chunked_with_dropout_falls_back_to_dense(monkeypatch):
    """chunked_attention threads no dropout rng: with dropout in training
    the op takes the dense path with its mask, warning once per op, as
    the JAX package does."""
    kw = dict(embed_dim=E, num_heads=2, dropout=0.25)
    jp, tp = (jattn.MultiHeadAttentionParams(**kw),
              tattn.MultiHeadAttentionParams(**kw))
    rng = np.random.RandomState(10)
    w = {s.name: (0.5 * rng.randn(*s.shape)).astype(np.float32)
         for s in tattn._weights(tp, [(1, 1, E)] * 3, [None] * 3)}
    tw = {n: torch.from_numpy(a) for n, a in w.items()}
    x = [torch.from_numpy(rng.randn(2, 16, E).astype(np.float32))] * 3

    def run(name):
        return tattn._forward(tp, tw, x, TCtx(training=True, rng=1234,
                                              op_name=name))[0]

    monkeypatch.setenv("FF_ATTENTION_IMPL", "dense")
    dense = run("a")
    monkeypatch.setenv("FF_ATTENTION_IMPL", "chunked")
    chunked = _Spy(monkeypatch, "chunked_attention")
    with pytest.warns(UserWarning, match="falls back to the dense path"):
        out = run("fallback_op")
    assert torch.equal(out, dense) and chunked.calls == 0
    with pytest.warns(UserWarning, match="falls back to the dense path"):
        jattn._forward(jp, {n: jnp.asarray(a) for n, a in w.items()},
                       [jnp.asarray(x[0].numpy())] * 3,
                       JCtx(training=True, rng=jax.random.PRNGKey(0),
                            op_name="fallback_op"))


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_impls_raise(impl, monkeypatch):
    _, _, tp, tw = _mha_weights(False)
    monkeypatch.setenv("FF_ATTENTION_IMPL", impl)
    with pytest.raises(NotImplementedError, match="multi-device"):
        tattn._forward(tp, tw, [torch.zeros(1, 4, E)] * 3, TCtx())


# -- the long-context model -------------------------------------------------

B, SEQ, HIDDEN, LC_HEADS, LAYERS = 2, 64, 32, 4, 2


def _build(ff, m):
    return (jzoo if ff is jff else tzoo).build_long_context_transformer(
        m, B, SEQ, HIDDEN, LC_HEADS, LAYERS)


def _pair():
    cfg = jff.FFConfig()
    cfg.batch_size = B
    cfg.workersPerNode = 1
    jm = jff.FFModel(cfg)
    _build(jff, jm)
    jm.compile(jff.SGDOptimizer(lr=0.01),
               jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [jff.MetricsType.METRICS_ACCURACY])
    tm = FFModel(FFConfig(batch_size=B, device="cpu"))
    _build(None, tm)
    tm.compile(SGDOptimizer(lr=0.01),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY])
    params_from_numpy(tm, {op: {n: np.asarray(a) for n, a in ws.items()}
                           for op, ws in jm.state.params.items()})
    return jm, tm


def test_long_context_defaults_are_jax_defaults():
    import inspect

    for name in ("batch_size", "seq_length", "hidden_size", "num_heads",
                 "num_layers", "num_classes"):
        assert (inspect.signature(tzoo.build_long_context_transformer)
                .parameters[name].default
                == inspect.signature(jzoo.build_long_context_transformer)
                .parameters[name].default), name


@pytest.mark.parametrize("impl", ["auto", "chunked"])
def test_long_context_transformer_three_steps_match_jax(impl, monkeypatch):
    monkeypatch.setenv("FF_ATTENTION_IMPL", impl)
    chunked = _Spy(monkeypatch, "chunked_attention")
    jm, tm = _pair()
    assert [op.name for op in tm.executor.topo] == \
        [op.name for op in jm.executor.topo]
    rng = np.random.RandomState(11)
    x = rng.randn(3 * B, SEQ, HIDDEN).astype(np.float32)
    y = rng.randint(0, 10, (3 * B, SEQ, 1)).astype(np.int32)
    jstep, tstep = jm.executor.build_train_step(), \
        tm.executor.build_train_step()
    jst, tst = jm.state, tm.state
    for i in range(3):
        bx, by = [x[i * B:(i + 1) * B]], y[i * B:(i + 1) * B]
        jst, jp = jstep(jst, bx, by, jax.random.PRNGKey(0))
        tst, tp = tstep(tst, bx, by)
        for k in tp:
            np.testing.assert_allclose(float(tp[k]), float(jp[k]), rtol=RTOL,
                                       err_msg=f"{impl} step {i} {k}")
    # chunked: each step runs each layer's attention forward once
    assert chunked.calls == (3 * LAYERS if impl == "chunked" else 0)
    for op, ws in tst.params.items():
        for n, w in ws.items():
            np.testing.assert_allclose(w.numpy(),
                                       np.asarray(jst.params[op][n]),
                                       rtol=W_RTOL, atol=W_ATOL,
                                       err_msg=f"{impl} {op}.{n}")
