"""flexflow_tpu_torch ops against the JAX package's, op by op.

Weights and inputs are made with numpy from a seed and carried into both
packages. f32 throughout on the CPU, where the two differ only in the
order of their sums: atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ff_types import ActiMode as JActiMode
from flexflow_tpu.ops import attention as jattn
from flexflow_tpu.ops import embedding as jemb
from flexflow_tpu.ops import linear as jlin
from flexflow_tpu.ops import softmax as jsm
from flexflow_tpu.ops.registry import FwdCtx as JCtx
from flexflow_tpu_torch.ff_types import ActiMode
from flexflow_tpu_torch.ops import attention as tattn
from flexflow_tpu_torch.ops import embedding as temb
from flexflow_tpu_torch.ops import linear as tlin
from flexflow_tpu_torch.ops import softmax as tsm
from flexflow_tpu_torch.ops.registry import FwdCtx as TCtx

ATOL = 1e-5
E, H = 16, 2


def _mha(causal=True, kdim=0, vdim=0):
    kw = dict(embed_dim=E, num_heads=H, kdim=kdim, vdim=vdim, causal=causal)
    return jattn.MultiHeadAttentionParams(**kw), \
        tattn.MultiHeadAttentionParams(**kw)


def _weights(params, seed):
    rng = np.random.RandomState(seed)
    specs = tattn._weights(params, [(1, 1, E)] * 3, [None] * 3)
    return {s.name: (0.5 * rng.randn(*s.shape)).astype(np.float32)
            for s in specs}


def _both(w):
    return ({n: jnp.asarray(a) for n, a in w.items()},
            {n: torch.from_numpy(a) for n, a in w.items()})


@pytest.mark.parametrize("causal,kdim,vdim", [(True, 0, 0), (False, 0, 0),
                                              (True, 4, 12)])
def test_mha_forward_matches_jax(causal, kdim, vdim):
    jp, tp = _mha(causal, kdim, vdim)
    jw, tw = _both(_weights(tp, 0))
    x = np.random.RandomState(1).randn(2, 7, E).astype(np.float32)
    (jo,) = jattn._forward(jp, jw, [jnp.asarray(x)] * 3, JCtx(training=False))
    (to,) = tattn._forward(tp, tw, [torch.from_numpy(x)] * 3, TCtx())
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)


@pytest.mark.parametrize("impl", ["dense", "paged", "auto"])
def test_mha_forward_decode_matches_jax(impl, monkeypatch):
    """Prefill a 5-token block at t=0, then single-token steps: first with
    every row at one position, then with per-row positions (continuous
    batching). On the CPU "auto" is the dense path and "paged" runs the
    paged kernel's plain version; JAX runs its dense path throughout."""
    monkeypatch.setenv("FF_DECODE_IMPL", impl)
    jp, tp = _mha(True)
    jw, tw = _both(_weights(tp, 2))
    b, max_len = 3, 16
    rng = np.random.RandomState(3)
    jcache = jattn.init_decode_cache(jp, b, max_len, jnp.float32)
    tcache = tattn.init_decode_cache(tp, b, max_len, torch.float32, "cpu")
    jctx, tctx = JCtx(training=False), TCtx()

    def step(x, t):
        nonlocal jcache, tcache
        monkeypatch.setenv("FF_DECODE_IMPL", "auto")
        (jo,), jcache = jattn._forward_decode(
            jp, jw, [jnp.asarray(x)] * 3, jctx, jcache,
            jnp.asarray(t) if isinstance(t, np.ndarray) else t)
        monkeypatch.setenv("FF_DECODE_IMPL", impl)
        (to,), tcache = tattn._forward_decode(
            tp, tw, [torch.from_numpy(x)] * 3, tctx, tcache,
            torch.from_numpy(t) if isinstance(t, np.ndarray) else t)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
        for a, c in zip(tcache, jcache):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=ATOL)

    step(rng.randn(b, 5, E).astype(np.float32), 0)
    for t in (5, 6):
        step(rng.randn(b, 1, E).astype(np.float32), t)
    t_vec = np.array([7, 2, 9], np.int32)
    for _ in range(2):
        step(rng.randn(b, 1, E).astype(np.float32), t_vec)
        t_vec = t_vec + 1


def test_decode_impl_rejects_unknown_value(monkeypatch):
    monkeypatch.setenv("FF_DECODE_IMPL", "fast")
    _, tp = _mha(True)
    tw = _both(_weights(tp, 4))[1]
    cache = tattn.init_decode_cache(tp, 1, 4, torch.float32, "cpu")
    with pytest.raises(ValueError, match="FF_DECODE_IMPL"):
        tattn._forward_decode(tp, tw, [torch.zeros(1, 1, E)] * 3, TCtx(),
                              cache, 0)


@pytest.mark.parametrize("act,bias", [(ActiMode.AC_MODE_RELU, False),
                                      (ActiMode.AC_MODE_NONE, True),
                                      (ActiMode.AC_MODE_GELU, True)])
def test_linear_matches_jax(act, bias):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 8).astype(np.float32)
    w = {"kernel": rng.randn(8, 6).astype(np.float32),
         "bias": rng.randn(6).astype(np.float32)}
    jp = jlin.LinearParams(out_channels=6, use_bias=bias,
                           activation=JActiMode(int(act)))
    tp = tlin.LinearParams(out_channels=6, use_bias=bias, activation=act)
    jw, tw = _both(w)
    (jo,) = jlin._forward(jp, jw, [jnp.asarray(x)], JCtx(training=False))
    (to,) = tlin._forward(tp, tw, [torch.from_numpy(x)], TCtx())
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)


def test_embedding_and_softmax_match_jax():
    rng = np.random.RandomState(6)
    table = rng.randn(11, 4).astype(np.float32)
    ids = rng.randint(0, 11, (2, 5)).astype(np.int32)
    jp = jemb.EmbeddingParams(num_entries=11, out_channels=4)
    tp = temb.EmbeddingParams(num_entries=11, out_channels=4)
    (je,) = jemb._forward(jp, {"weight": jnp.asarray(table)},
                          [jnp.asarray(ids)], JCtx(training=False))
    (te,) = temb._forward(tp, {"weight": torch.from_numpy(table)},
                          [torch.from_numpy(ids)], TCtx())
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    (js,) = jsm._forward(jsm.SoftmaxParams(), {}, [je], None)
    (ts,) = tsm._forward(tsm.SoftmaxParams(), {}, [te], None)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)


def test_mha_weight_specs_match_jax():
    for kd, vd in ((0, 0), (4, 12)):
        jp, tp = _mha(True, kd, vd)
        shapes = [(2, 3, E)] * 3
        js = [(s.name, tuple(s.shape)) for s in
              jattn._weights(jp, shapes, [None] * 3)]
        ts = [(s.name, tuple(s.shape)) for s in
              tattn._weights(tp, shapes, [None] * 3)]
        assert js == ts
