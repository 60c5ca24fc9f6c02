"""Attention dropout and the Dropout op of flexflow_tpu_torch against the
JAX package, on the CPU.

The counter-hash (`_keep_bits`, `attention_dropout_mask`) must equal the
JAX package's bit for bit: the CUDA kernels rebuild the same mask in
native uint32, and the plain versions here are what the kernels are held
against on the card. The plain flash forward and backward with dropout
are held against the JAX Pallas kernels in interpret mode, fed the same
two seeds: f32 to 1e-5 (the two differ only in the order of their sums),
bf16 to one bf16 step of the output (rtol 2^-7; atol 2^-7 for outputs
near 0, where a step is absolute), since both round P and dS at the same
places. The MHA op's dense and flash paths are held against the JAX MHA's
dense dropout path with `dropout_seeds` monkeypatched to one pair in both
packages. The standalone Dropout hashes its flat element index with the
same hash, in int32 (held here to the int64 form and to JAX's bits);
JAX's Dropout draws `jax.random.bernoulli`, so that parity is
statistical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels import attention as jka
from flexflow_tpu.ops import attention as jattn
from flexflow_tpu.ops import dropout as jdrop
from flexflow_tpu.ops.registry import FwdCtx as JCtx
from flexflow_tpu_torch.core.seeds import fold_in, step_seed
from flexflow_tpu_torch.kernels import attention as tka
from flexflow_tpu_torch.ops import attention as tattn
from flexflow_tpu_torch.ops import dropout as tdrop
from flexflow_tpu_torch.ops.registry import FwdCtx as TCtx

ATOL = 1e-5
BF16_STEP = 2.0 ** -7
SEEDS = (0x9E3779B9, 0x01234567)


def _jseeds(seeds):
    return jnp.asarray(np.asarray(seeds, np.uint32))


def _wrapped_indices():
    """Flat (row*sq + q)*sk + k indices of rows whose index passes 2^32,
    wrapped mod 2^32 as both packages wrap them, plus edges and random
    values."""
    sq = sk = 1024
    rows = np.arange(4094, 4098, dtype=np.uint64)   # 4096 * 2^20 == 2^32
    q = np.array([0, 1, 1023], np.uint64)
    k = np.array([0, 1, 1022, 1023], np.uint64)
    idx = ((rows[:, None, None] * sq + q[None, :, None]) * sk
           + k[None, None, :]) % 2 ** 32
    edges = np.array([0, 1, 2 ** 16, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2,
                      2 ** 32 - 1], np.uint64)
    rand = np.random.RandomState(0).randint(0, 2 ** 32, 4096, np.uint64)
    return np.concatenate([idx.ravel(), edges, rand])


@pytest.mark.parametrize("seeds", [(0, 0), SEEDS, (0xFFFFFFFF, 1)])
def test_keep_bits_matches_jax_bit_for_bit(seeds):
    idx = _wrapped_indices()
    assert idx.max() >= 2 ** 32 - 2 and (idx < 2 ** 20).any()
    j = np.asarray(jka._keep_bits(jnp.asarray(idx.astype(np.uint32)),
                                  jnp.uint32(seeds[0]), jnp.uint32(seeds[1])))
    t = tka._keep_bits(torch.from_numpy(idx.astype(np.int64)), *seeds)
    assert t.dtype == torch.int64 and int(t.min()) >= 0
    np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))
    for m in (np.array([0, 5, 2 ** 32 - 1], np.uint64),):
        np.testing.assert_array_equal(
            tka._mix32(torch.from_numpy(m.astype(np.int64))).numpy(),
            np.asarray(jka._mix32(jnp.asarray(m.astype(np.uint32)))))


@pytest.mark.parametrize("seeds", [(0, 0), SEEDS, (0xFFFFFFFF, 1)])
def test_int32_keep_bits_match_jax_bit_for_bit(seeds):
    """The int32 form of the hash (wrapping products, masked shifts) gives
    JAX's bits read as int32, with the seeds as host ints or as 0-d int32
    tensors, and its unsigned comparison keeps what JAX's keeps."""
    idx = _wrapped_indices()
    j = np.asarray(jka._keep_bits(jnp.asarray(idx.astype(np.uint32)),
                                  jnp.uint32(seeds[0]), jnp.uint32(seeds[1])))
    i32 = idx.astype(np.uint32).view(np.int32)
    t = tka._keep_bits_i32(torch.from_numpy(i32.copy()),
                           tka._i32(seeds[0]), tka._i32(seeds[1]))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy().view(np.uint32), j)
    entry = torch.tensor([tka._i32(s) for s in seeds], dtype=torch.int32)
    t2 = tka._keep_bits_i32(torch.from_numpy(i32.copy()), *entry)
    assert torch.equal(t2, t)
    for rate in (0.1, 0.5, 1.0 - 2.0 ** -33):
        thr = tka._drop_threshold(rate)
        np.testing.assert_array_equal(tka._at_least_u32(t, thr).numpy(),
                                      j >= np.uint32(thr))


@pytest.mark.parametrize("salt", [0, 7, 2 ** 31 + 5])
def test_dropout_keep_mask_is_the_hash_of_the_flat_index(salt):
    """The standalone Dropout's mask is the int64 hash of each element's
    flat index under the op's seeds, the salt folded into the second seed,
    from host seeds and from a seed-table entry alike."""
    shape, rate = (3, 5, 77), 0.3
    s1 = SEEDS[1] ^ tka._mix32(salt & tka._M32)
    want = (tka._keep_bits(torch.arange(3 * 5 * 77, dtype=torch.int64),
                           SEEDS[0], s1)
            >= tka._drop_threshold(rate)).view(shape)
    assert torch.equal(tdrop.keep_mask(SEEDS, rate, shape, "cpu", salt), want)
    entry = torch.tensor([tka._i32(s) for s in SEEDS], dtype=torch.int32)
    assert torch.equal(tdrop.keep_mask(entry, rate, shape, "cpu", salt), want)


@pytest.mark.parametrize("bh,sq,sk,rate,seeds", [
    (4, 16, 16, 0.3, SEEDS),
    (3, 7, 5, 0.5, (1, 2)),
    (2, 33, 9, 0.1, (0xFFFFFFFF, 0xFFFFFFFF)),
    (2, 9, 11, 1.0 - 2.0 ** -33, SEEDS),   # threshold capped at 2^32 - 1
    (2, 3, 4, 0.0, SEEDS),
])
def test_attention_dropout_mask_matches_jax(bh, sq, sk, rate, seeds):
    assert tka._drop_threshold(rate) == jka._drop_threshold(rate)
    j = np.asarray(jka.attention_dropout_mask(_jseeds(seeds), rate, bh, sq,
                                              sk))
    t = tka.attention_dropout_mask(seeds, rate, bh, sq, sk)
    assert t.dtype == torch.bool and t.shape == (bh, sq, sk)
    np.testing.assert_array_equal(t.numpy(), j)


def test_mask_rows_past_the_wrap_match_jax_hash():
    """Rows of a launch whose flat index passes 2^32, built alone at their
    row offset, equal the JAX hash of the wrapped indices."""
    sq = sk = 1024
    r0, bh = 4095, 2                       # row 4096 starts at 2^32
    t = tka.attention_dropout_mask(SEEDS, 0.25, bh, sq, sk, _row0=r0)
    rows = np.arange(r0, r0 + bh, dtype=np.uint64)
    idx = ((rows[:, None, None] * sq + np.arange(sq, dtype=np.uint64)[:, None])
           * sk + np.arange(sk, dtype=np.uint64)) % 2 ** 32
    j = np.asarray(jka._keep_bits(jnp.asarray(idx.astype(np.uint32)),
                                  jnp.uint32(SEEDS[0]), jnp.uint32(SEEDS[1]))
                   >= jnp.uint32(jka._drop_threshold(0.25)))
    np.testing.assert_array_equal(t.numpy(), j)
    whole = tka.attention_dropout_mask(SEEDS, 0.25, 6, 8, 8)
    part = tka.attention_dropout_mask(SEEDS, 0.25, 3, 8, 8, _row0=2)
    assert torch.equal(whole[2:5], part)


def _qkv(seed, bh=4, sq=16, sk=16, d=8, dv=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(bh, sq, d).astype(np.float32),
            rng.randn(bh, sk, d).astype(np.float32),
            rng.randn(bh, sk, dv).astype(np.float32),
            rng.randn(bh, sq, dv).astype(np.float32))


def _close(t, j, dtype, what):
    t = t.float().numpy()
    j = np.asarray(jnp.asarray(j, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(t, j, atol=ATOL, err_msg=what)
    else:
        np.testing.assert_allclose(t, j, rtol=BF16_STEP, atol=BF16_STEP,
                                   err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sq,sk,dv,rate", [
    (False, 16, 16, 8, 0.3),
    (True, 16, 16, 8, 0.1),
    (True, 24, 8, 12, 0.5),     # more queries than keys; dv != d
    (False, 8, 24, 8, 0.25),
])
def test_flash_plain_with_dropout_matches_jax_kernels(dtype, causal, sq, sk,
                                                      dv, rate):
    """flash_fwd_plain / flash_bwd_plain against the JAX Pallas kernels in
    interpret mode, both fed the same seeds; the backward takes the JAX
    forward's O and lse."""
    q, k, v, do = _qkv(1, sq=sq, sk=sk, dv=dv)
    jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(getattr(torch, dtype))
                       for x in (q, k, v, do))
    jo, jlse = jka._flash_fwd_folded(jq, jk, jv, causal=causal, interpret=True,
                                     dropout=rate, seeds=_jseeds(SEEDS))
    o, lse = tka._flash_fwd_folded(tq, tk, tv, causal=causal, dropout=rate,
                                   seeds=SEEDS)
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    _close(o, jo, dtype, "o")
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL)
    # dropout moves O, never the softmax statistics
    o0, lse0 = tka._flash_fwd_folded(tq, tk, tv, causal=causal)
    assert torch.equal(lse0, lse) and not torch.equal(o0, o)
    jo_t = torch.from_numpy(np.array(jnp.asarray(jo, jnp.float32))).to(
        tq.dtype)
    jg = jka._flash_bwd_folded(jq, jk, jv, jo, jlse, jdo, causal=causal,
                               interpret=True, dropout=rate,
                               seeds=_jseeds(SEEDS))
    tg = tka._flash_bwd_folded(tq, tk, tv, jo_t,
                               torch.from_numpy(np.asarray(jlse)), tdo,
                               causal=causal, dropout=rate, seeds=SEEDS)
    for name, t, j in zip(("dq", "dk", "dv"), tg, jg):
        assert t.dtype == tq.dtype and t.shape == j.shape
        _close(t, j, dtype, name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_function_with_dropout_matches_jax_grad(causal):
    """The autograd Function keeps the rate and seeds for its backward:
    its gradients equal jax.grad through the JAX custom VJP."""
    q, k, v, w = _qkv(2)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (tka.flash_attention_folded(*leaves, causal, dropout=0.4, seeds=SEEDS)
     * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda a, b, c: jnp.sum(jka.flash_attention_folded(
        a, b, c, causal, interpret=True, dropout=0.4, seeds=_jseeds(SEEDS))
        * w), argnums=(0, 1, 2))(q, k, v)
    for name, t, j in zip(("dq", "dk", "dv"), leaves, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=ATOL,
                                   err_msg=name)


def test_flash_dropout_needs_seeds_like_jax():
    q, k, v, _ = _qkv(3, bh=2, sq=8, sk=8)
    with pytest.raises(ValueError, match="seeds"):
        tka.flash_attention_folded(*map(torch.from_numpy, (q, k, v)), False,
                                   dropout=0.5)
    with pytest.raises(ValueError, match="seeds"):
        jka.flash_attention_folded(q, k, v, False, True, dropout=0.5)


E, H = 16, 2


def _mha_weights(params, seed):
    rng = np.random.RandomState(seed)
    return {s.name: (0.2 * rng.randn(*s.shape)).astype(np.float32)
            for s in tattn._weights(params, [(1, 1, E)] * 3, [None] * 3)}


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_dropout_matches_jax_dense_path(impl, causal, monkeypatch):
    """The port's MHA op in training with dropout 0.3 (its dense path, and
    its folded flash path on the CPU) against the JAX MHA's dense dropout
    path, both handed the same two seeds: outputs and the gradients of
    every weight and input."""
    monkeypatch.setattr(jka, "dropout_seeds", lambda rng: _jseeds(SEEDS))
    monkeypatch.setattr(tka, "dropout_seeds", lambda rng: SEEDS)
    monkeypatch.delenv("FF_ATTENTION_IMPL", raising=False)
    kw = dict(embed_dim=E, num_heads=H, dropout=0.3, causal=causal)
    jp, tp = (jattn.MultiHeadAttentionParams(**kw),
              tattn.MultiHeadAttentionParams(**kw))
    w = _mha_weights(tp, 4)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 7, E).astype(np.float32)
    cot = rng.randn(2, 7, E).astype(np.float32)

    def jloss(ws, xin):
        (o,) = jattn._forward(jp, ws, [xin] * 3,
                              JCtx(training=True, rng=jax.random.PRNGKey(0)))
        return jnp.sum(o * cot), o

    (_, jo), (jgw, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        {n: jnp.asarray(a) for n, a in w.items()}, jnp.asarray(x))
    monkeypatch.setenv("FF_ATTENTION_IMPL", impl)
    tw = {n: torch.from_numpy(a).requires_grad_() for n, a in w.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (to,) = tattn._forward(tp, tw, [tx] * 3, TCtx(training=True, rng=0))
    (to * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=ATOL)
    for n in w:
        np.testing.assert_allclose(tw[n].grad.numpy(), np.asarray(jgw[n]),
                                   atol=ATOL, err_msg=n)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=ATOL)
    # and dropout did act: without an rng the output differs
    (t0,) = tattn._forward(tp, tw, [tx] * 3, TCtx(training=True))
    assert not torch.allclose(t0, to)


def test_mha_draws_its_seeds_from_the_op_rng():
    """Unpatched, the seeds follow the op's seed material: the same rng
    gives the same output, another rng another mask; outside training or
    without an rng no dropout applies."""
    tp = tattn.MultiHeadAttentionParams(embed_dim=E, num_heads=H, dropout=0.5)
    tw = {n: torch.from_numpy(a) for n, a in _mha_weights(tp, 6).items()}
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 8, E)
                         .astype(np.float32))
    run = lambda **kw: tattn._forward(tp, tw, [x] * 3, TCtx(**kw))[0]  # noqa: E731
    assert torch.equal(run(training=True, rng=11), run(training=True, rng=11))
    assert not torch.allclose(run(training=True, rng=11),
                              run(training=True, rng=12))
    assert torch.equal(run(training=True), run(training=False, rng=11))
    assert tka.dropout_seeds(11) == tka.dropout_seeds(11)
    assert all(0 <= s < 2 ** 32 for s in tka.dropout_seeds(2 ** 64 - 1))


def _dropout_run(rate, training=True, rng=3, shape=(100, 1000), seed=0):
    x = torch.from_numpy(np.random.RandomState(8).randn(*shape)
                         .astype(np.float32) + 5.0)   # no zeros in x
    (y,) = tdrop._forward(tdrop.DropoutParams(rate=rate, seed=seed), {}, [x],
                          TCtx(training=training, rng=rng))
    return x, y


def test_dropout_is_identity_where_jax_is():
    x = np.random.RandomState(9).randn(4, 6).astype(np.float32)
    for kw in ({"training": False, "rng": 1}, {"training": True, "rng": None}):
        for rate in (0.0, 0.3):
            (j,) = jdrop._forward(
                jdrop.DropoutParams(rate=rate), {}, [jnp.asarray(x)],
                JCtx(training=kw["training"],
                     rng=None if kw["rng"] is None else jax.random.PRNGKey(1)))
            (t,) = tdrop._forward(tdrop.DropoutParams(rate=rate), {},
                                  [torch.from_numpy(x)], TCtx(**kw))
            assert t is not None
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    (t,) = tdrop._forward(tdrop.DropoutParams(rate=0.0), {},
                          [torch.from_numpy(x)], TCtx(training=True, rng=1))
    np.testing.assert_array_equal(t.numpy(), x)


def test_dropout_keeps_a_binomial_share_scaled_exactly():
    """Rate 0.3 on 10^5 elements: the kept fraction lies within 5 sigma of
    the binomial's mean (JAX's bernoulli draw meets the same bound), and
    every kept value is exactly x / keep."""
    n, keep = 100 * 1000, 0.7
    x, y = _dropout_run(0.3)
    kept = y != 0
    sigma = (keep * (1 - keep) / n) ** 0.5
    assert abs(kept.float().mean().item() - keep) < 5 * sigma
    assert torch.equal(y[kept], x[kept] / keep)
    (j,) = jdrop._forward(jdrop.DropoutParams(rate=0.3), {},
                          [jnp.asarray(x.numpy())],
                          JCtx(training=True, rng=jax.random.PRNGKey(3)))
    assert abs(float(jnp.mean(j != 0)) - keep) < 5 * sigma
    # the draw follows the seed material and the op's seed param
    assert torch.equal(_dropout_run(0.3)[1], y)
    assert not torch.equal(_dropout_run(0.3, rng=4)[1], y)
    assert not torch.equal(_dropout_run(0.3, seed=1)[1], y)


def test_step_and_op_seeds_are_host_ints_like_jax_keys():
    """One draw per step from the model's CPU generator; per op a fold of
    the step seed with the compute index, independent of the order of
    draws."""
    g1, g2 = (torch.Generator().manual_seed(0) for _ in range(2))
    s = step_seed(g1)
    assert isinstance(s, int) and s == step_seed(g2)
    assert step_seed(g1) != s                       # the next step differs
    assert step_seed(7) == 7 and step_seed(None) is None
    ops = [fold_in(s, i) for i in range(4)]
    assert len(set(ops)) == 4 and ops == [fold_in(s, i) for i in range(4)]
    assert all(0 <= v < 2 ** 64 for v in ops)
