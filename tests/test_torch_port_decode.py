"""The decode plan of flexflow_tpu_torch (parallel/decode.py) and the
decode step over it, against the JAX package.

Every `_Propagator` rule is driven, accepting and rejecting, on small
graphs built the same way in both packages: the plans must agree op for
op (each output's live and prefix axes, the cached tensors, the static
values live ops read, the static-slicing flag) and a refused graph must
raise DecodeExactnessError with JAX's message. Then the decode-vs-forward
cases of tests/test_serving_qa.py (non-causal and seq-mixing graphs,
linear over the prefix axis, causal cross-attention, primitive-op
attention with and without a causality proof, a baked tril mask, a
static input read by a live op, an overlong cap over baked tables), with
the cached logits held against JAX's step and the full forward, at
scalar and per-row positions; constants in the forward and in training;
and output_probability_like.

Tolerances: f32 on the CPU, logits to atol 1e-4 (XLA and torch sum the
products in other orders; a few layers deep the differences stay ~1e-6
relative). Trained weights: rtol 1e-5, atol 1e-6, the limit of
tests/test_torch_port_train.py.
"""
import numpy as np
import pytest

import flexflow_tpu as jff
import flexflow_tpu_torch as tff
from flexflow_tpu.parallel import decode as jdec
from flexflow_tpu_torch.parallel import decode as tdec
from flexflow_tpu_torch.runtime.weights import params_from_numpy

B, L, E, V = 2, 6, 8, 16
ATOL = 1e-4
RTOL_W, ATOL_W = 1e-5, 1e-6


def _cfg(pkg, batch=B):
    if pkg is tff:
        return tff.FFConfig(batch_size=batch, device="cpu")
    cfg = jff.FFConfig()
    cfg.batch_size = batch
    cfg.workersPerNode = 1
    return cfg


def _ids(m, pkg):
    return m.create_tensor((B, L), pkg.DataType.DT_INT32)


def _live(m, pkg):
    """(B, L, E) live at axis 1."""
    return m.embedding(_ids(m, pkg), V, E, pkg.AggrMode.AGGR_MODE_NONE)


def _scores(m, pkg, x=None):
    """(B, L, L): live at 1, prefix at 2."""
    x = _live(m, pkg) if x is None else x
    return m.batch_matmul(x, m.transpose(x, (0, 2, 1)))


def _tril(pkg):
    mask = np.where(np.tril(np.ones((L, L), bool)), 0.0, -1e9) \
        .astype(np.float32)[None]
    return mask


def _two_inputs(m, pkg):
    """(encoder (B, L+1, E) static, decoder (B, L, E) live)."""
    enc_ids = m.create_tensor((B, L + 1), pkg.DataType.DT_INT32)
    dec_ids = _ids(m, pkg)
    agg = pkg.AggrMode.AGGR_MODE_NONE
    return m.embedding(enc_ids, V, E, agg), m.embedding(dec_ids, V, E, agg)


def _mha(causal):
    def g(m, pkg):
        x = _live(m, pkg)
        m.dense(m.multihead_attention(x, x, x, E, 2, causal=causal), 4)
    return g


def _cross(causal):
    def g(m, pkg):
        enc, x = _two_inputs(m, pkg)
        x = m.multihead_attention(x, x, x, E, 2, causal=True)
        m.dense(m.multihead_attention(x, enc, enc, E, 2, causal=causal), 4)
    return g


def _mha_static_query(m, pkg):
    enc, x = _two_inputs(m, pkg)
    m.dense(m.multihead_attention(enc, x, x, E, 2, causal=True), 4)


def _unary(name, *args):
    def g(m, pkg):
        m.dense(getattr(m, name)(_live(m, pkg), *args), 4)
    return g


def _linear_over_live(m, pkg):
    m.dense(m.transpose(_live(m, pkg), (0, 2, 1)), 4)


def _linear_over_prefix(m, pkg):
    m.dense(m.softmax(_scores(m, pkg), axis=-1), 4)


def _embedding_bag(m, pkg):
    m.dense(m.embedding(_ids(m, pkg), V, E, pkg.AggrMode.AGGR_MODE_SUM), 4)


def _layer_norm(axes):
    def g(m, pkg):
        m.dense(m.layer_norm(_live(m, pkg), axes=axes), 4)
    return g


def _reduce(name, axes, keepdims):
    def g(m, pkg):
        m.dense(getattr(m, name)(_live(m, pkg), axes, keepdims), 4)
    return g


def _mean(dims, keepdims):
    def g(m, pkg):
        m.dense(m.mean(_live(m, pkg), dims, keepdims), 4)
    return g


def _softmax(axis):
    def g(m, pkg):
        m.dense(m.softmax(_live(m, pkg), axis=axis), 4)
    return g


def _transpose(m, pkg):
    m.dense(m.transpose(m.transpose(_live(m, pkg), (1, 0, 2)), (1, 0, 2)), 4)


def _unsqueeze_squeeze(m, pkg):
    t = m.unsqueeze(_live(m, pkg), (1,))          # live -> 2
    m.dense(m.squeeze(t, (1,)), 4)


def _squeeze_live(m, pkg):
    ids = m.create_tensor((B, 1), pkg.DataType.DT_INT32)   # live_len 1
    t = m.embedding(ids, V, E, pkg.AggrMode.AGGR_MODE_NONE)
    m.dense(m.squeeze(t, (1,)), 4)


def _reshape(shape):
    def g(m, pkg):
        t = m.reshape(_live(m, pkg), shape)
        m.dense(t, 4)
    return g


def _reshape_prefix(m, pkg):
    m.dense(m.reshape(_scores(m, pkg), (B, L * L)), 4)


def _add_static(shape):
    """live (B, L, E) + a constant of `shape`: sliced per step when its
    full-length axis aligns with the live axis."""
    def g(m, pkg):
        c = m.create_constant_tensor(
            np.random.RandomState(0).randn(*shape).astype(np.float32),
            pkg.DataType.DT_FLOAT)
        m.dense(m.add(_live(m, pkg), c), 4)
    return g


def _add_crossed(m, pkg):
    s = _scores(m, pkg)
    m.dense(m.add(s, m.transpose(s, (0, 2, 1))), 4)


def _binary(name):
    def g(m, pkg):
        x = _live(m, pkg)
        m.dense(getattr(m, name)(x, m.relu(x)), 4)
    return g


def _concat(kind):
    def g(m, pkg):
        x = _live(m, pkg)
        if kind == "live":
            m.dense(m.concat([x, m.relu(x)], axis=2), 4)
        elif kind == "static":
            c = m.create_constant(dims=(B, L, E), value=0.5)
            m.dense(m.concat([x, c], axis=2), 4)
        else:
            m.dense(m.concat([x, m.relu(x)], axis=1), 4)
    return g


def _split(axis):
    def g(m, pkg):
        a, b = m.split(_live(m, pkg), [L // 2, L // 2] if axis == 1
                       else [E // 2, E // 2], axis)
        m.dense(m.add(a, b), 4)
    return g


def _attention(mask, causal_else=-1e9):
    """Primitive-op attention: scores (+ mask) -> softmax -> @ V."""
    def g(m, pkg):
        x = _live(m, pkg)
        s = _scores(m, pkg, x)
        if mask == "tril":
            s = m.add(s, m.create_constant_tensor(_tril(pkg),
                                                  pkg.DataType.DT_FLOAT))
        elif mask == "sub_tril":
            s = m.subtract(s, m.create_constant_tensor(
                -_tril(pkg), pkg.DataType.DT_FLOAT))
        elif mask == "where":
            keep = m.create_constant_tensor(np.tril(np.ones((1, L, L), bool)),
                                            pkg.DataType.DT_BOOLEAN)
            other = m.create_constant(dims=(1, L, L), value=causal_else)
            s = m.where(keep, s, other)
        m.dense(m.batch_matmul(m.softmax(s, axis=-1), x), 4)
    return g


def _bmm_live_contraction(m, pkg):
    x = _live(m, pkg)
    m.dense(m.batch_matmul(m.transpose(x, (0, 2, 1)), x), 4)


def _bmm_prefix_off_contraction(m, pkg):
    x = _live(m, pkg)
    p = m.transpose(m.softmax(_scores(m, pkg, x), axis=-1), (0, 2, 1))
    m.dense(m.batch_matmul(p, x), 4)


def _bmm_static_rhs(m, pkg):
    """Scores against a static key table of the compiled length."""
    x = _live(m, pkg)
    keys = m.create_constant_tensor(
        np.random.RandomState(1).randn(1, E, L).astype(np.float32),
        pkg.DataType.DT_FLOAT)
    m.dense(m.batch_matmul(x, keys), 4)


def _no_rule(m, pkg):
    m.dense(m.reverse(_live(m, pkg), 1), 4)


# name -> (builder, decode_input, assume_causal, expected outcome)
RULES = {
    "mha_causal": (_mha(True), None, False, "ok"),
    "mha_noncausal": (_mha(False), None, False, "needs causal=True"),
    "mha_cross": (_cross(False), None, False, "ok"),
    "mha_cross_causal": (_cross(True), None, False,
                         "causal cross-attention"),
    "mha_static_query": (_mha_static_query, None, False, "attention query"),
    "relu": (_unary("relu"), None, False, "ok"),
    "gelu": (_unary("gelu"), None, False, "ok"),
    "exp": (_unary("exp"), None, False, "ok"),
    "scalar_multiply": (_unary("scalar_multiply", 3.0), None, False, "ok"),
    "pow": (_unary("pow", 2.0), None, False, "ok"),
    "linear_over_live": (_linear_over_live, None, False,
                         "linear contracts"),
    "linear_over_prefix": (_linear_over_prefix, None, True,
                           "linear contracts"),
    "embedding_bag": (_embedding_bag, None, False, "no decode rule"),
    "layer_norm": (_layer_norm((-1,)), None, False, "ok"),
    "layer_norm_over_live": (_layer_norm((1, 2)), None, False,
                             "layernorm normalizes"),
    "reduce_sum_keep": (_reduce("reduce_sum", (2,), True), None, False,
                        "ok"),
    "reduce_sum_live": (_reduce("reduce_sum", (1,), True), None, False,
                        "reduce over"),
    "mean_drop": (_mean((0,), False), None, False, "ok"),
    "softmax_last": (_softmax(-1), None, False, "ok"),
    "softmax_live": (_softmax(1), None, False, "softmax over the live"),
    "transpose": (_transpose, None, False, "ok"),
    "unsqueeze_squeeze": (_unsqueeze_squeeze, None, False, "ok"),
    "squeeze_live": (_squeeze_live, None, False, "squeeze removes"),
    "reshape_keeps_live": (_reshape((B, L, 2, E // 2)), None, False, "ok"),
    "reshape_merges_live": (_reshape((B, L * E)), None, False,
                            "splits/merges the live axis"),
    "reshape_prefix": (_reshape_prefix, None, True,
                       "reshape of a tensor with a prefix axis"),
    "add_static_table": (_add_static((1, L, E)), None, False, "ok"),
    "add_static_row": (_add_static((E,)), None, False, "ok"),
    "add_crossed": (_add_crossed, None, True,
                    "broadcast to different axes"),
    "multiply": (_binary("multiply"), None, False, "ok"),
    "maximum": (_binary("max"), None, False, "ok"),
    "concat_live": (_concat("live"), None, False, "ok"),
    "concat_static": (_concat("static"), None, False,
                      "concat mixes live and static"),
    "concat_along_live": (_concat("along"), None, False,
                          "concat along the live"),
    "split": (_split(2), None, False, "ok"),
    "split_live": (_split(1), None, False, "split along the live"),
    "attention_unproven": (_attention(None), None, False, "assume_causal"),
    "attention_assumed": (_attention(None), None, True, "ok"),
    "attention_tril": (_attention("tril"), None, False, "ok"),
    "attention_sub_tril": (_attention("sub_tril"), None, False,
                           "assume_causal"),
    "attention_where": (_attention("where"), None, False, "ok"),
    "attention_where_finite": (_attention("where", 0.0), None, False,
                               "assume_causal"),
    "bmm_live_contraction": (_bmm_live_contraction, None, True,
                             "contraction over a live axis"),
    "bmm_prefix_off_contraction": (_bmm_prefix_off_contraction, None, True,
                                   "lhs prefix axis not on the contraction"),
    "bmm_static_rhs": (_bmm_static_rhs, None, False, "ok"),
    "no_rule": (_no_rule, None, False, "no decode rule"),
}


def _model(pkg, builder):
    m = pkg.FFModel(_cfg(pkg))
    builder(m, pkg)
    m.compile(pkg.SGDOptimizer(lr=0.01),
              pkg.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
              [pkg.MetricsType.METRICS_MEAN_SQUARED_ERROR])
    return m


def _plan(m, decode_input, assume_causal):
    ex = m.executor
    dec = jdec if isinstance(m, jff.FFModel) else tdec
    return dec.build_plan(ex.topo, ex.input_pts, ex.constants, decode_input,
                          assume_causal=assume_causal), ex


def _summary(plan, ex):
    """The plan by position: each op's outputs' (live, prefix), the cached
    tensors and the static values read, as (op index, output index) or
    ("input", index)."""
    where = {pt.guid: ("input", i) for i, pt in enumerate(ex.input_pts)}
    where.update({g: ("const", i) for i, g in enumerate(ex.constants)})
    axes = []
    for i, op in enumerate(ex.topo):
        for j, t in enumerate(op.outputs):
            where[t.guid] = (i, j)
            info = plan.info.get(t.guid)
            axes.append(None if info is None else (info.live, info.prefix))
    return {"axes": axes,
            "live_ops": [ex.topo.index(op) for op in plan.live_ops],
            "cached": sorted(where[g] for g in plan.cached_guids),
            "static_needed": [where[g] for g in plan.static_needed],
            "live_len": plan.live_len,
            "cap_le_live_len": plan.requires_cap_le_live_len}


@pytest.mark.parametrize("name", sorted(RULES))
def test_propagator_rule_matches_jax(name):
    builder, decode_input, assume_causal, expect = RULES[name]
    jm, tm = _model(jff, builder), _model(tff, builder)
    outcomes = []
    for m in (jm, tm):
        try:
            outcomes.append(_summary(*_plan(m, decode_input, assume_causal)))
        except NotImplementedError as e:
            outcomes.append(e)
    j, t = outcomes
    if expect == "ok":
        assert not isinstance(t, Exception), t
        assert t == j
    else:
        assert isinstance(t, tdec.DecodeExactnessError), t
        assert isinstance(j, jdec.DecodeExactnessError), j
        assert str(t) == str(j)
        assert expect in str(t)


# -- decode steps against JAX and the full forward ------------------------------

def _pair(builder, batch=B):
    jm = _model(jff, builder)
    tm = _model(tff, builder)
    params_from_numpy(tm, {op: {n: np.asarray(a) for n, a in ws.items()}
                           for op, ws in jm.state.params.items()})
    return jm, tm


def _decode_both(jm, tm, xs, static=(), decode_input=None,
                 assume_causal=False, block=1):
    """A prefill block of `block` positions, then one position a step, in
    both packages; the port's one-token steps alternate scalar and
    per-row positions. Returns the port's and JAX's logits per step."""
    import jax.numpy as jnp

    n = xs.shape[1]
    jinit, jstep = jm.executor.build_decode(
        B, n, decode_input=decode_input, assume_causal=assume_causal)
    tinit, tstep = tm.executor.build_decode(
        B, n, decode_input=decode_input, assume_causal=assume_causal)
    jc = jinit(jm.state.params, list(static))
    tc = tinit(tm.params, list(static))
    got = []
    for a, b in [(0, block)] + [(t, t + 1) for t in range(block, n)]:
        jl, jc = jstep(jm.state.params, jc, jnp.int32(a),
                       [jnp.asarray(xs[:, a:b])])
        t = np.full(B, a, np.int32) if (b - a == 1 and a % 2) else a
        tl, tc = tstep(tm.params, tc, t, [xs[:, a:b]])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        got.append((a, b, tl.numpy()))
    return got


def _against_forward(tm, got, inputs):
    full = tm.executor.build_forward()(tm.params, inputs).numpy()
    for a, b, logits in got:
        np.testing.assert_allclose(logits, full[:, a:b], atol=ATOL)


def _xs(seed, shape=(B, L), vocab=V):
    return np.random.RandomState(seed).randint(0, vocab, shape) \
        .astype(np.int32)


def _lm(m, pkg):
    x = _live(m, pkg)
    for _ in range(2):
        x = m.multihead_attention(x, x, x, E, 2, causal=True)
        x = m.layer_norm(x)
        x = m.dense(x, E, pkg.ActiMode.AC_MODE_RELU)
    m.dense(x, V)


@pytest.mark.parametrize("block", [1, 4])
def test_causal_lm_with_norms_decodes_like_jax_and_the_forward(block):
    """test_serving_qa's decode-vs-forward case: MHA + layer norm + dense
    (the port's decoder-only path refused layer norms before)."""
    jm, tm = _pair(_lm)
    xs = _xs(0)
    _against_forward(tm, _decode_both(jm, tm, xs, block=block), [xs])


@pytest.mark.parametrize("name", ["mha_noncausal", "softmax_live",
                                  "linear_over_prefix", "mha_cross_causal",
                                  "attention_unproven"])
def test_build_decode_refuses_like_jax(name):
    builder = RULES[name][0]
    jm, tm = _model(jff, builder), _model(tff, builder)
    with pytest.raises(jdec.DecodeExactnessError) as je:
        jm.executor.build_decode(B, L)
    with pytest.raises(tdec.DecodeExactnessError) as te:
        tm.executor.build_decode(B, L)
    assert str(te.value) == str(je.value)


def test_unproven_causality_builds_with_assume_causal():
    jm, tm = _pair(_attention(None))
    with pytest.raises(NotImplementedError, match="assume_causal"):
        tm.executor.build_decode(B, L)
    xs = _xs(1)
    got = _decode_both(jm, tm, xs, assume_causal=True)
    assert got[0][2].shape == (B, 1, 4)


@pytest.mark.parametrize("mask", ["tril", "where"])
def test_baked_causal_mask_decodes_like_jax_and_the_forward(mask):
    """Primitive-op attention whose causality a baked constant proves:
    built without assume_causal; the prefix caches and the injected mask
    reproduce the full forward."""
    jm, tm = _pair(_attention(mask))
    xs = _xs(2)
    init, _ = tm.executor.build_decode(B, L)
    # the keys (Q @ K^T's rhs) and the values (probs @ V's rhs)
    assert len(init(tm.params)["prefix"]) == 2
    _against_forward(tm, _decode_both(jm, tm, xs), [xs])
    _against_forward(tm, _decode_both(jm, tm, xs, block=3), [xs])


def test_overlong_cap_with_baked_tables_is_refused_like_jax():
    jm, tm = _pair(_attention("tril"))
    with pytest.raises(NotImplementedError) as je:
        jm.executor.build_decode(B, L + 3)
    with pytest.raises(NotImplementedError) as te:
        tm.executor.build_decode(B, L + 3)
    assert str(te.value) == str(je.value)
    assert "can't be extended" in str(te.value)


def _bias_input(m, pkg):
    dec_ids = _ids(m, pkg)
    bias = m.create_tensor((B, L, E), pkg.DataType.DT_FLOAT)
    t = m.embedding(dec_ids, V, E, pkg.AggrMode.AGGR_MODE_NONE)
    t = m.add(t, bias)
    t = m.multihead_attention(t, t, t, E, 2, causal=True)
    m.dense(t, V)


def test_static_input_read_by_a_live_op_decodes_like_jax():
    """A static graph input added to the decoder stream (decode_input=0):
    kept in the static cache and sliced per step, per row too."""
    from flexflow_tpu.runtime import serving as jserving
    from flexflow_tpu_torch.runtime import serving as tserving

    jm, tm = _pair(_bias_input)
    xs = _xs(3)
    xb = np.random.RandomState(4).randn(B, L, E).astype(np.float32)
    got = _decode_both(jm, tm, xs, static=[xb], decode_input=0)
    _against_forward(tm, got, [xs, xb])
    init, _ = tm.executor.build_decode(B, L, decode_input=0)
    assert len(init(tm.params, [xb])["static"]) == 1
    prompt = xs[:, :3]
    kw = dict(max_new_tokens=3, max_len=L, static_inputs=[xb],
              decode_input=0)
    np.testing.assert_array_equal(
        tserving.incremental_generate(tm, prompt, **kw),
        np.asarray(jserving.incremental_generate(jm, prompt, **kw)))
    with pytest.raises(AssertionError, match="static"):
        tserving.incremental_generate(tm, prompt, max_new_tokens=3,
                                      max_len=L, decode_input=0)


def test_native_cross_attention_decodes_like_jax_and_the_forward():
    jm, tm = _pair(_cross(False))
    xe, xd = _xs(5, (B, L + 1)), _xs(6)
    got = _decode_both(jm, tm, xd, static=[xe])
    _against_forward(tm, got, [xe, xd])
    init, _ = tm.executor.build_decode(B, L)
    caches = init(tm.params, [xe])
    # the encoder states feed only the cross-attention's K/V: folded in
    assert caches["static"] == {} and len(caches["mha_static"]) == 1
    with pytest.raises(AssertionError, match="encoder-side"):
        init(None, [xe])


def test_per_row_positions_slice_static_tables_per_row():
    """Rows at different positions: each reads its own row of a baked
    position table and of a baked mask (per-row gathers), as the same
    rows decoded at a shared position do."""
    jm, tm = _pair(_add_static((1, L, E)))
    del jm
    xs = _xs(7)
    init, step = tm.executor.build_decode(B, L)
    full = tm.executor.build_forward()(tm.params, [xs]).numpy()
    caches = init(tm.params)
    pos = np.array([1, 4], np.int32)
    logits, _ = step(tm.params, caches, pos, [xs[np.arange(B), pos][:, None]])
    np.testing.assert_allclose(logits.numpy()[:, 0],
                               full[np.arange(B), pos], atol=ATOL)
    # primitive-op attention with a baked mask, rows staggered
    _, tm = _pair(_attention("tril"))
    full = tm.executor.build_forward()(tm.params, [xs]).numpy()
    init, step = tm.executor.build_decode(B, L)
    caches = init(tm.params)
    step(tm.params, caches, 0, [xs[:, :2]])
    step(tm.params, caches, np.array([2, 2], np.int32), [xs[:, 2:3]])
    logits, _ = step(tm.params, caches, np.array([3, 3], np.int32),
                     [xs[:, 3:4]])
    np.testing.assert_allclose(logits.numpy()[:, 0], full[:, 3], atol=ATOL)


def test_slice_aligned_matches_jax():
    """_slice_aligned's per-row cases against JAX's vmapped slices: a
    table with a batch axis of the decode batch, of 1, with no batch
    axis, and the batch-position gather (counted as a fallback)."""
    import jax.numpy as jnp
    import torch

    rng = np.random.RandomState(8)
    t = np.array([3, 0, 5], np.int32)
    cases = [((3, L, E), [(1, "live")], 3), ((1, L, E), [(1, "live")], 3),
             ((L, E), [(0, "live")], 3), ((L, L), [(0, "live"),
                                                   (1, "prefix")], 4),
             ((L, E), [(0, "live")], 2)]
    for shape, amap, out_rank in cases:
        v = rng.randn(*shape).astype(np.float32)
        j = jdec._slice_aligned(jnp.asarray(v), amap, jnp.asarray(t), 1, 4,
                                out_rank=out_rank)
        got = tdec._slice_aligned(torch.as_tensor(v), amap,
                                  torch.as_tensor(t), 1, 4,
                                  out_rank=out_rank)
        np.testing.assert_array_equal(got.numpy(), np.asarray(j))
    before = tdec.DECODE_FALLBACK_COUNTS["batch_live_gather"]
    v = rng.randn(L, E).astype(np.float32)
    got = tdec._slice_aligned(torch.as_tensor(v), [(0, "live")],
                              torch.as_tensor(t), 1, 4, out_rank=2)
    np.testing.assert_array_equal(got.numpy(), v[t])
    assert tdec.DECODE_FALLBACK_COUNTS["batch_live_gather"] == before + 1
    with pytest.raises(tdec.DecodeExactnessError, match="neither"):
        tdec._slice_aligned(torch.as_tensor(rng.randn(2, L, E)),
                            [(1, "live")], torch.as_tensor(t), 1, 4,
                            out_rank=3)


# -- constants -----------------------------------------------------------------

def _constants_model(m, pkg):
    x = m.create_tensor((4, 5), pkg.DataType.DT_FLOAT)
    scale = m.create_constant(dims=(4, 5), value=0.5)
    table = m.create_constant_tensor(
        np.arange(5, dtype=np.float32)[None] / 5, pkg.DataType.DT_FLOAT)
    t = m.add(m.multiply(x, scale), table)
    t = m.dense(t, 6, pkg.ActiMode.AC_MODE_RELU)
    m.dense(t, 3)


def test_constants_in_forward_and_training_match_jax():
    def model(pkg):
        m = pkg.FFModel(_cfg(pkg, batch=4))
        _constants_model(m, pkg)
        m.compile(pkg.SGDOptimizer(lr=0.05),
                  pkg.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
                  [pkg.MetricsType.METRICS_MEAN_SQUARED_ERROR])
        return m

    jm, tm = model(jff), model(tff)
    params_from_numpy(tm, {op: {n: np.asarray(a) for n, a in ws.items()}
                           for op, ws in jm.state.params.items()})
    assert len(tm._fit_input_tensors) == 1
    assert sorted(type(v).__name__ for _, v in
                  tm.executor.constants.values()) == ["float", "ndarray"]
    rng = np.random.RandomState(9)
    x = rng.randn(12, 5).astype(np.float32)
    y = rng.randn(12, 3).astype(np.float32)
    np.testing.assert_allclose(
        tm.executor.build_forward()(tm.params, [x[:4]]).numpy(),
        np.asarray(jm.executor.build_forward()(jm.state.params, [x[:4]],
                                               jm.state.net_state)),
        atol=ATOL)
    jm.fit(x, y, epochs=1)
    tm.fit(x, y, epochs=1, verbose=False)
    for op, ws in jm.state.params.items():
        for n, w in ws.items():
            np.testing.assert_allclose(tm.params[op][n].numpy(),
                                       np.asarray(w), rtol=RTOL_W,
                                       atol=ATOL_W)


def test_create_constant_tensor_keeps_values_and_dtype():
    m = tff.FFModel(_cfg(tff))
    arr = np.arange(6).reshape(2, 3)
    t = m.create_constant_tensor(arr)
    assert t.data_type == tff.DataType.DT_INT64
    assert m._constant_values[t.guid].dtype == np.int64
    f = m.create_constant_tensor(arr, tff.DataType.DT_FLOAT)
    assert m._constant_values[f.guid].dtype == np.float32
    c = m.create_constant((2, 3), 7)
    assert m._constant_values[c.guid] == 7.0 and c.dims == (2, 3)


# -- output_probability_like -----------------------------------------------------

def _tail(kind):
    def g(m, pkg):
        x = m.create_tensor((B, E), pkg.DataType.DT_FLOAT)
        if kind == "softmax":
            m.softmax(m.dense(x, 4))
        elif kind == "sigmoid_act":
            m.dense(x, 4, pkg.ActiMode.AC_MODE_SIGMOID)
        elif kind == "softmax_reshape":
            m.reshape(m.softmax(m.dense(x, 4)), (B, 2, 2))
        else:
            m.dense(x, 4)
    return g


@pytest.mark.parametrize("kind", ["softmax", "sigmoid_act", "softmax_reshape",
                                  "logits"])
def test_output_probability_like_matches_jax(kind):
    got = []
    for pkg in (jff, tff):
        m = pkg.FFModel(_cfg(pkg))
        _tail(kind)(m, pkg)
        if pkg is tff:
            assert m.output_probability_like() is None  # not compiled
        m.compile(pkg.SGDOptimizer(lr=0.01),
                  pkg.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
                  [pkg.MetricsType.METRICS_MEAN_SQUARED_ERROR])
        got.append(m.output_probability_like())
    # a shape-only tail outside a fused chain is no value producer's: the
    # reshaped softmax reads as undetermined-logits in both packages
    assert got[0] == got[1] == (kind in ("softmax", "sigmoid_act"))
