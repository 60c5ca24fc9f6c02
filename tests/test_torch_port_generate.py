"""Encoder-decoder generation on flexflow_tpu_torch against the JAX package.

The model is a 2+2-layer, width-64 copy of Transformer (big) (Vaswani et
al. 2017, Table 3: post-LN residual blocks, ReLU FFN, sinusoidal
positions as constant tensors, embeddings scaled by sqrt(d_model)), built
through each package's FFModel API with the same layer sequence; the
weights go across from the JAX model by params_from_numpy. Then the four
generation APIs (greedy_generate, incremental_seq2seq_generate,
incremental_beam_generate, beam_generate), NMT's full-forward beam search
(its LSTMs have no decode rule, so both packages refuse the KV-cached
path), the beam scorer's helpers, compile_decode's search and strategy
files, and the continuous batcher on the decode executor.

Tolerances: f32 on the CPU. Logits agree to atol 1e-4 (XLA and torch sum
the products in other orders; each layer norm keeps the activations near
unit scale, so the differences stay ~1e-6 relative through 4 blocks).
Tokens must be equal. Decode costs are the same host arithmetic in both
packages: rel 1e-12, as tests/test_torch_port_search.py holds them.
"""
import math

import numpy as np
import pytest

import flexflow_tpu as jff
import flexflow_tpu_torch as tff
from flexflow_tpu.models.nmt import build_nmt as jbuild_nmt
from flexflow_tpu.parallel import decode as jdec
from flexflow_tpu.runtime import serving as jserving
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu_torch.models import build_nmt as tbuild_nmt
from flexflow_tpu_torch.parallel import decode as tdec
from flexflow_tpu_torch.runtime import serving as tserving
from flexflow_tpu_torch.runtime.weights import params_from_numpy

BATCH, SRC, DEC, VOCAB = 4, 8, 8, 61
D_MODEL, HEADS, D_FF, ENC_LAYERS, DEC_LAYERS = 64, 4, 128, 2, 2
ATOL = 1e-4
COST_RTOL = 1e-12


def sinusoid(n, d):
    """The paper's positional encoding (section 3.5), (n, d) float32."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(d // 2, dtype=np.float64)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.zeros((n, d))
    out[:, 0::2], out[:, 1::2] = np.sin(ang), np.cos(ang)
    return out.astype(np.float32)


def build_seq2seq(m, pkg, batch=BATCH, src_len=SRC, dec_len=DEC,
                  vocab=VOCAB, d=D_MODEL, heads=HEADS, d_ff=D_FF,
                  enc_layers=ENC_LAYERS, dec_layers=DEC_LAYERS):
    """Transformer (big)'s graph at the given sizes; returns the logits."""
    dt, acti = pkg.DataType, pkg.ActiMode
    src = m.create_tensor((batch, src_len), dt.DT_INT32)
    tgt = m.create_tensor((batch, dec_len), dt.DT_INT32)

    def embed(ids, n):
        e = m.embedding(ids, vocab, d, pkg.AggrMode.AGGR_MODE_NONE)
        e = m.scalar_multiply(e, math.sqrt(d))
        return m.add(e, m.create_constant_tensor(sinusoid(n, d)[None],
                                                 dt.DT_FLOAT))

    def ffn(x):
        f = m.dense(x, d_ff, acti.AC_MODE_RELU)
        return m.layer_norm(m.add(x, m.dense(f, d)))

    e = embed(src, src_len)
    for _ in range(enc_layers):
        e = m.layer_norm(m.add(e, m.multihead_attention(e, e, e, d, heads)))
        e = ffn(e)
    x = embed(tgt, dec_len)
    for _ in range(dec_layers):
        x = m.layer_norm(m.add(x, m.multihead_attention(
            x, x, x, d, heads, causal=True)))
        x = m.layer_norm(m.add(x, m.multihead_attention(x, e, e, d, heads)))
        x = ffn(x)
    return m.dense(x, vocab)


def _jax_cfg(**kw):
    cfg = jff.FFConfig()
    cfg.workersPerNode = 1
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _pair(builder, batch=BATCH, loss=None, **cfg):
    """The same graph compiled in both packages, JAX's weights in the
    port."""
    jm = jff.FFModel(_jax_cfg(batch_size=batch, **cfg))
    builder(jm, jff)
    jm.compile(jff.SGDOptimizer(lr=0.01),
               loss or jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [jff.MetricsType.METRICS_ACCURACY])
    tm = tff.FFModel(tff.FFConfig(batch_size=batch, device="cpu", **cfg))
    builder(tm, tff)
    tm.compile(tff.SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy")
    params_from_numpy(tm, {op: {n: np.asarray(a) for n, a in ws.items()}
                           for op, ws in jm.state.params.items()})
    return jm, tm


@pytest.fixture(scope="module")
def s2s():
    return _pair(build_seq2seq)


def _ids(seed, shape, lo=0):
    return np.random.RandomState(seed).randint(lo, VOCAB, shape) \
        .astype(np.int32)


def test_full_forward_with_position_constants_matches_jax(s2s):
    jm, tm = s2s
    xs, xd = _ids(0, (BATCH, SRC)), _ids(1, (BATCH, DEC))
    jl = jm.executor.build_forward()(jm.state.params, [xs, xd],
                                     jm.state.net_state)
    tl = tm.executor.build_forward()(tm.params, [xs, xd])
    assert tl.shape == (BATCH, DEC, VOCAB)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    # the position tables are the executors' constants, not batch inputs
    assert len(tm.executor.constants) == 2
    assert len(tm._fit_input_tensors) == 2


@pytest.mark.parametrize("per_row", [False, True])
def test_cached_steps_match_jax_and_the_full_forward(s2s, per_row):
    """Every decoder position through the decode step (scalar or per-row
    positions) against JAX's step and the port's own full forward; a
    prefill block of 3 then single tokens."""
    import jax.numpy as jnp

    jm, tm = s2s
    xs, xd = _ids(2, (BATCH, SRC)), _ids(3, (BATCH, DEC))
    jinit, jstep = jm.executor.build_decode(BATCH, DEC)
    tinit, tstep = tm.executor.build_decode(BATCH, DEC)
    jc, tc = jinit(jm.state.params, [xs]), tinit(tm.params, [xs])
    assert set(tc) == {"static", "prefix", "mha", "mha_static"}
    assert len(tc["mha"]) == DEC_LAYERS and len(tc["mha_static"]) == \
        DEC_LAYERS
    full = tm.executor.build_forward()(tm.params, [xs, xd]).numpy()
    for a, b in [(0, 3)] + [(t, t + 1) for t in range(3, DEC)]:
        jl, jc = jstep(jm.state.params, jc, jnp.int32(a),
                       [jnp.asarray(xd[:, a:b])])
        t = np.full(BATCH, a, np.int32) if per_row and b - a == 1 else a
        tl, tc = tstep(tm.params, tc, t, [xd[:, a:b]])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        np.testing.assert_allclose(tl.numpy(), full[:, a:b], atol=ATOL)


def test_greedy_and_incremental_seq2seq_match_jax(s2s):
    jm, tm = s2s
    xs = _ids(4, (BATCH, SRC))
    jg = jserving.greedy_generate(jm, xs, max_new_tokens=6)
    tg = tserving.greedy_generate(tm, xs, max_new_tokens=6)
    np.testing.assert_array_equal(tg, np.asarray(jg))
    ji = jserving.incremental_seq2seq_generate(jm, xs, max_new_tokens=6)
    ti = tserving.incremental_seq2seq_generate(tm, xs, max_new_tokens=6)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_array_equal(ti, tg)
    te = tserving.incremental_seq2seq_generate(tm, xs, max_new_tokens=6,
                                               _eager=True)
    np.testing.assert_array_equal(te, ti)


def test_eos_stops_both_greedy_paths_like_jax(s2s):
    """An EOS id that greedy emits ends those rows (pad after it) and,
    once every row has ended, the loop."""
    jm, tm = s2s
    xs = _ids(5, (BATCH, SRC))
    first = tserving.greedy_generate(tm, xs, max_new_tokens=3)
    eos = int(first[0, 2])
    for fn in ("greedy_generate", "incremental_seq2seq_generate"):
        j = getattr(jserving, fn)(jm, xs, max_new_tokens=6, eos_token_id=eos,
                                  pad_token_id=VOCAB - 1)
        t = getattr(tserving, fn)(tm, xs, max_new_tokens=6, eos_token_id=eos,
                                  pad_token_id=VOCAB - 1)
        np.testing.assert_array_equal(t, np.asarray(j))


def test_incremental_beam_matches_jax_and_beam_generate(s2s):
    jm, tm = s2s
    xs = _ids(6, (3, SRC))
    starts = np.zeros((3, 1), np.int32)
    jb = jserving.incremental_beam_generate(
        jm, starts, num_beams=3, max_new_tokens=5, max_len=DEC,
        encoder_ids=xs)
    tb = tserving.incremental_beam_generate(
        tm, starts, num_beams=3, max_new_tokens=5, max_len=DEC,
        encoder_ids=xs)
    np.testing.assert_array_equal(tb, np.asarray(jb))
    te = tserving.incremental_beam_generate(
        tm, starts, num_beams=3, max_new_tokens=5, max_len=DEC,
        encoder_ids=xs, _eager=True)
    np.testing.assert_array_equal(te, tb)
    jfull = jserving.beam_generate(jm, xs, num_beams=3, max_new_tokens=5)
    tfull = tserving.beam_generate(tm, xs, num_beams=3, max_new_tokens=5)
    np.testing.assert_array_equal(tfull, np.asarray(jfull))
    # the same objective over the same forward: the incremental search
    # picks the full-forward search's beams
    np.testing.assert_array_equal(tb, tfull)


def test_one_beam_is_greedy(s2s):
    _, tm = s2s
    xs = _ids(7, (BATCH, SRC))
    greedy = tserving.greedy_generate(tm, xs, max_new_tokens=5)
    np.testing.assert_array_equal(
        tserving.beam_generate(tm, xs, num_beams=1, max_new_tokens=5), greedy)
    np.testing.assert_array_equal(
        tserving.incremental_beam_generate(
            tm, np.zeros((BATCH, 1), np.int32), num_beams=1,
            max_new_tokens=5, max_len=DEC, encoder_ids=xs), greedy)


def test_beam_reorder_is_in_place_and_skips_statics(s2s):
    """A reorder gathers the prefix and attention caches into the same
    tensors (a captured step keeps replaying on them) and leaves the
    static values and the cross-attention K/V alone."""
    _, tm = s2s
    init, step = tm.executor.build_decode(3, DEC)
    caches = init(tm.params, [np.broadcast_to(_ids(8, (1, SRC)),
                                              (3, SRC)).copy()])
    step(tm.params, caches, 0, [_ids(9, (3, 2))])
    before = {id(t): t.clone() for t in tserving._tensors(caches)}
    ptrs = [t.data_ptr() for t in tserving._tensors(caches)]
    order = np.array([2, 0, 0])
    tserving._reorder_beams(caches, order)
    assert [t.data_ptr() for t in tserving._tensors(caches)] == ptrs
    for k, v in caches["mha"].values():
        for x in (k, v):
            np.testing.assert_array_equal(x.numpy(),
                                          before[id(x)].numpy()[order])
    for x in tserving._tensors({"s": caches["static"],
                                "m": caches["mha_static"]}):
        np.testing.assert_array_equal(x.numpy(), before[id(x)].numpy())


def test_helpers_match_jax():
    rng = np.random.RandomState(10)
    x = rng.randn(5, 17).astype(np.float32)
    p = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    np.testing.assert_allclose(tserving._log_softmax(x),
                               jserving._log_softmax(x), rtol=1e-6)
    for arr, hint in ((x, None), (x, False), (p, None), (p, True),
                      (p, False)):
        np.testing.assert_allclose(tserving._as_log_probs(arr, hint),
                                   jserving._as_log_probs(arr, hint),
                                   rtol=1e-6)
    for k in (1, 3, 5):
        scores = rng.randn(k)
        done = rng.rand(k) < 0.4
        logp = tserving._log_softmax(rng.randn(k, 17))
        t = tserving._beam_topk(scores, logp, done, 0, k)
        j = jserving._beam_topk(scores, logp, done, 0, k)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


# -- NMT: full-forward beam search only ----------------------------------------

def _nmt(m, pkg):
    (jbuild_nmt if pkg is jff else tbuild_nmt)(
        m, 4, src_vocab=40, tgt_vocab=40, src_len=6, tgt_len=6,
        embed_dim=16, hidden=24, num_layers=1)


@pytest.fixture(scope="module")
def nmt():
    return _pair(_nmt)


def test_nmt_beam_generate_matches_jax(nmt):
    jm, tm = nmt
    assert tm.output_probability_like() is True
    assert jm.output_probability_like() is True
    xs = np.random.RandomState(11).randint(0, 40, (3, 6)).astype(np.int32)
    jb = jserving.beam_generate(jm, xs, num_beams=3, max_new_tokens=4)
    tb = tserving.beam_generate(tm, xs, num_beams=3, max_new_tokens=4)
    np.testing.assert_array_equal(tb, np.asarray(jb))
    np.testing.assert_array_equal(
        tserving.beam_generate(tm, xs, num_beams=1, max_new_tokens=4),
        tserving.greedy_generate(tm, np.concatenate([xs, xs[:1]]),
                                 max_new_tokens=4)[:3])


def test_nmt_refuses_the_kv_cached_path_like_jax(nmt):
    jm, tm = nmt
    xs = np.zeros((4, 6), np.int32)
    with pytest.raises(jdec.DecodeExactnessError) as je:
        jserving.incremental_seq2seq_generate(jm, xs, max_new_tokens=2)
    with pytest.raises(tdec.DecodeExactnessError) as te:
        tserving.incremental_seq2seq_generate(tm, xs, max_new_tokens=2)
    assert str(te.value) == str(je.value)
    assert "LSTM" in str(te.value)


# -- compile_decode and the batcher on its executor ----------------------------

LM_VOCAB, LM_SEQ, LM_HIDDEN, LM_HEADS = 48, 16, 32, 4


def _lm(m, pkg):
    """The serving LM's block (tests/test_torch_port_slice.py)."""
    ids = m.create_tensor((2, LM_SEQ), pkg.DataType.DT_INT32)
    t = m.embedding(ids, LM_VOCAB, LM_HIDDEN, pkg.AggrMode.AGGR_MODE_NONE)
    for _ in range(2):
        t = m.multihead_attention(t, t, t, LM_HIDDEN, LM_HEADS, causal=True)
        t = m.dense(t, LM_HIDDEN, pkg.ActiMode.AC_MODE_RELU, use_bias=False)
        t = m.dense(t, LM_HIDDEN, use_bias=False)
    return m.softmax(m.dense(t, LM_VOCAB))


def _machine_file(tmp_path, workers):
    p = tmp_path / f"machine_{workers}.cfg"
    p.write_text(f"num_nodes = 1\nnum_gpus_per_node = {workers}\n"
                 "intra_node_bandwidth = 90e9\ninter_node_bandwidth = 25e9\n")
    return str(p)


def _views_by_position(graph, views):
    pos = {op.guid: i for i, op in enumerate(graph.topo_order())}
    return sorted((pos.get(g, -1), (v.start_device_id, tuple(v.dim),
                                    tuple(v.stride)))
                  for g, v in views.items())


@pytest.fixture
def no_jax_calibration(monkeypatch):
    """The JAX side prices with the analytic roofline alone, as the port
    does."""
    monkeypatch.setattr(jcm, "load_default_calibration", lambda: None)


@pytest.mark.parametrize("workers", [1, 4])
def test_compile_decode_matches_jax(tmp_path, no_jax_calibration, workers):
    jm, tm = _pair(_lm, batch=2, search_budget=3,
                   machine_model_file=_machine_file(tmp_path, workers))
    jex, tex = jm.compile_decode(), tm.compile_decode()
    assert tex is tm.decode_executor and tm.decode_graph is tex.graph
    assert tm._build_cost_model("decode").objective == "decode"
    np.testing.assert_allclose(tm.decode_searched_cost,
                               jm.decode_searched_cost, rtol=COST_RTOL)
    assert _views_by_position(tm.decode_graph, tm.decode_searched_views) \
        == _views_by_position(jm.decode_graph, jm.decode_searched_views)
    assert [op.op_type.name for op in tm.decode_graph.topo_order()] == \
        [op.op_type.name for op in jm.decode_graph.topo_order()]
    phases = [e["name"] for e in tm.decode_trajectory.of_kind("phase")]
    assert phases == ["decode_lowering", "decode_strategy_search",
                      "decode_executor_build"]
    # demoted to the one device, serving the training weights by name
    assert all(d.degree == 1 or d.is_replica_dim
               for op in tm.decode_graph.ops
               for t in op.outputs + op.weights for d in t.dims)
    prompt = np.random.RandomState(12).randint(0, LM_VOCAB, (2, 4)) \
        .astype(np.int32)
    init, step = tex.build_decode(2, LM_SEQ)
    logits, _ = step(tm.params, init(tm.params), 0, [prompt])
    ref = tm.executor.build_forward()(tm.params, [np.pad(
        prompt, ((0, 0), (0, LM_SEQ - 4)))])[:, :4]
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=ATOL)


def test_decode_strategy_round_trip(tmp_path, no_jax_calibration):
    """A decode strategy the port exports imports into the port (same
    views, no search, phase "decode_strategy_import") and into JAX."""
    mf = _machine_file(tmp_path, 1)
    jm, tm = _pair(_lm, batch=2, search_budget=3, machine_model_file=mf)
    path = str(tmp_path / "decode.json")
    tm.compile_decode(export_path=path)
    searched = _views_by_position(tm.decode_graph, tm.decode_searched_views)
    tm.compile_decode(strategy_path=path)
    assert tm.decode_searched_cost is None
    assert _views_by_position(tm.decode_graph,
                              tm.decode_searched_views) == searched
    assert [e["name"] for e in tm.decode_trajectory.of_kind("phase")][1] \
        == "decode_strategy_import"
    jm.compile_decode(strategy_path=path)
    assert _views_by_position(jm.decode_graph,
                              jm.decode_searched_views) == searched


def _serve(mod, model, prompts, news, **cfg):
    q = mod.AdmissionQueue(16)
    b = mod.ContinuousBatcher(model, mod.ServingConfig(
        max_len=LM_SEQ, slots=2, page_size=4, **cfg), q).start()
    try:
        reqs = [mod.GenerationRequest(p, n, deadline_s=120.0)
                for p, n in zip(prompts, news)]
        for r in reqs:
            q.offer(r)
        return [np.asarray(r.result(timeout=120)) for r in reqs], b
    finally:
        b.stop()


def test_batcher_on_the_decode_executor(tmp_path, no_jax_calibration):
    """Ragged prompts through 2 slots with the batched step built from
    the decode executor: every answer equals incremental_generate's and
    JAX's batcher's on its decode executor; the page pool drains clean."""
    jm, tm = _pair(_lm, batch=2, search_budget=3,
                   machine_model_file=_machine_file(tmp_path, 4))
    jm.compile_decode()
    tm.compile_decode()
    rng = np.random.RandomState(13)
    prompts = [rng.randint(0, LM_VOCAB, n).astype(np.int32)
               for n in (3, 7, 1, 5)]
    news = [5, 3, 6, 4]
    jout, jb = _serve(jserving, jm, prompts, news, precompile=False)
    tout, tb = _serve(tserving, tm, prompts, news)
    assert tb.decode_strategy_active and jb.decode_strategy_active
    assert tb._stepB is tm.decode_executor.build_decode(2, LM_SEQ)[1]
    for p, n, j, t in zip(prompts, news, jout, tout):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, tserving.incremental_generate(
            tm, p[None], max_new_tokens=n, max_len=LM_SEQ)[0])
    assert tb.pool.audit() == [] and tb.pool.pages_in_use == 0


def test_batcher_falls_back_on_an_incompatible_decode_executor(
        tmp_path, no_jax_calibration):
    """A decode graph whose ops find no weights in the param store is
    refused: counted, warned, and the batcher serves from the training
    executor, exactly."""
    _, tm = _pair(_lm, batch=2)
    dex = tm.compile_decode(strategy_path=None)
    victim = next(op for op in dex.topo if op.weights)
    victim.name = "renamed_op"
    tdec.reset_decode_fallback_warnings()
    before = tdec.DECODE_FALLBACK_COUNTS["decode_strategy_incompatible"]
    prompt = np.arange(4, dtype=np.int32)
    with pytest.warns(UserWarning, match="decode_strategy_incompatible"):
        out, b = _serve(tserving, tm, [prompt], [3])
    assert not b.decode_strategy_active
    assert tdec.DECODE_FALLBACK_COUNTS["decode_strategy_incompatible"] \
        == before + 1
    np.testing.assert_array_equal(out[0], tserving.incremental_generate(
        tm, prompt[None], max_new_tokens=3, max_len=LM_SEQ)[0])


def test_batcher_imports_the_configured_decode_strategy(
        tmp_path, no_jax_calibration):
    _, tm = _pair(_lm, batch=2, search_budget=3,
                  machine_model_file=_machine_file(tmp_path, 1))
    path = str(tmp_path / "decode.json")
    tm.compile_decode(export_path=path)
    tm.decode_executor = None
    prompt = np.arange(5, dtype=np.int32)
    out, b = _serve(tserving, tm, [prompt], [4],
                    decode_strategy_path=path)
    assert b.decode_strategy_active and tm.decode_executor is not None
    np.testing.assert_array_equal(out[0], tserving.incremental_generate(
        tm, prompt[None], max_new_tokens=4, max_len=LM_SEQ)[0])
