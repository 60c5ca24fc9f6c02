"""The serving slice of flexflow_tpu_torch end to end against the JAX
package: the same causal LM built in both (the block of the served model:
causal MHA, dense+RELU, dense, all without bias), weights carried from the
JAX model by params_from_numpy, then the full forward, the KV-cached
decode steps, incremental_generate and a ContinuousBatcher compared.

f32 on the CPU: logits agree to atol 1e-4. Both packages compute the same
products, but in other orders (XLA's fused einsums against torch's), and
the softmax output of several stacked layers carries those ~1e-6 relative
differences through each layer's matmuls; tokens must agree exactly.
Also: the package boundary (no JAX imported) and the device default.
"""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import flexflow_tpu as jff
from flexflow_tpu.runtime import serving as jserving
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.ff_types import ActiMode, AggrMode, DataType
from flexflow_tpu_torch.runtime import serving as tserving
from flexflow_tpu_torch.runtime.weights import params_from_numpy

VOCAB, SEQ, HIDDEN, HEADS, LAYERS, BATCH = 48, 16, 32, 4, 2, 2
ATOL = 1e-4
PORT_DIR = pathlib.Path(__file__).resolve().parent.parent / "flexflow_tpu_torch"


def _build(m, ids, acti, aggr):
    t = m.embedding(ids, VOCAB, HIDDEN, aggr.AGGR_MODE_NONE)
    for _ in range(LAYERS):
        t = m.multihead_attention(t, t, t, HIDDEN, HEADS, causal=True)
        t = m.dense(t, HIDDEN, acti.AC_MODE_RELU, use_bias=False)
        t = m.dense(t, HIDDEN, use_bias=False)
    return m.softmax(m.dense(t, VOCAB))


@pytest.fixture(scope="module")
def models():
    cfg = jff.FFConfig()
    cfg.batch_size = BATCH
    cfg.search_budget = 1
    jm = jff.FFModel(cfg)
    _build(jm, jm.create_tensor((BATCH, SEQ), jff.DataType.DT_INT32),
           jff.ActiMode, jff.AggrMode)
    jm.compile(jff.SGDOptimizer(lr=0.01),
               jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [jff.MetricsType.METRICS_ACCURACY])
    tm = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    _build(tm, tm.create_tensor((BATCH, SEQ), DataType.DT_INT32),
           ActiMode, AggrMode)
    tm.compile()
    params_from_numpy(tm, {op: {n: np.asarray(a) for n, a in ws.items()}
                           for op, ws in jm.state.params.items()})
    return jm, tm


def _ids(seed, shape):
    return np.random.RandomState(seed).randint(0, VOCAB, shape) \
        .astype(np.int32)


def test_full_forward_matches_jax(models):
    jm, tm = models
    x = _ids(0, (BATCH, SEQ))
    jl = jm.executor.build_forward()(jm.state.params, [x],
                                     jm.state.net_state)
    tl = tm.executor.build_forward()(tm.params, [x])
    assert tl.shape == (BATCH, SEQ, VOCAB)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tm.predict(np.concatenate([x, x[:1]])),
                               np.concatenate([np.asarray(jl),
                                               np.asarray(jl)[:1]]),
                               atol=ATOL)


def test_cached_decode_logits_match_jax_and_the_full_forward(models):
    """Prefill 5 tokens, then 4 single-token steps; each step's logits
    against JAX's step and against the port's own full causal forward."""
    jm, tm = models
    import jax.numpy as jnp

    x = _ids(1, (BATCH, SEQ))
    jinit, jstep = jm.executor.build_decode(BATCH, SEQ)
    tinit, tstep = tm.executor.build_decode(BATCH, SEQ)
    jc, tc = jinit(jm.state.params, ()), tinit(tm.params)
    full = tm.executor.build_forward()(tm.params, [x]).numpy()
    spans = [(0, 5)] + [(t, t + 1) for t in range(5, 9)]
    for a, b in spans:
        jl, jc = jstep(jm.state.params, jc, jnp.int32(a),
                       [jnp.asarray(x[:, a:b])])
        tl, tc = tstep(tm.params, tc, a, [x[:, a:b]])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        np.testing.assert_allclose(tl.numpy(), full[:, a:b], atol=ATOL)


def test_incremental_generate_matches_jax(models):
    jm, tm = models
    prompt = _ids(2, (BATCH, 5))
    jt = jserving.incremental_generate(jm, prompt, max_new_tokens=8,
                                       max_len=SEQ)
    tt = tserving.incremental_generate(tm, prompt, max_new_tokens=8,
                                       max_len=SEQ)
    np.testing.assert_array_equal(tt, np.asarray(jt))


def test_continuous_batcher_matches_jax_and_incremental_generate(models):
    """Ragged prompts through 2 slots: admission mid-stream, per-slot
    positions, retirement and page release; each answer equals JAX's
    batcher and incremental_generate on the same prompt."""
    jm, tm = models
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, VOCAB, n).astype(np.int32)
               for n in (3, 7, 1, 5, 9)]
    news = [5, 3, 6, 4, 2]

    def serve(mod, model, **extra):
        q = mod.AdmissionQueue(16)
        b = mod.ContinuousBatcher(
            model, mod.ServingConfig(max_len=SEQ, slots=2, page_size=4,
                                     **extra), q).start()
        try:
            reqs = [mod.GenerationRequest(p, n, deadline_s=120.0)
                    for p, n in zip(prompts, news)]
            for r in reqs:
                q.offer(r)
            return [np.asarray(r.result(timeout=120)) for r in reqs], b
        finally:
            b.stop()

    jout, _ = serve(jserving, jm, precompile=False)
    tout, tb = serve(tserving, tm)
    for p, n, j, t in zip(prompts, news, jout, tout):
        np.testing.assert_array_equal(t, j)
        ref = tserving.incremental_generate(tm, p[None], max_new_tokens=n,
                                            max_len=SEQ)[0]
        np.testing.assert_array_equal(t, ref)
    assert tb.stats["finished"] == len(prompts)
    assert tb.pool.pages_in_use == 0 and tb.pool.audit().ok


def test_params_from_numpy_rejects_mismatches(models):
    jm, tm = models
    good = {op: {n: np.asarray(a) for n, a in ws.items()}
            for op, ws in jm.state.params.items()}
    missing = {k: v for k, v in good.items() if k != "op_linear_2"}
    with pytest.raises(ValueError, match="op_linear_2"):
        params_from_numpy(tm, missing)
    wrong = {k: dict(v) for k, v in good.items()}
    wrong["op_linear_2"]["kernel"] = wrong["op_linear_2"]["kernel"][:, :3]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tm, wrong)
    extra = {k: dict(v) for k, v in good.items()}
    extra["op_linear_2"]["bias"] = np.zeros(HIDDEN, np.float32)
    with pytest.raises(ValueError, match="weights"):
        params_from_numpy(tm, extra)


def test_compile_refuses_what_is_not_ported():
    m = FFModel(FFConfig(device="cpu", workersPerNode=2))
    m.softmax(m.create_tensor((2, 4)))
    with pytest.raises(NotImplementedError):
        m.compile()
    # the search runs (tests/test_torch_port_search.py), and a
    # calibration must be a measured store
    m = FFModel(FFConfig(device="cpu", search_budget=1))
    m.softmax(m.create_tensor((2, 4)))
    with pytest.raises(TypeError):
        m.compile(calibration={})
    # a pipeline degree of 2 is ported and needs two devices, which one
    # process does not have (its stages never run one after another in
    # one process); so does a sequence degree of 2
    m = FFModel(FFConfig(device="cpu", pipeline_parallel_degree=2))
    m.softmax(m.create_tensor((2, 4)))
    with pytest.raises(ValueError, match="pipeline_parallel_degree 2 does "
                       "not divide the 1 devices"):
        m.compile()
    m = FFModel(FFConfig(device="cpu", sequence_parallel_degree=2))
    m.softmax(m.create_tensor((2, 4)))
    with pytest.raises(ValueError, match="does not divide the 1 devices"):
        m.compile()


def test_entry_points_default_to_cuda():
    """Without device="cpu" an entry point runs on the card, and raises
    where there is none (it never continues on the CPU by itself)."""
    if torch.cuda.is_available():
        assert FFModel().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        FFConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        FFModel()
    with pytest.raises(RuntimeError, match="CUDA"):
        FFModel(FFConfig(device="cuda:0"))


def test_port_imports_no_jax():
    code = ("import sys, flexflow_tpu_torch, flexflow_tpu_torch.runtime.serving,"
            " flexflow_tpu_torch.runtime.weights,"
            " flexflow_tpu_torch.parallel.decode,"
            " flexflow_tpu_torch.parallel.executor,"
            " flexflow_tpu_torch.ops.attention,"
            " flexflow_tpu_torch.runtime.strategy_io,"
            " flexflow_tpu_torch.search, flexflow_tpu_torch.search.measure,"
            " flexflow_tpu_torch.search.substitution_loader,"
            " flexflow_tpu_torch.analysis.substitution_lint;"
            " bad = sorted(m for m in sys.modules if m == 'jax'"
            " or m.startswith(('jax.', 'flexflow_tpu.')) or m == 'flexflow_tpu');"
            " print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=PORT_DIR.parent, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    files = [p for p in PORT_DIR.rglob("*")
             if p.suffix in (".py", ".cu", ".cuh")]
    assert len(files) > 20
    for p in files:
        text = p.read_text()
        assert "import jax" not in text and "flexflow_tpu." not in text, p


def test_greedy_generate_matches_jax_on_an_encoder_decoder():
    """greedy_generate re-runs the full forward per token over a
    two-input (encoder ids, decoder ids) model; cross-attention runs
    through the MHA op's full forward with k/v from the encoder."""

    def build(m, dt, acti):
        enc = m.create_tensor((BATCH, 6), dt.DT_INT32)
        dec = m.create_tensor((BATCH, 8), dt.DT_INT32)
        e = m.embedding(enc, VOCAB, HIDDEN)
        d = m.embedding(dec, VOCAB, HIDDEN)
        d = m.multihead_attention(d, d, d, HIDDEN, HEADS, causal=True)
        d = m.multihead_attention(d, e, e, HIDDEN, HEADS)
        d = m.dense(d, HIDDEN, acti.AC_MODE_RELU)
        return m.softmax(m.dense(d, VOCAB))

    cfg = jff.FFConfig()
    cfg.batch_size = BATCH
    jm = jff.FFModel(cfg)
    build(jm, jff.DataType, jff.ActiMode)
    jm.compile(jff.SGDOptimizer(lr=0.01),
               jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    tm = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    build(tm, DataType, ActiMode)
    tm.compile()
    params_from_numpy(tm, {op: {n: np.asarray(a) for n, a in ws.items()}
                           for op, ws in jm.state.params.items()})
    enc = _ids(4, (BATCH, 6))
    for kw in ({}, {"max_new_tokens": 3, "start_token_id": 1}):
        jt = jserving.greedy_generate(jm, enc, **kw)
        tt = tserving.greedy_generate(tm, enc, **kw)
        assert tt.shape == (BATCH, kw.get("max_new_tokens", 7) + 1)
        np.testing.assert_array_equal(tt, np.asarray(jt))


def test_init_params_is_seeded_glorot_and_zero():
    def build(seed):
        m = FFModel(FFConfig(device="cpu", seed=seed))
        x = m.create_tensor((2, 4), DataType.DT_INT32)
        t = m.embedding(x, VOCAB, HIDDEN)
        m.dense(m.multihead_attention(t, t, t, HIDDEN, HEADS), 8)
        m.compile()
        return m.params

    a, b, c = build(0), build(0), build(1)
    for op, ws in a.items():
        for n, w in ws.items():
            assert torch.equal(w, b[op][n])
            if n in ("bias", "bias_o"):
                assert not w.any()
            else:
                shape = w.shape
                limit = (6.0 / (np.prod(shape[:-1]) + shape[-1])) ** 0.5
                assert w.abs().max() <= limit and w.std() > limit / 4
                assert not torch.equal(w, c[op][n])
