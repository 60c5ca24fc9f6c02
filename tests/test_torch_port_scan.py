"""The train scan of flexflow_tpu_torch (`iterations_per_dispatch`), its
per-step seed table and `remat`, against stepwise `fit` and against the
JAX package, on the CPU.

On the CPU the scan is a loop over the same train step the stepwise path
runs, fed the same seed-table rows, so `fit` with iterations_per_dispatch
3 over 7 batches (two chunks of 3 and a tail of 1) must leave the
weights and the per-epoch metrics of stepwise `fit` to the last bit, with
dropout in the attention and a standalone Dropout op. Against JAX's scan
(no dropout) the tolerance is the training slice's: rtol 1e-5 with atol
1e-6 on f32 weights, since the two packages sum the same products in
other orders. Remat recomputes the same ops on the same inputs and seeds,
so its gradients equal the stored-residual gradients bit for bit in the
port; against JAX's remat gradients (same seeds injected into both
packages) atol 1e-5 with rtol 1e-5, the frontend slice's tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as jff
from flexflow_tpu.kernels import attention as jka
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.core.seeds import fold_in, seed_table, step_seed
from flexflow_tpu_torch.ff_types import LossType, MetricsType
from flexflow_tpu_torch.frontends.torch import PyTorchModel
from flexflow_tpu_torch.kernels import attention as tka
from flexflow_tpu_torch.kernels import build
from flexflow_tpu_torch.models import BertEncoder, build_transformer
from flexflow_tpu_torch.ops.common import WeightCache
from flexflow_tpu_torch.runtime.weights import params_from_numpy

BATCH, SEQ, HIDDEN, HEADS = 2, 8, 16, 2
RTOL, ATOL, GRAD_ATOL = 1e-5, 1e-6, 1e-5
MSE = "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE"
SEEDS = (0x2545F491, 0x6C078965)


def _mha_model(spd=1, remat=False, mixed=False):
    """x -> MHA (attention dropout 0.2) -> Dropout 0.3 -> dense."""
    m = FFModel(FFConfig(batch_size=BATCH, device="cpu", remat=remat,
                         iterations_per_dispatch=spd,
                         allow_mixed_precision=mixed))
    x = m.create_tensor((BATCH, SEQ, HIDDEN))
    t = m.multihead_attention(x, x, x, HIDDEN, HEADS, dropout=0.2)
    t = m.dropout(t, 0.3, seed=5)
    m.dense(t, HIDDEN)
    m.compile(SGDOptimizer(lr=0.05), getattr(LossType, MSE),
              [MetricsType.METRICS_MEAN_SQUARED_ERROR])
    return m


def _bert_model(spd=1):
    """A 2-layer BERT encoder (attention and hidden dropout 0.1) imported
    through the PyTorch frontend."""
    torch.manual_seed(0)
    module = BertEncoder(2, HIDDEN, HEADS, 32, 0.1, 0.1)
    m = FFModel(FFConfig(batch_size=BATCH, device="cpu",
                         iterations_per_dispatch=spd))
    pt = PyTorchModel(module)
    pt.torch_to_ff(m, [m.create_tensor((BATCH, SEQ, HIDDEN))])
    m.compile(SGDOptimizer(lr=0.05), getattr(LossType, MSE),
              [MetricsType.METRICS_MEAN_SQUARED_ERROR])
    pt.load_weights(m)
    return m


def _data(n_batches=7, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n_batches * BATCH, SEQ, HIDDEN).astype(np.float32),
            rng.randn(n_batches * BATCH, SEQ, HIDDEN).astype(np.float32))


def _epoch_lines(text):
    """The epoch lines without their throughput reading (a clock)."""
    return [ln.split("throughput")[0] + ln.split("samples/s")[1]
            for ln in text.splitlines() if ln.startswith("epoch")]


def _metrics(pm):
    return {k: v for k, v in vars(pm).items() if k != "start_time"}


@pytest.mark.parametrize("make", [_mha_model, _bert_model],
                         ids=["ffmodel", "frontend"])
def test_scan_fit_equals_stepwise_fit_to_the_last_bit(make, capsys):
    x, y = _data()
    a, b = make(1), make(3)
    assert b.config.iterations_per_dispatch == 3
    pa = a.fit(x, y, epochs=2)
    la = _epoch_lines(capsys.readouterr().out)
    pb = b.fit(x, y, epochs=2)
    lb = _epoch_lines(capsys.readouterr().out)
    assert la == lb and len(la) == 2
    assert _metrics(pa) == _metrics(pb)
    assert a.state.step == b.state.step == 14
    for op, ws in a.params.items():
        for n, w in ws.items():
            assert torch.equal(w, b.params[op][n]), f"{op}.{n}"
    # dropout acted: without it the same fit ends elsewhere
    c = make(1)
    c.executor.drawing_ops = []
    c.fit(x, y, epochs=2, verbose=False)
    assert not all(torch.equal(w, c.params[op][n])
                   for op, ws in a.params.items() for n, w in ws.items())


def test_scan_returns_partials_stacked_per_step():
    """scan(state, stacked inputs, stacked labels, seed table) equals N
    eager train steps fed the same steps' seeds, step by step."""
    x, y = _data(3, seed=1)
    a, b = _mha_model(), _mha_model()
    g = torch.Generator().manual_seed(7)
    seeds = [step_seed(g) for _ in range(3)]
    xs = x.reshape(3, BATCH, SEQ, HIDDEN)
    ys = y.reshape(3, BATCH, SEQ, HIDDEN)
    state, parts = b.executor.build_train_scan()(
        b.state, [xs], ys, b.executor.seed_table(seeds))
    assert state.step == 3 and state.params is b.params
    assert set(parts) == {"num_samples", "num_rows", "mse_loss", "loss"}
    step = a.executor.build_train_step()
    for j, s in enumerate(seeds):
        a.state, p = step(a.state, [xs[j]], ys[j], s)
        for k, v in p.items():
            assert torch.equal(v, parts[k][j]), (j, k)
    for op, ws in a.params.items():
        for n, w in ws.items():
            assert torch.equal(w, b.params[op][n])


def test_scan_matches_the_jax_scan():
    """The flagship Transformer (2 blocks, no dropout) in both packages,
    JAX's weights carried over: fit with iterations_per_dispatch 3 over 7
    batches, two epochs, in each."""
    cfg = jff.FFConfig()
    cfg.batch_size = BATCH
    cfg.workersPerNode = 1
    cfg.iterations_per_dispatch = 3
    jm = jff.FFModel(cfg)
    from flexflow_tpu.models.transformer import build_transformer as jbuild

    jbuild(jm, BATCH, SEQ, HIDDEN, HEADS, 2)
    jm.compile(jff.SGDOptimizer(lr=0.01), getattr(jff.LossType, MSE),
               [jff.MetricsType.METRICS_MEAN_SQUARED_ERROR])
    tm = FFModel(FFConfig(batch_size=BATCH, device="cpu",
                          iterations_per_dispatch=3))
    build_transformer(tm, BATCH, SEQ, HIDDEN, HEADS, 2)
    tm.compile(SGDOptimizer(lr=0.01), getattr(LossType, MSE),
               [MetricsType.METRICS_MEAN_SQUARED_ERROR])
    params_from_numpy(tm, {op: {n: np.asarray(a, np.float32)
                                for n, a in ws.items()}
                           for op, ws in jm.state.params.items()})
    x, y = _data(seed=2)
    jpm = jm.fit(x, y, epochs=2, verbose=False)
    tpm = tm.fit(x, y, epochs=2, verbose=False)
    assert tm.state.step == 14
    np.testing.assert_allclose(tpm.mse_loss, jpm.mse_loss, rtol=RTOL)
    assert tpm.train_all == jpm.train_all
    for op, ws in tm.params.items():
        for n, w in ws.items():
            np.testing.assert_allclose(
                w.numpy(), np.asarray(jm.state.params[op][n]), rtol=RTOL,
                atol=ATOL, err_msg=f"{op}.{n}")


def test_seed_table_holds_the_host_dropout_seeds():
    """Entry [j, i] is dropout_seeds(fold_in(step seed j, i)) for every op
    i that draws, as uint32 bits in int32, zeros elsewhere; fit draws the
    step seeds from the model's generator in step order, chunked or not."""
    m = _mha_model()
    ex = m.executor
    assert ex.drawing_ops == [0, 1]          # MHA (dropout), Dropout
    g = torch.Generator().manual_seed(3)
    seeds = [step_seed(g) for _ in range(4)]
    table = ex.seed_table(seeds)
    assert table.shape == (4, 3, 2) and table.dtype == torch.int32
    for j, s in enumerate(seeds):
        for i in range(3):
            got = tuple(int(v) & 0xFFFFFFFF for v in table[j, i])
            want = (tka.dropout_seeds(fold_in(s, i)) if i in ex.drawing_ops
                    else (0, 0))
            assert got == want, (j, i)
    assert torch.equal(seed_table(seeds, [1], 2)[:, 1], table[:, 1])


def test_seed_table_reaches_injected_seeds(monkeypatch):
    """A test that patches `dropout_seeds` in kernels.attention reaches
    the table, and through it the ops: the MHA op of a train step then
    drops with those two seeds, as the patched op itself does."""
    monkeypatch.setattr(tka, "dropout_seeds", lambda rng: SEEDS)
    m = _mha_model()
    table = m.executor.seed_table([11])
    assert [int(v) & 0xFFFFFFFF for v in table[0, 0]] == list(SEEDS)
    (x, y) = _data(1)
    ex = m.executor
    g_table = ex._loss_and_grads(m.params, [x], ex._as_labels(y),
                                 table[0])[2]
    g_int = ex._loss_and_grads(m.params, [x], ex._as_labels(y), 11)[2]
    for op, gs in g_table.items():
        for n, g in gs.items():
            assert torch.equal(g, g_int[op][n])


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_remat_gradients_equal_stored_gradients(impl, monkeypatch):
    """remat recomputes each attention op in the backward: with dropout
    (the recompute reads the same seed-table entry) the gradients equal
    the stored-residual gradients bit for bit, on either attention path."""
    monkeypatch.setenv("FF_ATTENTION_IMPL", impl)
    a, b = _mha_model(), _mha_model(remat=True)
    assert b.executor.remat and not a.executor.remat
    (x, y), = [_data(1, seed=4)]
    ga = a.executor._loss_and_grads(a.params, [x], a.executor._as_labels(y),
                                    9)
    gb = b.executor._loss_and_grads(a.params, [x], b.executor._as_labels(y),
                                    9)
    assert torch.equal(ga[0], gb[0])
    for op, gs in ga[2].items():
        for n, g in gs.items():
            assert torch.equal(g, gb[2][op][n]), f"{op}.{n}"


def test_remat_gradients_match_jax_remat(monkeypatch):
    """The same MHA-with-dropout model with remat in both packages, the
    same two seeds injected into both: equal loss and gradients."""
    monkeypatch.setattr(jka, "dropout_seeds",
                        lambda rng: jnp.asarray(np.asarray(SEEDS, np.uint32)))
    monkeypatch.setattr(tka, "dropout_seeds", lambda rng: SEEDS)
    monkeypatch.delenv("FF_ATTENTION_IMPL", raising=False)
    cfg = jff.FFConfig()
    cfg.batch_size = BATCH
    cfg.workersPerNode = 1
    cfg.remat = True
    jm = jff.FFModel(cfg)
    jx = jm.create_tensor((BATCH, SEQ, HIDDEN), jff.DataType.DT_FLOAT)
    jm.dense(jm.multihead_attention(jx, jx, jx, HIDDEN, HEADS, dropout=0.2),
             HIDDEN)
    jm.compile(jff.SGDOptimizer(lr=0.05), getattr(jff.LossType, MSE), [])
    tm = FFModel(FFConfig(batch_size=BATCH, device="cpu", remat=True))
    tx = tm.create_tensor((BATCH, SEQ, HIDDEN))
    tm.dense(tm.multihead_attention(tx, tx, tx, HIDDEN, HEADS, dropout=0.2),
             HIDDEN)
    tm.compile(SGDOptimizer(lr=0.05), getattr(LossType, MSE))
    params_from_numpy(tm, {op: {n: np.asarray(a, np.float32)
                                for n, a in ws.items()}
                           for op, ws in jm.state.params.items()})
    x, y = _data(1, seed=5)
    jex = jm.executor
    assert jex.remat

    def jloss(p):
        vals = jex.apply(p, jex._input_vals([x]), training=True,
                         rng=jax.random.PRNGKey(0))
        return jex.loss_fn(vals[jex.logits_pt.guid], jnp.asarray(y))

    jl, jg = jax.value_and_grad(jloss)(jm.state.params)
    tex = tm.executor
    tl, _, tg = tex._loss_and_grads(tm.params, [x], tex._as_labels(y), 0)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)
    for op, gs in tg.items():
        for n, g in gs.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(jg[op][n]),
                                       rtol=RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{op}.{n}")


def test_weight_cache_follows_in_place_updates():
    """A cached compute-dtype copy keeps its address and is refreshed in
    place when its weight's version moves; it never serves a stale
    value, through `get` or `refresh`."""
    cache = WeightCache()
    w = torch.randn(5, 7)
    c = cache.get(w, torch.bfloat16)
    assert c.dtype == torch.bfloat16 and torch.equal(c, w.to(torch.bfloat16))
    assert cache.get(w, torch.bfloat16) is c
    assert cache.get(w, torch.float32) is w      # no cast, no copy
    ptr = c.data_ptr()
    w.add_(1.0)
    c2 = cache.get(w, torch.bfloat16)
    assert c2 is c and c.data_ptr() == ptr
    assert torch.equal(c, w.to(torch.bfloat16))
    w.mul_(3.0)
    cache.refresh()                              # what a replay relies on
    assert torch.equal(c, w.to(torch.bfloat16)) and c.data_ptr() == ptr
    other = torch.randn(5, 7)
    assert not torch.equal(cache.get(other, torch.bfloat16), c)


def test_served_forward_reads_fresh_weights_under_mixed_precision():
    """build_forward reads bf16 copies from the executor's cache: after an
    in-place update of a weight (w.add_, as training does) its output is
    the uncached forward's of the new weights, bit for bit. The training
    path does not fill the cache."""
    m = _mha_model(mixed=True)
    ex = m.executor
    (x, y), = [_data(1, seed=6)]
    fwd = ex.build_forward()

    def uncached():
        with torch.no_grad():
            return ex.apply(m.params, ex._input_vals([x]))[ex.logits_pt.guid]

    out0 = fwd(m.params, [x])
    assert torch.equal(out0, uncached())
    n_cached = len(ex.weight_cache._entries)
    assert n_cached >= 4
    ex._loss_and_grads(m.params, [x], ex._as_labels(y), 1)
    assert len(ex.weight_cache._entries) == n_cached
    for ws in m.params.values():
        for w in ws.values():
            w.add_(0.25)
    out1 = fwd(m.params, [x])
    assert not torch.equal(out1, out0)
    assert torch.equal(out1, uncached())


def test_served_forward_reads_weights_a_replay_moved():
    """A graph replay updates the weights in place without ATen dispatch,
    so their version counters do not move and the cache alone would serve
    the old copies. The scan bumps the versions after each replay
    (`_mark_moved`), and the served forward then reads the new weights.
    Writes through `.data`, which bump no version either, stand in for
    the replay here."""
    from flexflow_tpu_torch.parallel.executor import _mark_moved

    m = _mha_model(mixed=True)
    ex = m.executor
    (x, _), = [_data(1, seed=6)]
    fwd = ex.build_forward()
    out0 = fwd(m.params, [x])
    for ws in m.params.values():
        for w in ws.values():
            w.data.add_(0.25)
    assert torch.equal(fwd(m.params, [x]), out0)   # unmarked: stale
    _mark_moved(m.params)
    out1 = fwd(m.params, [x])
    with torch.no_grad():
        want = ex.apply(m.params, ex._input_vals([x]))[ex.logits_pt.guid]
    assert not torch.equal(out1, out0)
    assert torch.equal(out1, want)


def test_weight_cache_drops_a_copy_with_its_weight():
    """The cache holds its weights weakly: a weight that goes (replaced
    weights) takes its compute-dtype copy with it."""
    import gc

    cache = WeightCache()
    keep, drop = torch.randn(4, 4), torch.randn(4, 4)
    cache.get(keep, torch.bfloat16)
    cache.get(drop, torch.bfloat16)
    assert len(cache._entries) == 2
    del drop
    gc.collect()
    assert len(cache._entries) == 1
    cache.refresh()
    assert torch.equal(cache.get(keep, torch.bfloat16),
                       keep.to(torch.bfloat16))


def test_replays_add_the_launches_their_capture_recorded():
    """Launch accounting around a capture, without a card: what the
    capture launched comes out of the counts and is kept, and each replay
    adds it back, by kernel and by path."""
    build.reset_launch_counts()
    build.check_launch(0, "flash_fwd", "flash_fwd_wgmma")
    record = {}
    with build.captured_launches(record):
        build.check_launch(0, "flash_fwd", "flash_fwd_wgmma")
        build.check_launch(0, "flash_bwd", "flash_bwd_wgmma")
        build.check_launch(0, "flash_bwd", "flash_bwd_wgmma")
    assert build.launch_counts["flash_fwd"] == 1
    assert build.launch_counts["flash_bwd"] == 0
    assert record == {"launches": {"flash_fwd": 1, "flash_bwd": 2},
                      "paths": {"flash_fwd_wgmma": 1, "flash_bwd_wgmma": 2}}
    for _ in range(3):
        build.add_launches(record)
    assert build.launch_counts["flash_fwd"] == 4
    assert build.launch_counts["flash_bwd"] == 6
    assert build.path_counts["flash_bwd_wgmma"] == 6
    build.reset_launch_counts()
