"""The strategy tuner (runtime/tuner.py) and recompile triggers
(runtime/recompile.py) of flexflow_tpu_torch against the JAX package, on
the CPU.

  - the watch: hysteresis, cooldown, the calibration signal and the
    strategy fingerprint, driven through both packages' tuners with the
    same step times (their re-search stubbed);
  - the one-device cycles of tests/test_tuner.py:185-335: a swap that
    carries every weight bit for bit, a canary divergence that rolls back
    and quarantines, the fit's accounting (counter, gauge, the swap's
    trace and overlay instants), and the three fault sites
    (`swap_research_crash`, `swap_reshard_corruption`, `swap_regression`)
    -- each fit's weights against JAX's same fit (the JAX model at
    workersPerNode 1, the port's one device);
  - after a swap no stale copies serve: the mixed-precision model
    predicts, swaps, steps and predicts again as a fresh model with the
    same weights does;
  - `recompile_on_condition` against JAX's;
  - on 4 gloo ranks: a committed swap from dp 4 to a fixed candidate
    (tensor parallel 2; `fixed_winner` patches the search in both
    packages), every rank with the same swap history, the weights after
    the fit against JAX's same swap at 4 CPU devices.

Tolerances: params atol 1e-5 / rtol 1e-5 against JAX; weights carried
through a swap, and the rolled-back live weights, bit-equal (atol 0).
The guard band is huge except in the regression test (host-clock noise
must not roll back a swap a test wants committed); no test asserts a
wall time.
"""
import concurrent.futures
import json
import pathlib
import types

import numpy as np
import pytest
import torch

import flexflow_tpu as jff
from flexflow_tpu.runtime import recompile as jrec
from flexflow_tpu.runtime import resilience as jrz
from flexflow_tpu.runtime import tuner as jtun
from flexflow_tpu_torch import (FFConfig, FFModel, SGDOptimizer,
                                StrategyTuner, TunerConfig, obs)
from flexflow_tpu_torch.ff_types import (ActiMode, DataType, LossType,
                                         MetricsType)
from flexflow_tpu_torch.runtime import recompile as trec
from flexflow_tpu_torch.runtime.mesh_run import launch
from flexflow_tpu_torch.runtime.resilience import FaultInjector
from flexflow_tpu_torch.runtime.tuner import (SWAP_METRIC, _SearchOutcome,
                                              strategy_fingerprint)
from flexflow_tpu_torch.runtime.weights import params_from_numpy
from torch_mesh_cases import fixed_winner

RTOL = ATOL = 1e-5
TIMEOUT = 150
CASES = str(pathlib.Path(__file__).with_name("torch_mesh_cases.py"))
REWRITES = [["partition_linear_combine", 2]]


def _tcfg(pkg="torch", **kw):
    """JAX's aggressive test settings (tests/test_tuner.py `_tcfg`):
    trigger at once, accept any simulated win, a short guard window and
    a huge guard band."""
    base = dict(drift_threshold=-1.0, hysteresis_steps=1, cooldown_steps=3,
                warmup_steps=0, min_win=-100.0, post_swap_steps=2,
                search_budget=4, guard_band=1e9)
    base.update(kw)
    return (TunerConfig if pkg == "torch" else jtun.TunerConfig)(**base)


def small_model(mixed=False):
    m = FFModel(FFConfig(batch_size=8, device="cpu",
                         allow_mixed_precision=mixed))
    x = m.create_tensor((8, 4), DataType.DT_FLOAT)
    t = m.dense(x, 16, ActiMode.AC_MODE_RELU)
    t = m.dense(t, 3)
    m.softmax(t)
    m.compile(SGDOptimizer(lr=0.1, momentum=0.9),
              LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              [MetricsType.METRICS_ACCURACY])
    return m


def jax_model(workers=1):
    cfg = jff.FFConfig()
    cfg.batch_size = 8
    cfg.workersPerNode = workers
    m = jff.FFModel(cfg)
    x = m.create_tensor((8, 4), jff.DataType.DT_FLOAT)
    t = m.dense(x, 16, jff.ActiMode.AC_MODE_RELU)
    t = m.dense(t, 3)
    m.softmax(t)
    m.compile(jff.SGDOptimizer(lr=0.1, momentum=0.9),
              jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              [jff.MetricsType.METRICS_ACCURACY])
    return m


def dataset(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = rng.randint(0, 3, (n, 1)).astype(np.int32)
    return x, y


def jax_params(m):
    return {op: {n: np.array(a, copy=True) for n, a in ws.items()}
            for op, ws in m.state.params.items()}


def params_of(m):
    return {op: {n: w.detach().cpu().numpy().copy() for n, w in ws.items()}
            for op, ws in m.params.items()}


def assert_close(got, want, atol=ATOL, rtol=RTOL):
    assert set(got) == set(want)
    for op, ws in want.items():
        for n, a in ws.items():
            np.testing.assert_allclose(got[op][n], a, atol=atol, rtol=rtol,
                                       err_msg=f"{op}/{n}")


def pair():
    """A JAX model and a port model at JAX's initial weights."""
    jm = jax_model()
    m = small_model()
    params_from_numpy(m, jax_params(jm))
    return jm, m


# ----------------------------------------------------------------------
# the watch, in both packages on the same step times
# ----------------------------------------------------------------------
def _watch_tuners(**kw):
    out = []
    for cls, cfg in ((StrategyTuner, TunerConfig),
                     (jtun.StrategyTuner, jtun.TunerConfig)):
        t = cls(types.SimpleNamespace(), cfg(**kw))
        t.launched = []
        t._start_research = (lambda t: lambda step, score:
                             t.launched.append((step, round(score, 9))))(t)
        out.append(t)
    return out


def test_drift_trigger_needs_hysteresis_as_jax():
    tuners = _watch_tuners(drift_threshold=0.5, hysteresis_steps=3,
                           cooldown_steps=0, warmup_steps=0)
    durs = ([0.10] * 3 + [0.50] * 2 + [0.0001] * 12 + [5.0] * 3)
    for t in tuners:
        for step, dur in enumerate(durs):
            t.observe_step(dur)
            t.on_step_boundary(step)
    assert tuners[0].launched == tuners[1].launched
    # each launch is the third breach in a row: the EMA breaches at steps
    # 3-5 (it lags the healthy steps), a healthy run resets it, and steps
    # 17-19 breach three times
    assert [s for s, _ in tuners[0].launched] == [5, 19]
    assert tuners[0].drift_score() == pytest.approx(tuners[1].drift_score())


def test_drift_trigger_obeys_cooldown_as_jax():
    tuners = _watch_tuners(drift_threshold=0.1, hysteresis_steps=1,
                           cooldown_steps=10, warmup_steps=0)
    for t in tuners:
        t.observe_step(0.1)
        t.on_step_boundary(0)
        t.observe_step(1.0)
        t.on_step_boundary(1)
        t.state = t.IDLE
        t._finish_cycle(1, "quarantined", reason="test")
        for step in list(range(2, 11)) + [12]:
            t.observe_step(1.0)
            t.on_step_boundary(step)
    assert [s for s, _ in tuners[0].launched] == \
        [s for s, _ in tuners[1].launched] == [1, 12]
    assert tuners[0].swap_history == tuners[1].swap_history


def test_observe_explanation_feeds_drift_score_as_jax():
    for ratios, want in (({"OP_LINEAR": 3.0, "OP_RELU": 0.9}, 2.0),
                         ({"X": 0.25}, 3.0)):
        fake = types.SimpleNamespace(calibration_ratios=lambda r=ratios: r)
        for t in _watch_tuners(drift_threshold=0.5, hysteresis_steps=1):
            t.observe_explanation(fake)
            assert t.drift_score() == pytest.approx(want)


def test_fingerprint_stable_and_view_sensitive_as_jax():
    from flexflow_tpu.pcg.machine_view import MachineView as JView
    from flexflow_tpu_torch.pcg.machine_view import MachineView

    jm, m = pair()
    fp = strategy_fingerprint(m.graph, m.searched_views)
    assert fp == strategy_fingerprint(m.graph, m.searched_views)
    assert len(fp) == 16
    assert fp == jtun.strategy_fingerprint(jm.graph, jm.searched_views
                                           if hasattr(jm, "searched_views")
                                           else None)
    op, jop = m.graph.ops[0], jm.graph.ops[0]
    got = strategy_fingerprint(
        m.graph, {op.guid: MachineView(dim=(4,), stride=(1,))})
    want = jtun.strategy_fingerprint(
        jm.graph, {jop.guid: JView(dim=(4,), stride=(1,))})
    assert got != fp and got == want


# ----------------------------------------------------------------------
# the transactional swap at a boundary, one device
# ----------------------------------------------------------------------
def _candidate(tuner, m):
    cm = m._build_cost_model()
    g, v, c = tuner._run_search(cm)
    return {"graph": g, "views": v, "cost": c, "cost_model": cm,
            "fingerprint": strategy_fingerprint(g, v), "win": 1.0}


def test_swap_commit_carries_weights_bit_exact():
    jm, m = pair()
    x, y = dataset()
    m.fit(x, y, batch_size=8, epochs=1, verbose=False)
    tuner = StrategyTuner(m, _tcfg())
    tuner._last_batch = ([x[:8]], y[:8])
    tuner._candidate = _candidate(tuner, m)
    pre, old_ex, pre_step = params_of(m), m.executor, m.state.step
    assert tuner._execute_swap(step=7) is True
    assert tuner.state == tuner.POST_SWAP and m.executor is not old_ex
    assert_close(params_of(m), pre, atol=0, rtol=0)
    assert m.state.step == pre_step
    evs = m._strategy_swap_overlay_events
    assert evs[-1]["name"] == "strategy_swap"
    assert evs[-1]["args"]["step"] == 7
    assert set(tuner.timings) >= {"build_s", "transplant_s", "canary_s"}
    # the swapped model trains on as JAX's unswapped one does
    m.fit(x, y, batch_size=8, epochs=1, verbose=False)
    jm.fit(x, y, batch_size=8, epochs=2, verbose=False)
    assert_close(params_of(m), jax_params(jm))


def test_canary_divergence_rolls_back_and_quarantines():
    _, m = pair()
    x, y = dataset()
    m.fit(x, y, batch_size=8, epochs=1, verbose=False)
    tuner = StrategyTuner(m, _tcfg())
    tuner._last_batch = ([x[:8]], y[:8])
    cand = _candidate(tuner, m)
    tuner._candidate = dict(cand)
    tuner._canary_losses = lambda *a, **k: (1.0, 9.9)
    pre, old_ex = params_of(m), m.executor
    assert tuner._execute_swap(step=7) is False
    assert m.executor is old_ex and tuner.state == tuner.IDLE
    assert tuner.outcomes == {"committed": 0, "rolled_back": 1,
                              "quarantined": 0}
    assert tuner.swap_history[-1]["reason"] == "swap_failed"
    assert "canary diverged" in tuner.swap_history[-1]["detail"]
    assert_close(params_of(m), pre, atol=0, rtol=0)
    assert cand["fingerprint"] in tuner.quarantined
    tuner.state = tuner.SEARCHING
    tuner._thread = None
    tuner._search_cm = cand["cost_model"]
    tuner._search_result = _SearchOutcome(
        graph=cand["graph"], views=cand["views"], cost=cand["cost"])
    assert tuner.on_step_boundary(step=40) is False
    assert tuner.outcomes["quarantined"] == 1
    assert tuner.swap_history[-1]["reason"] == "already_quarantined"


def _jax_fit(faults=(), epochs=2, **tkw):
    jm = jax_model()
    fi = jrz.FaultInjector()
    for site, kw in faults:
        fi.inject(site, **kw)
    x, y = dataset()
    jm.fit(x, y, batch_size=8, epochs=epochs, verbose=False,
           tuner=_tcfg("jax", **tkw), fault_injector=fi)
    return jm


def _port_fit(faults=(), epochs=2, **kw):
    jm = jax_model()
    m = small_model()
    params_from_numpy(m, jax_params(jm))
    fi = FaultInjector()
    for site, fkw in faults:
        fi.inject(site, **fkw)
    x, y = dataset()
    m.fit(x, y, batch_size=8, epochs=epochs, verbose=False,
          tuner=_tcfg(**kw), fault_injector=fi)
    return m, fi


def test_fit_tuner_commit_cycle_and_accounting(tmp_path):
    jm, m = pair()
    x, y = dataset()
    cfg = obs.TelemetryConfig(dir=str(tmp_path), step_profile=True,
                              flight_recorder=False, anomaly_detection=False)
    with obs.session(cfg) as tel:
        m.fit(x, y, batch_size=8, epochs=2, verbose=False, tuner=_tcfg())
        t = m._tuner
        assert t.outcomes["committed"] >= 1, t.outcomes
        assert tel.metrics.counter(SWAP_METRIC, outcome="committed",
                                   leg="train").value == \
            t.outcomes["committed"]
        assert tel.metrics.gauge("ff_tuner_drift_score",
                                 leg="train") is not None
    assert sum(t.outcomes.values()) == len(t.swap_history)
    trace = json.load(open(tmp_path / "trace.json"))
    assert "strategy_swap" in [e.get("name") for e in trace["traceEvents"]]
    overlay = json.load(open(tmp_path / "step_timeline.json"))
    events = overlay["traceEvents"] if isinstance(overlay, dict) else overlay
    assert any(e.get("name") == "strategy_swap" for e in events)
    jm.fit(x, y, batch_size=8, epochs=2, verbose=False, tuner=_tcfg("jax"))
    assert_close(params_of(m), jax_params(jm))


@pytest.mark.parametrize("site,kw,reason,tkw", [
    ("swap_research_crash", {"times": 1}, "research_crash", {}),
    ("swap_reshard_corruption", {"times": 1, "delta": 2.0}, "swap_failed",
     {}),
    ("swap_regression", {"times": 1, "factor": 100.0},
     "post_swap_regression", {"guard_band": 0.5, "hysteresis_steps": 5}),
])
def test_fault_sites_roll_back_and_training_goes_on_as_jax(site, kw, reason,
                                                           tkw):
    epochs = 3 if site == "swap_regression" else 2
    m, fi = _port_fit([(site, kw)], epochs=epochs, **tkw)
    t = m._tuner
    assert fi.fired.get(site) == 1
    bad = [h for h in t.swap_history if h.get("reason") == reason]
    assert bad, t.swap_history
    assert t.outcomes["rolled_back"] >= 1
    assert sum(t.outcomes.values()) == len(t.swap_history)
    if site == "swap_reshard_corruption":
        assert "not bit-exact" in bad[0]["detail"]
        assert bad[0]["fingerprint"] in t.quarantined
    if site == "swap_regression":
        assert bad[0]["regression_ratio"] > 1.5
        assert bad[0]["fingerprint"] in t.quarantined
        assert strategy_fingerprint(m.graph, m.searched_views) != \
            bad[0]["fingerprint"]
    jm = _jax_fit([(site, kw)], epochs=epochs, **tkw)
    assert_close(params_of(m), jax_params(jm))


def test_calibration_probe_launches_research_as_jax():
    """tests/test_tuner.py::test_calibration_probe_launches_research:
    `probe_after_steps` runs explain_strategy at a step boundary; the
    costs measured on the CPU are far from the cost model's, so the
    miscalibration alone launches a re-search, in both packages, and
    training goes on as JAX's."""
    m, _ = _port_fit(drift_threshold=0.5, probe_after_steps=1)
    t = m._tuner
    assert t._probed
    assert t.swap_history, "probe-driven drift never launched a cycle"
    jm = _jax_fit(drift_threshold=0.5, probe_after_steps=1)
    assert jm._tuner._probed and jm._tuner.swap_history
    assert_close(params_of(m), jax_params(jm))


def test_reshard_corruption_leaves_the_live_weights_untouched():
    _, m = pair()
    x, y = dataset()
    m.fit(x, y, batch_size=8, epochs=1, verbose=False)
    fi = FaultInjector().inject("swap_reshard_corruption", times=1,
                                delta=2.0)
    tuner = StrategyTuner(m, _tcfg(), fault_injector=fi)
    tuner._last_batch = ([x[:8]], y[:8])
    tuner._candidate = _candidate(tuner, m)
    pre, old_ex = params_of(m), m.executor
    assert tuner._execute_swap(step=3) is False
    assert m.executor is old_ex
    assert_close(params_of(m), pre, atol=0, rtol=0)


def test_after_a_swap_no_stale_weight_copies_serve():
    x, y = dataset()
    m = small_model(mixed=True)
    m.fit(x, y, batch_size=8, epochs=1, verbose=False)
    m.predict(x[:8])  # the old executor's compute-dtype copies, warm
    tuner = StrategyTuner(m, _tcfg())
    tuner._last_batch = ([x[:8]], y[:8])
    tuner._candidate = _candidate(tuner, m)
    assert tuner._execute_swap(step=8)
    m.fit(x[:8], y[:8], batch_size=8, epochs=1, verbose=False)
    fresh = small_model(mixed=True)
    params_from_numpy(fresh, params_of(m))
    assert torch.equal(torch.as_tensor(m.predict(x[:16])),
                       torch.as_tensor(fresh.predict(x[:16])))
    assert m.eval(x[:16], y[:16]).train_all == \
        fresh.eval(x[:16], y[:16]).train_all


# ----------------------------------------------------------------------
# recompile triggers
# ----------------------------------------------------------------------
def test_recompile_on_condition_as_jax():
    jm, m = pair()
    x, y = dataset()
    m.fit(x, y, batch_size=8, epochs=1, verbose=False)
    jm.fit(x, y, batch_size=8, epochs=1, verbose=False)
    calls = []
    st = trec.RecompileState(lambda model: True, calls.append)
    jst = jrec.RecompileState(lambda model: True, lambda model: None)
    assert not trec.recompile_on_condition(
        m, trec.RecompileState(lambda model: False))
    assert trec.recompile_on_condition(m, st)
    assert jrec.recompile_on_condition(jm, jst)
    assert st.recompilations == jst.recompilations == 1 and calls == [m]
    assert m.state.step == int(jm.state.step) == 8
    assert_close(params_of(m), jax_params(jm))
    # the optimizer state is fresh after a recompile in both packages
    m.fit(x, y, batch_size=8, epochs=1, verbose=False)
    jm.fit(x, y, batch_size=8, epochs=1, verbose=False)
    assert_close(params_of(m), jax_params(jm))


# ----------------------------------------------------------------------
# 4 gloo ranks: a committed swap from dp 4 to tensor parallel 2
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tuner_ranks")
    x, y = dataset()
    np.savez(d / "data.npz", x0=x, y=y)
    init = jax_params(jax_model(4))
    np.savez(d / "init.npz", **{f"{op}/{n}": a for op, ws in init.items()
                                for n, a in ws.items()})
    case = {"name": "tuner_dp4", "mode": "tuner_swap", "builder": "mlp",
            "builder_kwargs": {"batch": 8, "width": 4, "hidden": 16,
                               "classes": 3},
            "loss": "sparse_categorical_crossentropy",
            "optimizer": {"lr": 0.1, "momentum": 0.9},
            "config": {"batch_size": 8}, "data": str(d / "data.npz"),
            "init_weights": str(d / "init.npz"), "epochs": 2,
            "rewrites": REWRITES,
            "tuner": dict(drift_threshold=-1.0, hysteresis_steps=1,
                          cooldown_steps=3, warmup_steps=0, min_win=-100.0,
                          post_swap_steps=2, search_budget=4,
                          guard_band=1e9)}
    (d / "spec.json").write_text(json.dumps([case]))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(launch, 4, ["--device", "cpu", CASES,
                                  str(d / "spec.json"), str(d)], str(d),
                      timeout=TIMEOUT)
    yield {"dir": d, "future": fut, "data": (x, y)}
    pool.shutdown(wait=True)


def test_a_committed_swap_at_4_ranks_matches_jax(ranks):
    ranks["future"].result(timeout=2 * TIMEOUT + 60)
    d = ranks["dir"]
    outs = []
    for r in range(4):
        f = d / f"tuner_dp4.rank{r}.json"
        assert f.exists(), (d / f"rank{r}.log").read_text()
        o = json.loads(f.read_text())
        assert "error" not in o, o.get("traceback")
        outs.append(o)
    hist = outs[0]["history"]
    assert any(h["outcome"] == "committed" for h in hist), hist
    for o in outs:
        assert o["history"] == hist  # every rank, the same swaps
        assert o["outcomes"]["committed"] >= 1
        assert o["mesh"]["model"] == 2 and o["replicas"] == 2
    x, y = ranks["data"]
    jm = jax_model(4)
    with fixed_winner(REWRITES, "flexflow_tpu"):
        jm.fit(x, y, batch_size=8, epochs=2, verbose=False,
               tuner=_tcfg("jax"))
    assert jm._tuner.outcomes["committed"] >= 1
    with np.load(d / "tuner_dp4.npz") as z:
        got = {}
        for k in z.files:
            op, n = k[len("final/"):].split("/", 1)
            got.setdefault(op, {})[n] = z[k]
    assert_close(got, jax_params(jm))
