"""Checkpoints and the resilient training loop of flexflow_tpu_torch
against the JAX package, on the CPU.

Port counterparts of the JAX package's tests (tests/test_resilience.py:
retry, the fault injector, atomic and retained checkpoints, the fallback
past a corrupt newest, preemption hard and graceful, the step guard;
tests/test_runtime.py: round trip, topology mismatch; tests/test_verify.py:
the audit, the disk bit flip, checkpoints without integrity), the drain
protocol, and parity with the JAX package on its `small_model` (dense 16
relu, dense 3, softmax; SGD lr 0.1 momentum 0.9, sparse CE) and an Adam
variant, weights carried across with `train_state_from_numpy`.

Tolerances: params atol 1e-5 / rtol 1e-5 against JAX (both packages sum
the same products in other orders); the guard's counters and loss scale
exactly (they depend only on which steps are finite); the crc32
integrity records identical (the same bytes); within the port, resumed
against uninterrupted runs `torch.equal` (the same ops on the same data
and seeds).
"""
import inspect
import json
import os
import shutil

import numpy as np
import pytest
import torch

import flexflow_tpu as jff
from flexflow_tpu.runtime import checkpoint as jckpt
from flexflow_tpu.runtime import resilience as jrz
from flexflow_tpu.runtime import verify as jvfy
from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel,
                                SGDOptimizer)
from flexflow_tpu_torch.ff_types import (ActiMode, DataType, LossType,
                                         MetricsType)
from flexflow_tpu_torch.runtime import verify as vfy
from flexflow_tpu_torch.runtime.checkpoint import (load_checkpoint_meta,
                                                   restore_checkpoint,
                                                   save_checkpoint)
from flexflow_tpu_torch.runtime.resilience import (CheckpointManager,
                                                   FaultInjector,
                                                   NonFiniteGradientsError,
                                                   PreemptionSignal,
                                                   RetryPolicy, SliceDrained,
                                                   StepGuardConfig,
                                                   TrainingPreempted,
                                                   restore_latest, retry)
from flexflow_tpu_torch.runtime.verify import (CheckpointCorruptionError,
                                               verify_checkpoint)
from flexflow_tpu_torch.runtime.weights import train_state_from_numpy

RTOL = ATOL = 1e-5


def small_model(hidden=16, adam=False, extra_layer=False):
    m = FFModel(FFConfig(batch_size=8, device="cpu"))
    x = m.create_tensor((8, 4), DataType.DT_FLOAT)
    t = m.dense(x, hidden, ActiMode.AC_MODE_RELU)
    if extra_layer:
        t = m.dense(t, hidden, ActiMode.AC_MODE_RELU)
    t = m.dense(t, 3)
    t = m.softmax(t)
    m.compile(AdamOptimizer(alpha=0.01) if adam
              else SGDOptimizer(lr=0.1, momentum=0.9),
              LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              [MetricsType.METRICS_ACCURACY])
    return m


def jax_small_model(adam=False):
    cfg = jff.FFConfig()
    cfg.batch_size = 8
    cfg.workersPerNode = 1
    m = jff.FFModel(cfg)
    x = m.create_tensor((8, 4), jff.DataType.DT_FLOAT)
    t = m.dense(x, 16, jff.ActiMode.AC_MODE_RELU)
    t = m.dense(t, 3)
    t = m.softmax(t)
    m.compile(jff.AdamOptimizer(alpha=0.01) if adam
              else jff.SGDOptimizer(lr=0.1, momentum=0.9),
              jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              [jff.MetricsType.METRICS_ACCURACY])
    return m


def dataset(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = rng.randint(0, 3, (n, 1)).astype(np.int32)
    return x, y


def _np(tree):
    """A JAX (or torch) state nest as numpy arrays, None kept."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return np.array(tree, copy=True)


def params_of(m):
    return {op: {n: w.clone() for n, w in ws.items()}
            for op, ws in m.params.items()}


def state_tensors(m):
    """Every tensor of the training state by name: params, optimizer
    state (Adam's beta_t included), guard counters."""
    from flexflow_tpu_torch.runtime.verify import (_flat_path,
                                                   _leaves_with_path)

    tree = {"params": m.state.params, "opt_state": m.state.opt_state,
            "guard": m.state.guard.as_dict() if m.state.guard else None}
    return {_flat_path(p): t for p, t in _leaves_with_path(tree)
            if t is not None}


def assert_states_equal(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def assert_params_close(a, b, atol=1e-6):
    for op, ws in a.items():
        for n, w in ws.items():
            np.testing.assert_allclose(np.asarray(b[op][n]), np.asarray(w),
                                       atol=atol, err_msg=f"{op}/{n}")


def guard_of(state):
    g = state.guard
    return (float(np.asarray(g.loss_scale)), int(np.asarray(g.good_steps)),
            int(np.asarray(g.consecutive_skips)),
            int(np.asarray(g.total_skips)))


# ----------------------------------------------------------------------
# retry / backoff (tests/test_resilience.py)
# ----------------------------------------------------------------------
def test_retry_succeeds_after_transient_failures():
    delays, calls = [], []
    policy = RetryPolicy(max_attempts=4, base_delay_s=0.1, multiplier=2.0,
                         jitter=0.0)

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise IOError("transient")
        return "ok"

    assert retry(flaky, policy, sleep=delays.append) == "ok"
    assert len(calls) == 3
    assert delays == pytest.approx([0.1, 0.2])


def test_retry_exhaustion_raises_last_error():
    calls = []

    def always_fails():
        calls.append(1)
        raise ConnectionError("down")

    with pytest.raises(ConnectionError):
        retry(always_fails, RetryPolicy(max_attempts=3, base_delay_s=0.0,
                                        jitter=0.0), sleep=lambda d: None)
    assert len(calls) == 3


def test_retry_non_retryable_propagates_immediately():
    calls = []

    def bad():
        calls.append(1)
        raise ValueError("logic bug")

    with pytest.raises(ValueError):
        retry(bad, RetryPolicy(max_attempts=5), sleep=lambda d: None)
    assert len(calls) == 1


@pytest.mark.parametrize("attempt", [0, 1, 3, 7])
def test_retry_policy_delay_equals_jax_under_a_seeded_rand(attempt):
    """The same policy and the same seeded draws give JAX's delays, and
    jitter stays inside the cap's +/- band."""
    kw = dict(base_delay_s=1.0, multiplier=10.0, max_delay_s=5.0,
              jitter=0.5)
    mine, theirs = RetryPolicy(**kw), jrz.RetryPolicy(**kw)
    ra, rb = np.random.RandomState(attempt), np.random.RandomState(attempt)
    for _ in range(8):
        d = mine.delay(attempt, rand=ra.random_sample)
        assert d == theirs.delay(attempt, rand=rb.random_sample)
        cap = min(5.0, 10.0 ** attempt)
        assert 0.5 * cap - 1e-9 <= d <= 1.5 * cap + 1e-9


# ----------------------------------------------------------------------
# fault injector
# ----------------------------------------------------------------------
def test_fault_injector_step_targeting_and_shot_count():
    fi = FaultInjector()
    fi.inject("nan_grads", at_step=3, times=2)
    assert fi.fire("nan_grads", 2) is None
    assert fi.fire("nan_grads", 3) is not None
    assert fi.fire("nan_grads", 3) is not None
    assert fi.fire("nan_grads", 3) is None
    assert fi.pending("nan_grads") == 0
    assert fi.fired["nan_grads"] == 2


def test_fault_injector_raises_armed_exception():
    fi = FaultInjector()
    fi.inject("checkpoint_write", exc=IOError("disk full"), times=1)
    with pytest.raises(IOError, match="disk full"):
        fi.fire("checkpoint_write", 0)
    assert fi.fire("checkpoint_write", 1) is None


def test_fault_injector_fire_extras_matching():
    fi = FaultInjector()
    fi.inject("bitflip", at_step=3, target="disk")
    fi.inject("bitflip", at_step=3)
    plan = fi.fire("bitflip", 3, target=None)
    assert plan is not None and plan.get("target") is None
    plan = fi.fire("bitflip", 3, target="disk")
    assert plan is not None and plan["target"] == "disk"
    assert fi.fire("bitflip", 3) is None


# ----------------------------------------------------------------------
# checkpoint manager: atomicity, retention, latest, fallback
# ----------------------------------------------------------------------
def _no_partials(directory):
    return [n for n in os.listdir(directory) if ".tmp" in n]


def test_checkpoint_write_ioerror_is_retried_atomically(tmp_path):
    m = small_model()
    fi = FaultInjector()
    fi.inject("checkpoint_write", exc=IOError("injected"), times=1)
    mgr = CheckpointManager(str(tmp_path), fault_injector=fi,
                            retry_policy=RetryPolicy(max_attempts=3,
                                                     base_delay_s=0.0),
                            sleep=lambda d: None)
    path = mgr.save(m, step=5)
    assert fi.fired["checkpoint_write"] == 1
    assert os.path.isdir(path)
    assert _no_partials(str(tmp_path)) == []
    m2 = small_model()
    info = mgr.restore_latest(m2)
    assert info is not None and info.step == 5
    assert_params_close(params_of(m), params_of(m2))


def test_checkpoint_write_failure_never_leaves_partial(tmp_path):
    m = small_model()
    fi = FaultInjector()
    fi.inject("checkpoint_write", exc=IOError("injected"), times=10)
    mgr = CheckpointManager(str(tmp_path), fault_injector=fi,
                            retry_policy=RetryPolicy(max_attempts=2,
                                                     base_delay_s=0.0),
                            sleep=lambda d: None)
    with pytest.raises(IOError):
        mgr.save(m, step=1)
    assert mgr.list_steps() == []
    assert _no_partials(str(tmp_path)) == []


def test_checkpoint_retention_and_latest_pointer(tmp_path):
    m = small_model()
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
    for s in (1, 2, 3, 4, 5):
        mgr.save(m, step=s)
    assert mgr.list_steps() == [4, 5]
    assert mgr.latest_step() == 5
    assert not os.path.exists(mgr.step_path(3) + ".meta.json")


def test_restore_latest_falls_back_past_a_torn_newest(tmp_path):
    m = small_model()
    x, y = dataset(16)
    mgr = CheckpointManager(str(tmp_path), keep_last_n=3)
    mgr.save(m, step=1)
    m.fit(x, y, batch_size=8, epochs=1, verbose=False)
    good = params_of(m)
    mgr.save(m, step=2)
    m.fit(x, y, batch_size=8, epochs=1, verbose=False)
    mgr.save(m, step=3)
    shutil.rmtree(mgr.step_path(3))
    os.makedirs(mgr.step_path(3))
    m2 = small_model()
    with pytest.warns(UserWarning, match="falling back"):
        info = mgr.restore_latest(m2)
    assert info is not None and info.step == 2
    assert_params_close(good, params_of(m2))


def test_restore_latest_convenience_and_empty_dir(tmp_path):
    m = small_model()
    assert restore_latest(m, str(tmp_path)) is None
    CheckpointManager(str(tmp_path)).save(m, step=11)
    info = restore_latest(small_model(), str(tmp_path))
    assert info is not None and info.step == 11


# ----------------------------------------------------------------------
# preemption + mid-epoch resume
# ----------------------------------------------------------------------
@pytest.mark.parametrize("adam", [False, True])
def test_hard_preemption_resume_equals_uninterrupted(tmp_path, adam):
    """Killed at step 10 without a flush, a fresh model resumes from the
    step-9 checkpoint (mid-epoch cursor, the generator's state) and ends
    bit for bit where the uninterrupted run ends: weights, momentum or
    Adam's moments and beta_t, and the guard's counters."""
    x, y = dataset(64)
    kw = dict(batch_size=8, epochs=2, verbose=False,
              skip_nonfinite_steps=True)
    ref = small_model(adam=adam)
    ref.fit(x, y, fault_injector=FaultInjector().inject("nan_grads",
                                                        at_step=4), **kw)
    mB = small_model(adam=adam)
    fi = FaultInjector().inject("preempt", at_step=10, graceful=False)
    fi.inject("nan_grads", at_step=4)
    with pytest.raises(TrainingPreempted) as ei:
        mB.fit(x, y, checkpoint_dir=str(tmp_path),
               checkpoint_every_n_steps=3, fault_injector=fi, **kw)
    assert ei.value.step == 10
    assert ei.value.checkpoint_path is None
    mB2 = small_model(adam=adam)
    mB2.fit(x, y, checkpoint_dir=str(tmp_path), checkpoint_every_n_steps=3,
            **kw)
    assert mB2.state.step == ref.state.step == 16
    assert_states_equal(ref, mB2)


def test_graceful_preemption_flushes_final_checkpoint(tmp_path):
    x, y = dataset(64)
    mA = small_model()
    mA.fit(x, y, batch_size=8, epochs=2, verbose=False)
    mB = small_model()
    fi = FaultInjector().inject("preempt", at_step=7)
    with pytest.raises(TrainingPreempted) as ei:
        mB.fit(x, y, batch_size=8, epochs=2, verbose=False,
               checkpoint_dir=str(tmp_path), checkpoint_every_n_steps=100,
               fault_injector=fi)
    assert ei.value.checkpoint_path is not None
    assert os.path.isdir(ei.value.checkpoint_path)
    mB2 = small_model()
    mB2.fit(x, y, batch_size=8, epochs=2, verbose=False,
            checkpoint_dir=str(tmp_path), checkpoint_every_n_steps=100)
    assert_states_equal(mA, mB2)


def test_preemption_signal_flag_between_steps():
    x, y = dataset(32)
    sig = PreemptionSignal()
    sig.trigger(graceful=True)
    m = small_model()
    with pytest.raises(TrainingPreempted) as ei:
        m.fit(x, y, batch_size=8, epochs=1, verbose=False,
              preemption_signal=sig)
    assert ei.value.step == 0
    sig.clear()
    m.fit(x, y, batch_size=8, epochs=1, verbose=False, preemption_signal=sig)
    assert m.state.step == 4


def test_preemption_notice_drains_to_slice_drained_with_a_checkpoint(
        tmp_path):
    """A deadline-bearing notice at step 2 keeps training for the drain
    budget (max_drain_steps 3), then checkpoints and raises SliceDrained;
    a fresh model resumes from that checkpoint and ends where an
    uninterrupted run ends."""
    x, y = dataset(64)
    fi = FaultInjector().inject("preemption_notice", at_step=2,
                                deadline_s=600.0, slice=1,
                                surviving_devices=4, max_drain_steps=3)
    m = small_model()
    with pytest.raises(SliceDrained) as ei:
        m.fit(x, y, batch_size=8, epochs=1, verbose=False,
              checkpoint_dir=str(tmp_path), fault_injector=fi)
    e = ei.value
    assert (e.step, e.drained_steps, e.leaving_slice,
            e.surviving_devices) == (5, 3, 1, 4)
    assert e.met_deadline and e.simulated and e.graceful
    assert os.path.isdir(e.checkpoint_path)
    assert m.executor.step_dur_ema is not None
    meta = load_checkpoint_meta(e.checkpoint_path)
    assert meta["train"]["batch_index"] == 5 and not meta["train"]["done"]
    ref = small_model()
    ref.fit(x, y, batch_size=8, epochs=1, verbose=False)
    resumed = small_model()
    resumed.fit(x, y, batch_size=8, epochs=1, verbose=False,
                checkpoint_dir=str(tmp_path))
    assert_states_equal(ref, resumed)


# ----------------------------------------------------------------------
# NaN/Inf step guard
# ----------------------------------------------------------------------
def test_nan_step_skipped_without_corrupting_params(capsys):
    x, y = dataset(64)
    m = small_model()
    m.fit(x, y, batch_size=8, epochs=1, skip_nonfinite_steps=True,
          fault_injector=FaultInjector().inject("nan_grads", at_step=2))
    assert guard_of(m.state)[1:] == (5, 0, 1)
    assert guard_of(m.state)[0] == pytest.approx(0.5)
    assert all(torch.isfinite(w).all() for ws in m.params.values()
               for w in ws.values())
    assert "skipped_steps=1" in capsys.readouterr().out


@pytest.mark.parametrize("adam", [False, True])
def test_skipped_step_carries_params_and_optimizer_state_through(adam):
    """A poisoned step leaves the weights and every optimizer slot
    (momentum; Adam's m, v, beta1_t and beta2_t) bit for bit as they
    were."""
    x, y = dataset(16)
    m = small_model(adam=adam)
    m.fit(x[:8], y[:8], batch_size=8, epochs=1, verbose=False,
          skip_nonfinite_steps=True)
    before = {k: t.clone() for k, t in state_tensors(m).items()
              if not k.startswith("guard")}
    m.fit(x[8:16], y[8:16], batch_size=8, epochs=1, verbose=False,
          skip_nonfinite_steps=True,
          fault_injector=FaultInjector().inject("nan_grads", at_step=0))
    assert guard_of(m.state)[3] == 1
    after = state_tensors(m)
    for k, t in before.items():
        assert torch.equal(after[k], t), k


def test_persistent_nan_hard_fails_after_max_consecutive_skips():
    x, y = dataset(64)
    m = small_model()
    fi = FaultInjector().inject("nan_grads", times=1000)
    with pytest.raises(NonFiniteGradientsError, match="consecutive"):
        m.fit(x, y, batch_size=8, epochs=8, verbose=False,
              skip_nonfinite_steps=True, max_consecutive_skips=3,
              fault_injector=fi)
    assert guard_of(m.state)[2] == 3


def test_loss_scale_regrowth_after_backoff():
    x, y = dataset(64)
    m = small_model()
    m.fit(x, y, batch_size=8, epochs=1, verbose=False,
          step_guard=StepGuardConfig(growth_interval=3,
                                     max_consecutive_skips=5),
          fault_injector=FaultInjector().inject("nan_grads", at_step=1))
    assert guard_of(m.state)[0] == pytest.approx(1.0)
    assert guard_of(m.state)[3] == 1


def test_guard_state_round_trips_through_checkpoint(tmp_path):
    x, y = dataset(32)
    m = small_model()
    m.fit(x, y, batch_size=8, epochs=1, verbose=False,
          skip_nonfinite_steps=True,
          fault_injector=FaultInjector().inject("nan_grads", at_step=1),
          checkpoint_dir=str(tmp_path), checkpoint_every_n_steps=2)
    assert guard_of(m.state)[0] == pytest.approx(0.5)
    m2 = small_model()
    assert m2.state.guard is None
    assert CheckpointManager(str(tmp_path)).restore_latest(m2) is not None
    assert guard_of(m2.state) == guard_of(m.state)


def test_a_plain_fit_drops_the_guard_and_the_scan_refuses_it():
    x, y = dataset(16)
    m = small_model()
    m.fit(x, y, verbose=False, skip_nonfinite_steps=True)
    assert m.state.guard is not None and m.executor.step_guard is not None
    with pytest.raises(RuntimeError, match="dispatches stepwise"):
        m.executor.build_train_scan()
    m.fit(x, y, verbose=False)
    assert m.state.guard is None and m.executor.step_guard is None
    m.executor.build_train_scan()


def test_a_resilient_fit_dispatches_stepwise(tmp_path, monkeypatch):
    """With iterations_per_dispatch 3 a resilient fit still runs one
    step a dispatch (the scan is never built) and equals plain stepwise
    fit bit for bit."""
    x, y = dataset(32)
    ref = small_model()
    ref.fit(x, y, verbose=False)
    m = small_model()
    m.config.iterations_per_dispatch = 3

    def no_scan():
        raise AssertionError("the resilient loop built the scan")

    monkeypatch.setattr(m.executor, "build_train_scan", no_scan)
    m.fit(x, y, verbose=False, checkpoint_dir=str(tmp_path))
    assert_states_equal(ref, m)


# ----------------------------------------------------------------------
# the same run in both packages
# ----------------------------------------------------------------------
@pytest.mark.parametrize("adam", [False, True])
def test_guarded_run_matches_jax_step_by_step(adam):
    """One step a fit call under one FaultInjector plan (steps 1 and 2
    poisoned, then 3 good steps): the guard's loss scale and counters
    equal JAX's exactly after every step, the params stay within
    tolerance, and a skipped step's params are JAX's too."""
    x, y = dataset(64, seed=1)
    jm = jax_small_model(adam=adam)
    tm = small_model(adam=adam)
    train_state_from_numpy(tm, _np(jm.state.params), _np(jm.state.opt_state))
    guard = dict(init_loss_scale=8.0, growth_interval=2,
                 max_consecutive_skips=4)
    poisoned = (1, 2)
    for i in range(6):
        xb, yb = x[8 * i:8 * i + 8], y[8 * i:8 * i + 8]
        plans = [FaultInjector(), jrz.FaultInjector()]
        if i in poisoned:
            for fi in plans:
                fi.inject("nan_grads", at_step=0)
        tm.fit(xb, yb, verbose=False,
               step_guard=StepGuardConfig(**guard), fault_injector=plans[0])
        jm.fit(xb, yb, verbose=False,
               step_guard=jrz.StepGuardConfig(**guard),
               fault_injector=plans[1])
        assert guard_of(tm.state) == guard_of(jm.state), f"step {i}"
        for op, ws in tm.params.items():
            for n, w in ws.items():
                np.testing.assert_allclose(
                    w.numpy(), np.asarray(jm.state.params[op][n]),
                    rtol=RTOL, atol=ATOL, err_msg=f"step {i} {op}/{n}")
    # 8 -> 4 -> 2 (two skips), two good steps grow it to 4
    assert guard_of(tm.state) == (4.0, 1, 0, 2)


# ----------------------------------------------------------------------
# checkpoints: round trip, topology, integrity (test_runtime, test_verify)
# ----------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    m = small_model()
    x, y = dataset(24)
    m.fit(x, y, batch_size=8, epochs=1, verbose=False)
    path = str(tmp_path / "ckpt")
    save_checkpoint(m, path, step=42)
    m2 = small_model()
    assert restore_checkpoint(m2, path) == 42
    assert m2.state.step == 42
    assert_states_equal(m, m2)


def test_restore_writes_into_the_live_tensors(tmp_path):
    """A restore copies into the model's own tensors (captured graphs
    keep their addresses) and bumps their versions (the serving weight
    cache refreshes)."""
    m = small_model()
    path = str(tmp_path / "ckpt")
    save_checkpoint(m, path)
    m2 = small_model()
    m2.fit(*dataset(16), verbose=False)
    live = state_tensors(m2)
    versions = {k: t._version for k, t in live.items()}
    restore_checkpoint(m2, path)
    after = state_tensors(m2)
    for k, t in live.items():
        assert after[k] is t, k
        assert t._version > versions[k], k
    assert_states_equal(m, m2)


def test_checkpoint_topology_mismatch(tmp_path):
    m = small_model()
    path = str(tmp_path / "ckpt")
    save_checkpoint(m, path)
    restore_checkpoint(small_model(), path)
    m3 = small_model(extra_layer=True)
    before = params_of(m3)
    with pytest.raises(ValueError, match="topology mismatch"):
        restore_checkpoint(m3, path)
    assert_params_close(before, params_of(m3), atol=0)
    # elastic: matched by name, the rest keeps its fresh init
    restore_checkpoint(m3, path, strict_topology=False)
    rep = m3._restore_report
    assert rep["unmatched_model"] and not rep["replicated"]


def test_checkpoint_audit_and_corruption_detection(tmp_path):
    m = small_model()
    path = str(tmp_path / "ck")
    save_checkpoint(m, path, step=0)
    rep = verify_checkpoint(path)
    assert rep["ok"] and rep["has_integrity"] and rep["checked"] >= 4
    assert vfy._main([path]) == 0
    corrupted = vfy.corrupt_checkpoint_tensor(path)
    rep2 = verify_checkpoint(path)
    assert not rep2["ok"]
    assert rep2["corrupt"] == [corrupted]
    assert vfy._main([path]) == 1
    m2 = small_model()
    before = params_of(m2)
    with pytest.raises(CheckpointCorruptionError) as ei:
        restore_checkpoint(m2, path)
    assert ei.value.tensors == [corrupted]
    assert_params_close(before, params_of(m2), atol=0)


def test_restore_latest_falls_back_past_a_corrupt_newest(tmp_path):
    d = str(tmp_path / "ckpts")
    m = small_model()
    x, y = dataset()
    m.fit(x, y, epochs=2, verbose=False, checkpoint_dir=d,
          checkpoint_every_n_steps=4, resume=False)
    mgr = CheckpointManager(d)
    steps = mgr.list_steps()
    assert len(steps) >= 2
    vfy.corrupt_checkpoint_tensor(mgr.step_path(steps[-1]))
    with pytest.warns(UserWarning, match="falling back"):
        info = mgr.restore_latest(small_model())
    assert info is not None and info.step == steps[-2]


def test_bitflip_disk_site_caught_by_checksum_on_restore(tmp_path):
    d = str(tmp_path / "ckpts")
    m = small_model()
    x, y = dataset()
    fi = FaultInjector()
    fi.inject("bitflip", at_step=16, target="disk")
    m.fit(x, y, epochs=2, verbose=False, checkpoint_dir=d,
          checkpoint_every_n_steps=5, resume=False, fault_injector=fi)
    assert fi.fired.get("bitflip") == 1
    mgr = CheckpointManager(d)
    assert not verify_checkpoint(mgr.step_path(16))["ok"]
    with pytest.warns(UserWarning, match="falling back"):
        info = mgr.restore_latest(small_model())
    assert info is not None and info.step == 15


def test_old_checkpoints_without_integrity_still_restore(tmp_path):
    m = small_model()
    path = str(tmp_path / "ck")
    save_checkpoint(m, path, step=0)
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    del meta["integrity"]
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)
    vfy.corrupt_checkpoint_tensor(path)
    rep = verify_checkpoint(path)
    assert rep["ok"] and not rep["has_integrity"]
    assert restore_checkpoint(small_model(), path) == 0


def test_verify_checksums_names_the_corrupt_tensor():
    tree = {"params": {"d": {"bias": torch.zeros(4),
                             "kernel": torch.ones(2, 3)}}}
    integrity = {"algo": "crc32", "tensors": vfy.tensor_checksums(tree)}
    vfy.verify_checksums(tree, integrity)
    tree["params"]["d"]["bias"][0] = 7.0
    with pytest.raises(CheckpointCorruptionError) as ei:
        vfy.verify_checksums(tree, integrity, path="/x")
    assert ei.value.tensors == ["params/d/bias"]


def test_bitflip_array_flips_exactly_one_bit():
    a = np.zeros(8, np.float32)
    b = vfy.bitflip_array(a, bit=6, index=3)
    np.testing.assert_array_equal(b, jvfy.bitflip_array(a, bit=6, index=3))
    ab, bb = a.view(np.uint8), b.reshape(-1).view(np.uint8)
    diff = np.nonzero(ab != bb)[0]
    assert len(diff) == 1
    assert bin(int(ab[diff[0]]) ^ int(bb[diff[0]])).count("1") == 1


@pytest.mark.parametrize("adam", [False, True])
def test_integrity_record_and_ops_equal_jax(tmp_path, adam):
    """JAX's state after 3 guarded steps (one skipped), carried across
    with train_state_from_numpy: both packages' checkpoint sidecars give
    the same integrity record (names, dtypes, shapes, crc32) and the same
    ops list (layer guids aside: each package counts its own)."""
    x, y = dataset(24, seed=2)
    jm = jax_small_model(adam=adam)
    jm.fit(x, y, verbose=False, skip_nonfinite_steps=True,
           fault_injector=jrz.FaultInjector().inject("nan_grads", at_step=1))
    tm = small_model(adam=adam)
    g = jm.state.guard
    train_state_from_numpy(
        tm, _np(jm.state.params), _np(jm.state.opt_state),
        guard={k: np.asarray(getattr(g, k)) for k in (
            "loss_scale", "good_steps", "consecutive_skips",
            "total_skips")},
        step=jm.state.step)
    jckpt.save_checkpoint(jm, str(tmp_path / "jax"), step=3)
    save_checkpoint(tm, str(tmp_path / "port"), step=3)
    jmeta = jckpt.load_checkpoint_meta(str(tmp_path / "jax"))
    tmeta = load_checkpoint_meta(str(tmp_path / "port"))
    assert tmeta["integrity"] == jmeta["integrity"]
    assert "guard/loss_scale" in tmeta["integrity"]["tensors"]
    if adam:
        assert "opt_state/beta1_t" in tmeta["integrity"]["tensors"]
    strip = lambda ops: [{k: v for k, v in o.items() if k != "layer_guid"}  # noqa: E731
                         for o in ops]
    assert strip(tmeta["ops"]) == strip(jmeta["ops"])
    assert tmeta["version"] == jmeta["version"] == 3
    assert set(tmeta["topology"]) == set(jmeta["topology"])


# ----------------------------------------------------------------------
# surface: signature, unported keywords, exports
# ----------------------------------------------------------------------
def test_fit_has_the_jax_signature():
    """The same parameters, kinds and defaults (annotations aside)."""
    def params(f):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(f).parameters.values()]

    assert params(FFModel.fit) == params(jff.FFModel.fit)


@pytest.mark.parametrize("kw,value", [
    ("elastic", True), ("health_monitor", object()),
    ("verify_strategy", "preflight"), ("canary", object()),
    ("tuner", object()), ("lint", "error"), ("telemetry", object())])
def test_unported_fit_keywords_raise_naming_themselves(kw, value):
    x, y = dataset(16)
    m = small_model()
    with pytest.raises(NotImplementedError, match=rf"fit\({kw}="):
        m.fit(x, y, verbose=False, **{kw: value})
    assert m.state.step == 0


def test_the_runtime_exports_what_jax_exports_of_this_slice():
    import flexflow_tpu.runtime as jrt
    import flexflow_tpu_torch as tpkg
    import flexflow_tpu_torch.runtime as trt

    names = ("load_checkpoint_meta", "restore_checkpoint", "save_checkpoint",
             "CheckpointManager", "FaultInjector", "InferenceTimeout",
             "NonFiniteGradientsError", "PreemptionSignal",
             "ResilienceError", "RetryPolicy", "StepGuardConfig",
             "TrainingPreempted", "restore_latest", "retry",
             "CheckpointCorruptionError", "NotCompiledError",
             "VerificationError", "verify_checkpoint")
    for n in names:
        assert hasattr(jrt, n) and hasattr(trt, n), n
    for n in ("save_checkpoint", "restore_checkpoint", "StepGuardConfig",
              "FaultInjector", "verify_checkpoint"):
        assert hasattr(tpkg, n), n


def test_topology_fingerprint_has_the_jax_keys():
    from flexflow_tpu.runtime.elastic import topology_fingerprint as jtf
    from flexflow_tpu_torch.runtime.elastic import topology_fingerprint

    fp = topology_fingerprint(torch.device("cpu"))
    assert set(fp) == set(jtf())
    assert fp["num_devices"] == 1 and fp["platform"] == "cpu"


def test_train_state_from_numpy_rejects_mismatches():
    jm = jax_small_model()
    tm = small_model(adam=True)
    with pytest.raises(ValueError, match="opt_state"):
        train_state_from_numpy(tm, _np(jm.state.params),
                               _np(jm.state.opt_state))


# ----------------------------------------------------------------------
# serving after a restore
# ----------------------------------------------------------------------
def _lm(seed):
    m = FFModel(FFConfig(batch_size=2, device="cpu", seed=seed,
                         allow_mixed_precision=True))
    ids = m.create_tensor((2, 16), DataType.DT_INT32)
    t = m.embedding(ids, 37, 32)
    t = m.multihead_attention(t, t, t, 32, 4, causal=True)
    t = m.dense(t, 32, ActiMode.AC_MODE_RELU)
    m.softmax(m.dense(t, 37))
    m.compile(SGDOptimizer(lr=0.1),
              LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    with torch.no_grad():
        for ws in m.params.values():
            for w in ws.values():
                w.mul_(4.0)
    return m


def test_a_restored_model_serves_the_checkpoints_tokens(tmp_path):
    """A model that served once (its bf16 weight copies cached), then
    restored from another model's checkpoint, serves the tokens of a
    fresh model restored from it: the restore's in-place copies moved the
    weights' versions, so the cache refreshed."""
    from flexflow_tpu_torch.runtime.serving import incremental_generate

    prompts = np.random.RandomState(3).randint(0, 37, (2, 5)) \
        .astype(np.int32)
    served = _lm(seed=0)
    first = incremental_generate(served, prompts, max_new_tokens=8,
                                 max_len=16)
    other = _lm(seed=1)
    path = str(tmp_path / "other")
    save_checkpoint(other, path)
    restore_checkpoint(served, path)
    fresh = _lm(seed=2)
    restore_checkpoint(fresh, path)
    got = incremental_generate(served, prompts, max_new_tokens=8, max_len=16)
    want = incremental_generate(fresh, prompts, max_new_tokens=8, max_len=16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        want, incremental_generate(other, prompts, max_new_tokens=8,
                                   max_len=16))
    assert not np.array_equal(first, got)
