"""The numerical-trust layer of flexflow_tpu_torch (runtime/verify.py:
the differential strategy verifier, the SDC/determinism canary and their
pieces) and fit(verify_strategy=, canary=) against the JAX package's.

The same small models are built in both packages (tests/test_verify.py's
MLP, CNN and attention models; the searched ones on 8 workers: the JAX
package's 8 CPU devices, the port's 8 simulated ones demoted to its one
device). Verdicts, the op named as the first divergence, the tensor a
bitflip lands in and the step it is caught at must be the same in both;
the tolerances (`tolerance_for`, `tolerance_from_budget`) and the
mismatch reports of `compare_step_results` are the same values and
strings. A canaried fit is held to an uncanaried one bit for bit, since
both run the same eager steps on the same seeds; the two packages'
weights are not compared (XLA and torch sum in other orders: the
training parity tests hold that, tests/test_torch_port_train.py).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import flexflow_tpu as jff
from flexflow_tpu.runtime import verify as jvfy
import flexflow_tpu_torch as tff
from flexflow_tpu_torch.parallel.executor import _tensors
from flexflow_tpu_torch.runtime import verify as tvfy


def small_model(pkg, hidden=16, layers=2, batch=8, search_budget=None,
                features=4, classes=3):
    if pkg is tff:
        cfg = tff.FFConfig(device="cpu", batch_size=batch)
        if search_budget is not None:
            cfg.search_budget = search_budget
            cfg.search_num_workers = 8
    else:
        cfg = jff.FFConfig()
        cfg.batch_size = batch
        if search_budget is not None:
            cfg.search_budget = search_budget
    m = pkg.FFModel(cfg)
    x = m.create_tensor((batch, features), pkg.DataType.DT_FLOAT)
    t = x
    for _ in range(layers - 1):
        t = m.dense(t, hidden, pkg.ActiMode.AC_MODE_RELU)
    t = m.softmax(m.dense(t, classes))
    _compile(pkg, m, pkg.SGDOptimizer(lr=0.1))
    return m


def _compile(pkg, m, opt):
    import warnings

    with warnings.catch_warnings():
        # the port's 8-worker winners address devices the one device
        # lacks: compile says so before it demotes them
        warnings.filterwarnings("ignore", message="searched strategy failed")
        m.compile(opt, pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  [pkg.MetricsType.METRICS_ACCURACY])


def dataset(n=64, seed=0, features=4, classes=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, features).astype(np.float32)
    y = rng.randint(0, classes, (n, 1)).astype(np.int32)
    return x, y


def cnn_model(pkg):
    m = pkg.FFModel(_cnn_cfg(pkg))
    x = m.create_tensor((8, 3, 16, 16), pkg.DataType.DT_FLOAT)
    t = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1, pkg.ActiMode.AC_MODE_RELU)
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0)
    t = m.softmax(m.dense(m.flat(t), 4))
    _compile(pkg, m, pkg.SGDOptimizer(lr=0.05))
    rng = np.random.RandomState(0)
    return m, (rng.randn(16, 3, 16, 16).astype(np.float32),
               rng.randint(0, 4, (16, 1)).astype(np.int32))


def attention_model(pkg):
    m = pkg.FFModel(_cnn_cfg(pkg))
    x = m.create_tensor((8, 16, 32), pkg.DataType.DT_FLOAT)
    t = m.multihead_attention(x, x, x, 32, 4)
    t = m.dense(t, 32, pkg.ActiMode.AC_MODE_RELU)
    t = m.softmax(m.dense(t, 4))
    _compile(pkg, m, pkg.SGDOptimizer(lr=0.05))
    rng = np.random.RandomState(0)
    return m, (rng.randn(16, 16, 32).astype(np.float32),
               rng.randint(0, 4, (16, 16, 1)).astype(np.int32))


def _cnn_cfg(pkg):
    if pkg is tff:
        return tff.FFConfig(device="cpu", batch_size=8, search_budget=3,
                            search_num_workers=8)
    cfg = jff.FFConfig()
    cfg.batch_size = 8
    cfg.search_budget = 3
    return cfg


def _mlp(pkg):
    m = small_model(pkg, hidden=32, batch=32, search_budget=4, layers=3)
    return m, dataset(n=64)


def port_params(m):
    return {op: {n: w.detach().clone() for n, w in ws.items()}
            for op, ws in m.params.items()}


def state_of(m):
    return _tensors((m.state.params, m.state.opt_state, m.state.net_state))


def bit_equal(a, b):
    ta, tb = state_of(a), state_of(b)
    return len(ta) == len(tb) and all(torch.equal(p, q)
                                      for p, q in zip(ta, tb))


def _break_activation(m):
    """tests/test_verify.py's: the first dense op's RELU dropped (first
    in topological order: a searched rewrite appends its ops to the
    graph's list)."""
    for op in m.graph.topo_order():
        if (op.op_type.name == "OP_LINEAR"
                and getattr(op.params, "activation", None) is not None
                and op.params.activation.name == "AC_MODE_RELU"):
            op.params = dataclasses.replace(
                op.params, activation=type(op.params.activation).AC_MODE_NONE)
            return op.name
    raise AssertionError("no relu dense op to break")


def _invalidate(m):
    # the JAX executor caches its jitted steps; the port's eager steps
    # read op params at each call
    if hasattr(m.executor, "invalidate_step_cache"):
        m.executor.invalidate_step_cache()


# -- the verifier ------------------------------------------------------------------

@pytest.mark.parametrize("build", [_mlp, cnn_model, attention_model],
                         ids=["mlp", "cnn", "attention"])
def test_verify_strategy_ok_in_both(build):
    for pkg in (jff, tff):
        m, (x, y) = build(pkg)
        bs = x.shape[0] // 2
        v = pkg.verify_strategy(m, (x, y), steps=2, batch_size=bs)
        assert v.ok, (pkg.__name__, v.summary())
        assert v.steps == 2 and not v.param_mismatches
        assert len(v.loss_diffs) == 2


@pytest.mark.parametrize("fault", ["activation", "softmax_axis"])
def test_verify_strategy_names_the_same_diverging_op(fault):
    """A substitution that lost an activation, and a softmax over the
    batch axis instead of the classes: both packages name the same op."""
    named = {}
    for pkg in (jff, tff):
        if fault == "activation":
            m, (x, y) = _mlp(pkg)
            broken = _break_activation(m)
        else:
            m = small_model(pkg, hidden=32, batch=32, search_budget=4)
            x, y = dataset(n=64)
            soft = [op for op in m.graph.ops
                    if op.op_type.name == "OP_SOFTMAX"]
            soft[0].params = dataclasses.replace(soft[0].params, dim=0)
            broken = soft[0].name
        _invalidate(m)
        v = pkg.verify_strategy(m, (x, y), steps=2, batch_size=32)
        assert not v.ok
        assert v.diverging_op is not None and broken in v.diverging_op
        named[pkg] = v.diverging_op
    assert named[tff] == named[jff]


def test_fit_preflight_passes_a_sound_model_and_raises_on_a_broken_one():
    x, y = dataset()
    m = small_model(tff, hidden=16, batch=8, search_budget=3)
    m.fit(x, y, epochs=1, verbose=False, verify_strategy="preflight")
    assert m.state.step == 8
    m2 = small_model(tff, hidden=16, batch=8, search_budget=3)
    before = port_params(m2)
    rng_before = m2._rng.get_state()
    broken = _break_activation(m2)
    with pytest.raises(tff.StrategyDivergenceError) as ei:
        m2.fit(x, y, epochs=1, verbose=False, verify_strategy="preflight")
    assert ei.value.diverging_op is not None
    assert broken in ei.value.diverging_op
    assert ei.value.verdict is not None and not ei.value.verdict.ok
    # raised before any training: the live state is untouched
    assert m2.state.step == 0
    assert torch.equal(m2._rng.get_state(), rng_before)
    for op, ws in before.items():
        for n, w in ws.items():
            assert torch.equal(m2.params[op][n], w), f"{op}/{n}"


def test_verify_strategy_does_not_mutate_live_state():
    m = small_model(tff, hidden=16, batch=8)
    x, y = dataset()
    before = port_params(m)
    opt_before = [t.clone() for t in _tensors(m.state.opt_state)]
    v = tff.verify_strategy(m, (x, y), steps=2)
    assert v.ok and v.max_param_diff == 0.0
    for op, ws in before.items():
        for n, w in ws.items():
            assert torch.equal(m.params[op][n], w)
    assert all(torch.equal(a, b) for a, b in
               zip(_tensors(m.state.opt_state), opt_before))
    assert m.state.step == 0


def test_fit_rejects_unknown_verify_mode():
    m = small_model(tff)
    x, y = dataset()
    with pytest.raises(ValueError, match="preflight"):
        m.fit(x, y, epochs=1, verbose=False, verify_strategy="postflight")


def test_verify_strategy_needs_a_compiled_model():
    m = tff.FFModel(tff.FFConfig(device="cpu"))
    m.create_tensor((8, 4), tff.DataType.DT_FLOAT)
    x, y = dataset()
    with pytest.raises(tff.NotCompiledError):
        tff.verify_strategy(m, (x, y))


@pytest.mark.parametrize("dtype,budget", [
    ("float32", None), ("bfloat16", None), ("bfloat16", 0.1),
    ("float16", 1e-10), ("float64", 0.25), ("int8", None)])
def test_tolerances_match_jax(dtype, budget):
    assert tvfy.tolerance_from_budget(dtype, budget) == \
        jvfy.tolerance_from_budget(dtype, budget)
    tdt = getattr(torch, dtype) if dtype != "int8" else torch.int8
    jdt = None if dtype == "bfloat16" else np.dtype(dtype)
    if jdt is not None:
        assert tvfy.tolerance_for(tdt) == jvfy.tolerance_for(jdt)
        assert tvfy.tolerance_for(jdt, rtol=0.5) == \
            jvfy.tolerance_for(jdt, rtol=0.5)
    else:
        assert tvfy.tolerance_for(tdt) == jvfy.DTYPE_TOLERANCES["bfloat16"]


def test_compare_step_results_matches_jax():
    rng = np.random.RandomState(0)
    a = {"params": {"d": {"kernel": rng.randn(4, 3).astype(np.float32),
                          "bias": rng.randn(3).astype(np.float32)},
                    "e": {"kernel": rng.randn(2, 2).astype(np.float32)}},
         "loss": np.float32(1.5)}
    b = {"params": {"d": {"kernel": a["params"]["d"]["kernel"].copy(),
                          "bias": a["params"]["d"]["bias"] + 1e-3},
                    "e": {"kernel": a["params"]["e"]["kernel"].copy()}},
         "loss": np.float32(1.5)}
    b["params"]["e"]["kernel"][0, 0] = np.nextafter(
        b["params"]["e"]["kernel"][0, 0], np.float32(np.inf))

    def torch_tree(t):
        if isinstance(t, dict):
            return {k: torch_tree(v) for k, v in t.items()}
        return torch.as_tensor(np.asarray(t))

    for mode in ("determinism", "sdc"):
        for rtol in (None, 1e-2):
            want = jvfy.compare_step_results(a, b, mode=mode, rtol=rtol)
            got = tvfy.compare_step_results(torch_tree(a), torch_tree(b),
                                            mode=mode, rtol=rtol)
            assert got == want, (mode, rtol)
    assert tvfy.compare_step_results(torch_tree(a), torch_tree(a)) == []
    # bf16 is compared by its bytes too
    h = torch.tensor([1.0, 2.0], dtype=torch.bfloat16)
    h2 = h.clone()
    h2.view(torch.int16)[1] ^= 1
    assert tvfy.compare_step_results({"w": h}, {"w": h.clone()}) == []
    assert tvfy.compare_step_results({"w": h}, {"w": h2})[0].startswith(
        "w (bitwise")


def test_bitflip_params_matches_jax():
    rng = np.random.RandomState(1)
    params = {"b": {"kernel": rng.randn(3, 2).astype(np.float32)},
              "a": {"kernel": rng.randn(4).astype(np.float32),
                    "bias": rng.randn(2).astype(np.float32)}}
    tparams = {o: {n: torch.as_tensor(w) for n, w in ws.items()}
               for o, ws in params.items()}
    for kw in ({}, {"op": "b", "weight": "kernel", "bit": 3, "index": 9}):
        jnew, jname = jvfy.bitflip_params(params, **kw)
        tnew, tname = tvfy.bitflip_params(tparams, **kw)
        assert tname == jname
        o, n = tname.split("/")
        np.testing.assert_array_equal(tnew[o][n].numpy(),
                                      np.asarray(jnew[o][n]))
        # the caller's tree is not touched
        assert torch.equal(tparams[o][n], torch.as_tensor(params[o][n]))


# -- the canary -----------------------------------------------------------------

def test_canary_clean_run_matches_uncanaried_training():
    x, y = dataset()
    a = small_model(tff)
    a.fit(x, y, epochs=1, verbose=False)
    b = small_model(tff)
    b.fit(x, y, epochs=1, verbose=False,
          canary=tff.CanaryConfig(every_n_steps=2, mode="determinism"))
    c = small_model(tff)
    c.fit(x, y, epochs=1, verbose=False, fault_injector=tff.FaultInjector())
    assert bit_equal(a, b) and bit_equal(b, c)
    assert a.state.step == b.state.step == 8
    assert torch.equal(a._rng.get_state(), b._rng.get_state())


def test_canary_catches_bitflip_and_checkpoints(tmp_path):
    """The bitflip lands in the same tensor and is caught at the same step
    in both packages; the port's checkpoint holds the pre-step state, and
    a fit resumed from it (no fault) ends bit-equal to an uninterrupted
    one: the step-seed generator was put back too."""
    x, y = dataset()
    caught = {}
    for pkg in (jff, tff):
        d = str(tmp_path / pkg.__name__)
        m = small_model(pkg)
        fi = pkg.FaultInjector()
        fi.inject("bitflip", at_step=4)
        with pytest.raises(pkg.CanaryMismatchError) as ei:
            m.fit(x, y, epochs=2, verbose=False, checkpoint_dir=d,
                  checkpoint_every_n_steps=100, resume=False,
                  fault_injector=fi,
                  canary=pkg.CanaryConfig(every_n_steps=2,
                                          mode="determinism"))
        e = ei.value
        assert e.step == 4 and e.mismatches
        assert os.path.isdir(e.checkpoint_path)
        assert pkg.verify_checkpoint(e.checkpoint_path)["ok"]
        caught[pkg] = (e.step, e.mismatches[0].split(" ")[0])
        if pkg is tff:
            port, port_dir = m, d
    assert caught[tff] == caught[jff]
    # the live state is the pre-step state: a twin trained 4 steps
    twin = small_model(tff)
    twin.fit(x[:32], y[:32], epochs=1, verbose=False,
             fault_injector=tff.FaultInjector())
    assert bit_equal(port, twin)
    assert torch.equal(port._rng.get_state(), twin._rng.get_state())
    resumed = small_model(tff)
    resumed.fit(x, y, epochs=2, verbose=False, checkpoint_dir=port_dir,
                checkpoint_every_n_steps=100)
    whole = small_model(tff)
    whole.fit(x, y, epochs=2, verbose=False,
              fault_injector=tff.FaultInjector())
    assert bit_equal(resumed, whole) and resumed.state.step == 16


def test_canary_sdc_mode_catches_exponent_flip():
    x, y = dataset()
    for pkg in (jff, tff):
        m = small_model(pkg)
        fi = pkg.FaultInjector()
        fi.inject("bitflip", at_step=2, bit=6, index=3)
        with pytest.raises(pkg.CanaryMismatchError) as ei:
            m.fit(x, y, epochs=1, verbose=False, fault_injector=fi,
                  canary=pkg.CanaryConfig(every_n_steps=2, mode="sdc"))
        assert "rtol=" in ei.value.mismatches[0]


def test_invariant_loss_delta_escalates(tmp_path):
    m = small_model(tff)
    x, y = dataset()
    with pytest.raises(tff.InvariantViolationError) as ei:
        m.fit(x, y, epochs=1, verbose=False,
              checkpoint_dir=str(tmp_path / "ck"),
              canary=tff.CanaryConfig(every_n_steps=0, max_loss_delta=0.0))
    assert ei.value.invariant == "loss_delta"
    assert ei.value.step == 1
    assert ei.value.checkpoint_path is not None
    assert m.state.step == 1   # reverted to the state before step 1


def test_invariant_param_norm_drift_escalates():
    m = small_model(tff)
    x, y = dataset()
    with pytest.raises(tff.InvariantViolationError) as ei:
        m.fit(x, y, epochs=1, verbose=False,
              canary=tff.CanaryConfig(every_n_steps=0,
                                      max_param_norm_ratio=0.5))
    assert ei.value.invariant == "param_norm_drift"


def test_canary_counts_checks_and_violations(tmp_path):
    from flexflow_tpu_torch import obs

    x, y = dataset()
    m = small_model(tff)
    with obs.session(obs.TelemetryConfig(dir=str(tmp_path),
                                         flight_recorder=False,
                                         anomaly_detection=False)) as tel:
        m.fit(x, y, epochs=1, verbose=False,
              canary=tff.CanaryConfig(every_n_steps=3))
        fi = tff.FaultInjector()
        fi.inject("bitflip", at_step=0)
        with pytest.raises(tff.CanaryMismatchError):
            m.fit(x, y, epochs=1, verbose=False, fault_injector=fi,
                  canary=tff.CanaryConfig(every_n_steps=3))
        checks = tel.metrics.counter("ff_canary_checks_total", "").value
        bad = tel.metrics.counter("ff_canary_violations_total", "").value
    assert (checks, bad) == (4, 1)   # steps 0, 3, 6, then step 0 again
    events = obs.read_events_jsonl(str(tmp_path / "events.jsonl"))[0]
    v = [e for e in events if e["name"] == "canary_violation"]
    assert len(v) == 1 and v[0]["args"]["error"] == "CanaryMismatchError"


def test_canary_config_rejects_unknown_mode():
    for pkg in (jff, tff):
        with pytest.raises(ValueError, match="mode"):
            pkg.CanaryConfig(mode="paranoid")
    assert [f.name for f in dataclasses.fields(tff.CanaryConfig)] == \
        [f.name for f in dataclasses.fields(jff.CanaryConfig)]
    assert tff.CanaryConfig() == tff.CanaryConfig(**{
        f.name: getattr(jff.CanaryConfig(), f.name)
        for f in dataclasses.fields(jff.CanaryConfig)})


def test_error_classes_keep_the_jax_bases():
    from flexflow_tpu_torch.runtime.resilience import ResilienceError

    for name in ("CanaryMismatchError", "InvariantViolationError"):
        assert issubclass(getattr(tvfy, name), ResilienceError)
        assert issubclass(getattr(tvfy, name), tvfy.VerificationError)
    assert issubclass(tvfy.StrategyDivergenceError, tvfy.VerificationError)
