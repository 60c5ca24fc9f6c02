"""The obs layer of flexflow_tpu_torch (metrics registry, tracer, the
telemetry session and the facade) against the JAX package, on the CPU.

Exact equality throughout: both packages run the same pure-Python code
on the same operations, so the Prometheus text, the JSONL snapshots (the
wall clock patched to one value), the Chrome traces and the checkpoint
counters of the same resilient run are identical.
"""
import json
import os

import numpy as np
import pytest

import flexflow_tpu as jff
import flexflow_tpu.obs as jobs
from flexflow_tpu.obs import metrics as jmetrics
from flexflow_tpu.runtime import resilience as jrz
import flexflow_tpu_torch.obs as obs
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.ff_types import (ActiMode, DataType, LossType,
                                         MetricsType)
from flexflow_tpu_torch.obs import metrics as tmetrics
from flexflow_tpu_torch.runtime import resilience as rz


def _drive(reg):
    """One sequence of counter, gauge and histogram operations."""
    reg.counter("ff_steps_total", "training steps run").inc()
    reg.counter("ff_steps_total", "training steps run").inc(4)
    reg.counter("ff_bytes_total", "bytes", kind="all-reduce").inc(2.5e9)
    reg.counter("ff_bytes_total", "bytes", kind="gather").inc(7)
    reg.gauge("ff_loss_scale", "dynamic loss scale").set(1024.0)
    reg.gauge("ff_loss_scale", "dynamic loss scale").set(512.0)
    reg.gauge("ff_loss", "last observed loss").set(float("nan"))
    h = reg.histogram("ff_step_wall_seconds", "per-step wall time")
    for v in np.random.RandomState(0).lognormal(-3.0, 1.5, 300):
        h.observe(float(v))
    reg.histogram("ff_latency_seconds", "latency", route="a").observe(0.25)


def test_registry_text_and_snapshots_equal_jax(monkeypatch):
    monkeypatch.setattr(jmetrics.time, "time", lambda: 1234.5)
    monkeypatch.setattr(tmetrics.time, "time", lambda: 1234.5)
    mine, theirs = obs.MetricsRegistry(), jobs.MetricsRegistry()
    _drive(mine)
    _drive(theirs)
    assert mine.to_prometheus() == theirs.to_prometheus()
    assert mine.to_jsonl() == theirs.to_jsonl()
    text = mine.to_prometheus()
    # a NaN gauge equals nothing: compare the reprs
    for a, b in ((mine.export_state(), theirs.export_state()),
                 (obs.parse_prometheus(text), jobs.parse_prometheus(text)),
                 (obs.parse_prometheus_labeled(text),
                  jobs.parse_prometheus_labeled(text))):
        assert repr(a) == repr(b)


def _events(tracer):
    with tracer.span("checkpoint_save", cat="checkpoint", step=3):
        tracer.instant("retry", cat="runtime", attempt=0, delay_s=0.05)
    tracer.counter("hbm", cat="device", used=1.5, free=2.0)
    tracer.emit({"ts": 0.5, "ph": "X", "name": "step", "cat": "train",
                 "dur": 0.25, "tid": 0, "args": {"step": 0}})


def test_tracer_events_validate_and_trace_as_jax(tmp_path):
    tr = obs.Tracer(str(tmp_path / "events.jsonl"))
    _events(tr)
    tr.close()
    events, problems = obs.read_events_jsonl(str(tmp_path / "events.jsonl"))
    assert len(events) == 4 and problems == []
    for e in events:
        assert obs.validate_event(e) == [] and jobs.validate_event(e) == []
    assert obs.validate_event({"ph": "X"}) == jobs.validate_event({"ph": "X"})
    assert obs.to_chrome_trace(events) == jobs.to_chrome_trace(events)


def test_the_facade_is_a_no_op_without_a_session(capsys):
    assert obs.active() is None and obs.tracer() is obs.NULL_TRACER
    with obs.span("x"):
        obs.event("y")
        obs.count("ff_x_total")
        obs.gauge_set("ff_x", 1.0)
        obs.observe("ff_x_seconds", 0.1)
    assert obs.forensics_dump("why") is None
    assert obs.record_failure(RuntimeError("boom")) is None
    obs.progress("hello", verbose=True)
    obs.progress("quiet", verbose=False)
    assert capsys.readouterr().out == "hello\n"


def _cfg(path, **kw):
    return obs.TelemetryConfig(dir=str(path), flight_recorder=False,
                               anomaly_detection=False, **kw)


def test_a_session_writes_its_four_files(tmp_path):
    with obs.session(_cfg(tmp_path)) as tel:
        assert obs.active() is tel
        obs.count("ff_checkpoint_saves_total", help="saves")
        obs.progress("line", verbose=False, name="epoch", epoch=0)
        tel.record_step(step=0, dur_s=0.01, batch_size=8, n_chips=1)
        tel.record_epoch(epoch=0, loss=1.0, steps=1, skipped=1.0)
    assert obs.active() is None
    for name in ("events.jsonl", "metrics.prom", "metrics.jsonl",
                 "trace.json"):
        assert os.path.exists(tmp_path / name), name
    prom = obs.parse_prometheus((tmp_path / "metrics.prom").read_text())
    assert prom["ff_checkpoint_saves_total"] == 1
    assert prom["ff_nonfinite_skips_total"] == 1
    assert prom["ff_steps_total"] == 1
    events, problems = obs.read_events_jsonl(str(tmp_path / "events.jsonl"))
    assert problems == []
    names = [e["name"] for e in events]
    assert names[0] == "session_start" and names[-1] == "session_end"
    assert "epoch" in names and "step" in names
    json.loads((tmp_path / "trace.json").read_text())


@pytest.mark.parametrize("field,value", [
    ("flight_recorder", True), ("anomaly_detection", True),
    ("fleet_spool_dir", "/nonexistent/spool"),
    ("calibration_path", "/nonexistent/cal.json"), ("step_profile", True)])
def test_unported_session_fields_raise_naming_themselves(tmp_path, field,
                                                         value):
    kw = {"flight_recorder": False, "anomaly_detection": False, field: value}
    with pytest.raises(NotImplementedError, match=field):
        obs.start(obs.TelemetryConfig(dir=str(tmp_path), **kw))
    assert obs.active() is None


def test_config_keeps_the_jax_fields_and_defaults():
    import dataclasses

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(obs.TelemetryConfig) == fields(jobs.TelemetryConfig)


def test_attach_model_names_the_analysis_modules(tmp_path):
    tel = obs.Telemetry(_cfg(tmp_path))
    with pytest.raises(NotImplementedError, match="analysis"):
        tel.attach_model(object())
    tel.finish()


def _port_model():
    m = FFModel(FFConfig(batch_size=8, device="cpu"))
    x = m.create_tensor((8, 4), DataType.DT_FLOAT)
    m.softmax(m.dense(m.dense(x, 16, ActiMode.AC_MODE_RELU), 3))
    m.compile(SGDOptimizer(lr=0.1, momentum=0.9),
              LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              [MetricsType.METRICS_ACCURACY])
    return m


def _jax_model():
    cfg = jff.FFConfig()
    cfg.batch_size = 8
    cfg.workersPerNode = 1
    m = jff.FFModel(cfg)
    x = m.create_tensor((8, 4), jff.DataType.DT_FLOAT)
    m.softmax(m.dense(m.dense(x, 16, jff.ActiMode.AC_MODE_RELU), 3))
    m.compile(jff.SGDOptimizer(lr=0.1, momentum=0.9),
              jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              [jff.MetricsType.METRICS_ACCURACY])
    return m


def test_resilient_fit_counts_checkpoints_as_jax(tmp_path):
    """The same resilient run (cadence 3 over 8 steps, a disk bit flip
    on the step-6 checkpoint), then a restore that falls back past it,
    inside a session in each package: the ff_checkpoint_* counters (and
    the bytes gauge: the same tensors) of both metrics.prom files are
    equal."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 4).astype(np.float32)
    y = rng.randint(0, 3, (64, 1)).astype(np.int32)
    got = {}
    for pkg, mod, make, res in (("port", obs, _port_model, rz),
                                ("jax", jobs, _jax_model, jrz)):
        d = tmp_path / pkg
        fi = res.FaultInjector().inject("bitflip", at_step=6, target="disk")
        cfg = mod.TelemetryConfig(dir=str(d / "tel"), flight_recorder=False,
                                  anomaly_detection=False)
        with mod.session(cfg):
            m = make()
            m.fit(x, y, verbose=False, checkpoint_dir=str(d / "ck"),
                  checkpoint_every_n_steps=3, keep_last_n=4,
                  fault_injector=fi)
            mgr = res.CheckpointManager(str(d / "ck"))
            # the newest (the done-save at 8) restores: corrupt step 6
            # sits behind it, so point LATEST at 6 to make it fall back
            (d / "ck" / "LATEST").write_text("6")
            with pytest.warns(UserWarning, match="falling back"):
                assert mgr.restore_latest(make()).step == 8
        prom = mod.parse_prometheus((d / "tel" / "metrics.prom").read_text())
        got[pkg] = {k: v for k, v in prom.items()
                    if k.startswith("ff_checkpoint_")}
    assert got["port"] == got["jax"]
    assert got["port"]["ff_checkpoint_saves_total"] == 3
    assert got["port"]["ff_checkpoint_restore_fallbacks_total"] == 1
    assert got["port"]["ff_checkpoint_restores_total"] == 1


@pytest.mark.parametrize("spd", [1, 3])
def test_a_plain_fit_feeds_the_session_as_jax(tmp_path, spd):
    """A plain fit inside a session counts its steps and samples as the
    JAX package's stepwise fit does, stepwise or through the train scan
    (chunks of 3: one step_chunk span each)."""
    rng = np.random.RandomState(1)
    x = rng.randn(64, 4).astype(np.float32)
    y = rng.randint(0, 3, (64, 1)).astype(np.int32)
    got = {}
    for pkg, mod, make in (("port", obs, _port_model), ("jax", jobs,
                                                          _jax_model)):
        d = tmp_path / pkg
        cfg = mod.TelemetryConfig(dir=str(d), flight_recorder=False,
                                  anomaly_detection=False)
        with mod.session(cfg):
            m = make()
            if pkg == "port":
                m.config.iterations_per_dispatch = spd
            m.fit(x, y, epochs=2, verbose=False)
        prom = mod.parse_prometheus((d / "metrics.prom").read_text())
        got[pkg] = {k: prom[k] for k in ("ff_steps_total",
                                         "ff_samples_total")}
        if pkg == "port":
            events, _ = obs.read_events_jsonl(str(d / "events.jsonl"))
            spans = [e["name"] for e in events if e["ph"] == "X"]
            assert spans == (["step"] * 16 if spd == 1
                             else ["step_chunk"] * 6)
    assert got["port"] == got["jax"] == {"ff_steps_total": 16,
                                         "ff_samples_total": 128}
