"""Telemetry session: ties the tracer + metrics registry to an output
directory and to a model's recorded search trajectory.

The PyTorch counterpart of flexflow_tpu/obs/telemetry.py:
`TelemetryConfig` with the JAX package's fields and defaults, and
`Telemetry` with its tracer, its registry, the dropped-events counter,
`attach_model` (the model's compile/search trajectory replayed into the
event log, the PCG gauges of the analysis passes, the grad-norm step
output armed), `record_step`/`record_chunk`/`record_epoch`, the
calibration store (`calibration_path`: obs/calibration.py),
`write_metrics` and `finish`, which flushes ``events.jsonl``,
``metrics.prom``, ``metrics.jsonl`` and the Perfetto-loadable
``trace.json``. Activate per fit with ``model.fit(...,
telemetry=TelemetryConfig(dir))``, or manually:

    import flexflow_tpu_torch.obs as obs
    cfg = obs.TelemetryConfig(dir="/tmp/tel", flight_recorder=False,
                              anomaly_detection=False)
    with obs.session(cfg) as tel:
        model.fit(...)

Only ONE session is active per process (module global in obs/__init__);
runtime subsystems (checkpointing, retry) emit through the cheap `obs.*`
helpers, which no-op when nothing is active.

Not ported yet, and refused by name when asked for: the flight recorder,
the anomaly sentinel and the fleet spool (`flight_recorder`,
`anomaly_detection` and `fleet_spool_dir`: the JAX package's
obs/{flight_recorder,anomaly,fleet}.py). `flight_recorder` and
`anomaly_detection` default to True, as in the JAX package, so a session
here passes both as False.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

from .metrics import MetricsRegistry
from .tracer import Tracer, to_chrome_trace



@dataclasses.dataclass
class TelemetryConfig:
    """Knobs for one telemetry session (the JAX package's fields and
    defaults; see flexflow_tpu/obs/telemetry.py for each).

    dir: output directory (created if missing).
    step_events: emit one span per training step dispatch.
    sync_per_step: block on each step's loss before closing its span.
    grad_norm: add the global gradient norm to the step's outputs
        (PCGExecutor.set_step_metrics) and gauge it per epoch.
    max_events / flush_every: event-log bounds (tracer.py).
    search_replay_limit: how many recorded search-trajectory entries are
        replayed into the event log at attach time.
    calibration_path: persistent cost-model calibration store
        (obs/calibration.py) — explain_strategy().apply() writes
        measured per-op costs through to it, and compile() under this
        session loads it back.
    step_profile: capture an in-situ measured timeline of the real
        training step after the training loop (obs/step_profile.py):
        measured events + memory counter tracks into this session's log,
        the memory-reconciliation gauges and the simulated-vs-measured
        overlay (``step_timeline.json``).
    step_profile_repeats: timed repeats per measurement in that capture.
    flight_recorder / anomaly_detection / fleet_spool_dir need modules
    not ported yet: setting them raises NotImplementedError when the
    session starts.
    """

    dir: str
    step_events: bool = True
    sync_per_step: bool = False
    grad_norm: bool = False
    max_events: int = 200_000
    flush_every: int = 256
    search_replay_limit: int = 20_000
    request_sample_rate: float = 1.0
    calibration_path: Optional[str] = None
    step_profile: bool = False
    step_profile_repeats: int = 2
    flight_recorder: bool = True
    flight_recorder_events: int = 2048
    anomaly_detection: bool = True
    fleet_spool_dir: Optional[str] = None
    fleet_spool_interval_s: float = 2.0
    fleet_process: Optional[str] = None
    events_file: str = "events.jsonl"
    prom_file: str = "metrics.prom"
    metrics_jsonl_file: str = "metrics.jsonl"
    trace_file: str = "trace.json"


# config field -> (the unported module it needs, its ROADMAP item)
_UNPORTED = {
    "flight_recorder": ("obs/flight_recorder.py", 6),
    "anomaly_detection": ("obs/anomaly.py", 6),
    "fleet_spool_dir": ("obs/fleet.py", 6),
}

_TRAJECTORY_CAT = {
    "phase": "compile",
    "mcmc_iter": "search",
    "mcmc_native": "search",
    "xfer_candidate": "search",
    "dp_split": "search",
    "search_begin": "search",
    "search_end": "search",
    "pipeline_search": "search",
}


def _refuse_unported(config: TelemetryConfig) -> None:
    for field, (module, item) in _UNPORTED.items():
        if getattr(config, field):
            off = None if field.endswith(("_dir", "_path")) else False
            raise NotImplementedError(
                f"TelemetryConfig({field}=...): needs the JAX package's "
                f"{module}, not ported to flexflow_tpu_torch yet (ROADMAP "
                f"queue 1 item {item}); pass {field}={off}")


class Telemetry:
    """One live session: a streaming tracer + a metrics registry."""

    def __init__(self, config: TelemetryConfig):
        _refuse_unported(config)
        self.config = config
        os.makedirs(config.dir, exist_ok=True)
        events_path = os.path.join(config.dir, config.events_file)
        # a fresh session truncates stale artifacts (the tracer appends,
        # and metrics.jsonl accumulates snapshots within ONE session)
        from .step_profile import OOM_FORENSICS_FILE, OVERLAY_FILE

        for name in (config.events_file, config.metrics_jsonl_file,
                     config.prom_file, config.trace_file,
                     OVERLAY_FILE, OOM_FORENSICS_FILE):
            p = os.path.join(config.dir, name)
            if os.path.exists(p):
                os.remove(p)
        self.tracer = Tracer(events_path, flush_every=config.flush_every,
                             max_events=config.max_events)
        self.metrics = MetricsRegistry()
        # overflow past max_events is visible LIVE on the metrics page,
        # not only at close()
        dropped = self.metrics.counter(
            "ff_trace_events_dropped_total",
            "trace events dropped past the tracer's max_events cap")
        self.tracer.on_drop = dropped.inc
        self.calibration = None
        if config.calibration_path:
            from .calibration import CalibrationStore

            self.calibration = CalibrationStore(config.calibration_path)
        self._finished = False
        self._attached_models: list = []
        self.tracer.instant("session_start", cat="obs",
                            unixtime=time.time())

    # -- model wiring ----------------------------------------------------
    def attach_model(self, model) -> None:
        """Replay the model's compile/search trajectory into the event
        log, publish PCG-derived gauges (static collective bytes + memory
        high-water), and arm optional step outputs (grad_norm)."""
        if model in self._attached_models:
            return
        self._attached_models.append(model)
        traj = getattr(model, "search_trajectory", None)
        if traj is not None:
            self._replay_trajectory(traj)
        if model.graph is not None:
            self._pcg_gauges(model)
        if self.config.grad_norm and model.executor is not None:
            model.executor.set_step_metrics(("grad_norm",))

    def _replay_trajectory(self, traj) -> None:
        base = self.tracer.t0
        for rec in traj.events[: self.config.search_replay_limit]:
            kind = rec["kind"]
            cat = _TRAJECTORY_CAT.get(kind, "search")
            args = {k: v for k, v in rec.items()
                    if k not in ("kind", "t", "t0", "dur", "name")}
            if kind == "phase":
                self.tracer.emit({
                    "ts": rec["t0"] - base, "ph": "X",
                    "name": rec.get("name", "phase"), "cat": cat,
                    "dur": rec["dur"], "tid": 0, "args": args,
                })
            else:
                self.tracer.emit({
                    "ts": rec["t"] - base, "ph": "i", "name": kind,
                    "cat": cat, "tid": 0, "args": args,
                })
        dropped = sum(traj.dropped.values())
        if dropped:
            self.tracer.instant("trajectory_truncated", cat="search",
                                dropped=dropped)
        summ = traj.summary()
        if summ.get("final_cost") is not None:
            self.metrics.gauge(
                "ff_search_best_cost_seconds",
                "simulated step time of the chosen strategy",
            ).set(summ["final_cost"])
        self.metrics.counter(
            "ff_search_mcmc_iterations_total",
            "MCMC proposals evaluated during strategy search",
        ).inc(summ["mcmc"]["iterations"])
        self.metrics.counter(
            "ff_search_candidates_total",
            "substitution candidates evaluated by the best-first search",
        ).inc(summ["substitution"]["candidates"])

    def _pcg_gauges(self, model) -> None:
        """Static PCG-derived gauges from the analysis passes."""
        from ..analysis.collectives import estimate_collective_bytes
        from ..analysis.memory import estimate_per_device_bytes

        views = getattr(model, "searched_views", None) or {}
        per_kind: dict = {}
        for rec in estimate_collective_bytes(model.graph, views):
            per_kind[rec["kind"]] = per_kind.get(rec["kind"], 0) \
                + rec["bytes"]
        for kind, nbytes in sorted(per_kind.items()):
            self.metrics.gauge(
                "ff_pcg_collective_bytes",
                "estimated per-step collective payload bytes by kind "
                "(analysis/collectives)",
                kind=kind,
            ).set(nbytes)
        # the port runs one device
        per_dev = estimate_per_device_bytes(
            model.graph, views, 1,
            train=model._is_training_compile(),
            optimizer=model.optimizer,
            grad_bytes_ratio=model._grad_bytes_ratio(),
        )
        if per_dev:
            self.metrics.gauge(
                "ff_static_hbm_peak_bytes",
                "static per-device HBM high-water estimate "
                "(analysis/memory)",
            ).set(max(per_dev.values()))

    # -- training-loop feed ---------------------------------------------
    def record_step(self, *, step: int, dur_s: float, batch_size: int,
                    n_chips: int, loss: Optional[float] = None,
                    t0: Optional[float] = None) -> None:
        """One training step completed (or dispatched, when
        sync_per_step is off)."""
        if self.config.step_events:
            args = {"step": step, "batch_size": batch_size}
            if loss is not None:
                args["loss"] = loss
            self.tracer.emit({
                "ts": (t0 - self.tracer.t0) if t0 is not None
                else time.perf_counter() - self.tracer.t0 - dur_s,
                "ph": "X", "name": "step", "cat": "train",
                "dur": dur_s, "tid": 0, "args": args,
            })
        self.metrics.counter("ff_steps_total", "training steps run").inc()
        self.metrics.counter("ff_samples_total",
                             "training samples consumed").inc(batch_size)
        self.metrics.histogram(
            "ff_step_wall_seconds",
            "per-step wall time (dispatch time unless sync_per_step)",
        ).observe(dur_s)
        if dur_s > 0:
            self.metrics.gauge(
                "ff_samples_per_second_per_chip",
                "instantaneous training throughput per chip",
            ).set(batch_size / dur_s / max(1, n_chips))
        if loss is not None:
            self.metrics.gauge("ff_loss", "last observed loss").set(loss)

    def record_chunk(self, *, first_step: int, steps: int, dur_s: float,
                     batch_size: int, n_chips: int,
                     t0: Optional[float] = None) -> None:
        """A multi-step dispatch completed (the train scan,
        fit(iterations_per_dispatch>1)): one span covering `steps`
        steps, metrics counted per step."""
        if self.config.step_events:
            self.tracer.emit({
                "ts": (t0 - self.tracer.t0) if t0 is not None
                else time.perf_counter() - self.tracer.t0 - dur_s,
                "ph": "X", "name": "step_chunk", "cat": "train",
                "dur": dur_s, "tid": 0,
                "args": {"first_step": first_step, "steps": steps,
                         "batch_size": batch_size},
            })
        self.metrics.counter("ff_steps_total", "training steps run") \
            .inc(steps)
        self.metrics.counter("ff_samples_total",
                             "training samples consumed") \
            .inc(batch_size * steps)
        self.metrics.histogram(
            "ff_step_wall_seconds",
            "per-step wall time (dispatch time unless sync_per_step)",
        ).observe(dur_s / max(1, steps))
        if dur_s > 0:
            self.metrics.gauge(
                "ff_samples_per_second_per_chip",
                "instantaneous training throughput per chip",
            ).set(batch_size * steps / dur_s / max(1, n_chips))

    def record_epoch(self, *, epoch: int, loss: float,
                     grad_norm_sum: Optional[float] = None,
                     steps: int = 0, skipped: float = 0.0) -> None:
        """Epoch-end fold: loss gauge, mean grad norm when the step emits
        it, and the guard's skipped-step count."""
        self.tracer.instant("epoch_end", cat="train", epoch=epoch,
                            loss=loss, steps=steps)
        self.metrics.gauge("ff_loss", "last observed loss").set(loss)
        if grad_norm_sum is not None and steps > 0:
            self.metrics.gauge(
                "ff_global_grad_norm",
                "mean global gradient norm over the last epoch",
            ).set(float(grad_norm_sum) / steps)
        if skipped:
            self.metrics.counter(
                "ff_nonfinite_skips_total",
                "steps skipped by the NaN/Inf step guard",
            ).inc(float(skipped))

    # -- output ----------------------------------------------------------
    def write_metrics(self) -> None:
        cfg = self.config
        with open(os.path.join(cfg.dir, cfg.prom_file), "w") as f:
            f.write(self.metrics.to_prometheus())
        with open(os.path.join(cfg.dir, cfg.metrics_jsonl_file), "a") as f:
            f.write(self.metrics.to_jsonl())

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        self.tracer.instant("session_end", cat="obs", unixtime=time.time())
        self.tracer.close()
        self.write_metrics()
        if self.calibration is not None and self.calibration.dirty:
            self.calibration.save()
        with open(os.path.join(self.config.dir,
                               self.config.trace_file), "w") as f:
            json.dump(to_chrome_trace(self.tracer.events,
                                      lane_names=self.tracer.lane_names), f)
