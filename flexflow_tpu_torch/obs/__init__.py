"""Telemetry: structured event tracing, metrics export, and what
compile() records (the search trajectory).

The PyTorch counterpart of flexflow_tpu/obs/__init__.py, its facade:

  * `obs.tracer` — low-overhead span tracer -> structured JSONL event
    log, exportable to Chrome-trace/Perfetto (spans around checkpoints,
    per-step execution, retries, guard firings);
  * `obs.metrics` — counter/gauge/histogram registry -> Prometheus text
    file + JSONL (step wall time, samples/s/chip, loss scale, skip,
    retry and checkpoint counts);
  * `obs.telemetry` — one session tying both to an output directory;
  * `obs.calibration` — the persistent cost-model calibration store;
  * `obs.explain_strategy` — simulated vs measured cost per op;
  * `obs.capture_step_profile` — the step observatory (a device trace
    of the real step, each kernel attributed to its PCG op);
  * the fleet observatory: `obs.anomaly` (the anomaly sentinel),
    `obs.fleet` (cross-process metric spools and their aggregation) and
    `obs.flight_recorder` (the crash ring and its forensics bundles).

Wire-up: ``with obs.session(obs.TelemetryConfig(dir=...)):
model.fit(...)``; ``python -m flexflow_tpu_torch.obs`` converts,
summarizes and inspects the artifacts. With no session active every
helper here is a cheap no-op — `tracer()` returns the shared NULL_TRACER
and the counter/gauge helpers return after one global read.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Optional

from .anomaly import Anomaly, AnomalySentinel  # noqa: F401
from .calibration import CalibrationStore, resolve_calibration  # noqa: F401
from .fleet import FleetAggregator, MetricSpool  # noqa: F401
from .metrics import (  # noqa: F401
    MetricsRegistry,
    merge_histogram_states,
    parse_prometheus,
    parse_prometheus_labeled,
)
from .request_trace import (  # noqa: F401
    NULL_REQUEST_TRACE,
    RequestTrace,
    SLOMonitor,
    mint_request_trace,
    record_request_stages,
)
from .telemetry import Telemetry, TelemetryConfig  # noqa: F401
from .tracer import (  # noqa: F401
    NULL_TRACER,
    Tracer,
    _NULL_SPAN,
    read_events_jsonl,
    to_chrome_trace,
    validate_event,
)
from .trajectory import SearchTrajectory  # noqa: F401

_ACTIVE: Optional[Telemetry] = None


# ----------------------------------------------------------------------
# session lifecycle
# ----------------------------------------------------------------------
def start(config: TelemetryConfig) -> Telemetry:
    """Start (and globally register) a telemetry session. One session is
    active per process; starting over a live one finishes it first."""
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.finish()
        _ACTIVE = None
    _ACTIVE = Telemetry(config)
    return _ACTIVE


def finish() -> None:
    """Finish the active session: flush events.jsonl, write metrics.prom
    / metrics.jsonl and the Perfetto trace.json."""
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.finish()
        _ACTIVE = None


def active() -> Optional[Telemetry]:
    return _ACTIVE


@contextlib.contextmanager
def session(config: TelemetryConfig):
    tel = start(config)
    try:
        yield tel
    finally:
        if _ACTIVE is tel:
            finish()
        else:  # someone else already rotated the session
            tel.finish()


# ----------------------------------------------------------------------
# cheap emission helpers (no-ops when no session is active)
# ----------------------------------------------------------------------
def tracer():
    """The active session's tracer, or the shared no-op NULL_TRACER."""
    t = _ACTIVE
    return t.tracer if t is not None else NULL_TRACER


def span(name: str, cat: str = "runtime", **args):
    """Context manager timing a span; a shared no-op when inactive."""
    t = _ACTIVE
    if t is None:
        return _NULL_SPAN
    return t.tracer.span(name, cat, **args)


def event(name: str, cat: str = "runtime", **args) -> None:
    """Instant event; dropped when inactive."""
    t = _ACTIVE
    if t is not None:
        t.tracer.instant(name, cat, **args)


def count(name: str, n: float = 1.0, help: str = "", **labels) -> None:
    t = _ACTIVE
    if t is not None:
        t.metrics.counter(name, help, **labels).inc(n)


def gauge_set(name: str, value: float, help: str = "", **labels) -> None:
    t = _ACTIVE
    if t is not None:
        t.metrics.gauge(name, help, **labels).set(value)


def observe(name: str, value: float, help: str = "", **labels) -> None:
    t = _ACTIVE
    if t is not None:
        t.metrics.histogram(name, help, **labels).observe(value)


def forensics_dump(reason: str, error: Optional[BaseException] = None,
                   **extra) -> Optional[str]:
    """Dump a flight-recorder forensics bundle (obs/flight_recorder.py);
    None when no recorder is installed."""
    from . import flight_recorder as _fr

    return _fr.dump(reason=reason, error=error, **extra)


def record_failure(exc: BaseException, **extra) -> Optional[str]:
    """Dump a forensics bundle iff `exc` is a typed runtime failure (at
    most once per exception instance); None otherwise."""
    from . import flight_recorder as _fr

    return _fr.maybe_dump_failure(exc, **extra)


# ----------------------------------------------------------------------
# structured progress logger
# ----------------------------------------------------------------------
def progress(msg: str, *, verbose: bool = True, name: str = "log",
             cat: str = "train", **fields) -> None:
    """Human-readable progress line + structured telemetry event: at
    default verbosity the line prints, and when a telemetry session is
    active the same information lands in the event log as structured
    fields."""
    if verbose:
        print(msg, file=sys.stdout)
    t = _ACTIVE
    if t is not None:
        t.tracer.instant(name, cat, message=msg, **fields)


def explain_strategy(model, x=None, **kw):
    """See obs/explain.py (imported lazily, as the JAX package imports
    it)."""
    from .explain import explain_strategy as _impl

    return _impl(model, x, **kw)


def capture_step_profile(model, x, y, **kw):
    """See obs/step_profile.py (imported lazily)."""
    from .step_profile import capture_step_profile as _impl

    return _impl(model, x, y, **kw)
