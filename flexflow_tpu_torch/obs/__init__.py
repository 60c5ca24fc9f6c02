"""Telemetry: structured event tracing, metrics export, and what
compile() records (the search trajectory).

The PyTorch counterpart of flexflow_tpu/obs/__init__.py, its facade:

  * `obs.tracer` — low-overhead span tracer -> structured JSONL event
    log, exportable to Chrome-trace/Perfetto (spans around checkpoints,
    per-step execution, retries, guard firings);
  * `obs.metrics` — counter/gauge/histogram registry -> Prometheus text
    file + JSONL (step wall time, samples/s/chip, loss scale, skip,
    retry and checkpoint counts);
  * `obs.telemetry` — one session tying both to an output directory.

Wire-up: ``with obs.session(obs.TelemetryConfig(dir=..., flight_recorder
=False, anomaly_detection=False)): model.fit(...)``. With no session
active every helper here is a cheap no-op — `tracer()` returns the
shared NULL_TRACER and the counter/gauge helpers return after one global
read. Not ported yet: the flight recorder (`forensics_dump` and
`record_failure` return None, as the JAX package's do when none is
installed), explain_strategy and the step profile.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Optional

from .metrics import (  # noqa: F401
    MetricsRegistry,
    merge_histogram_states,
    parse_prometheus,
    parse_prometheus_labeled,
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
    """The JAX package dumps a flight-recorder forensics bundle here and
    returns its path, or None when no recorder is installed. The flight
    recorder is not ported yet (ROADMAP queue 1 item 8), so none can be
    installed: always None."""
    return None


def record_failure(exc: BaseException, **extra) -> Optional[str]:
    """The JAX package dumps a forensics bundle here when `exc` is a
    typed runtime failure and a flight recorder is installed. None can be
    installed until the flight recorder is ported (ROADMAP queue 1 item
    8): always None."""
    return None


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
