"""Per-request flight recorder for the serving stack.

The PyTorch counterpart of flexflow_tpu/obs/request_trace.py. A
`RequestTrace` minted at ``ReplicaSet.submit`` (or at
``AdmissionQueue.offer``) rides on the `GenerationRequest` through every
stage and emits spans and instants under cat ``"requests"``, with one
named lane per replica (plus an ``admission`` lane for queue time), so a
sampled request's life renders across replica tracks in Perfetto. A
failover requeue keeps the same trace id and marks the hand-off with a
``requeue`` instant carrying the new generation.

Sampling is head-based and deterministic: `mint_request_trace` hashes the
request id (crc32) against ``TelemetryConfig.request_sample_rate``, so the
decision is made once at submit and every later stage checks
``req.trace.sampled``. With no session active, or for an unsampled
request, the request carries the shared `NULL_REQUEST_TRACE`, whose
methods are allocation-free no-ops.

Independent of sampling, `record_request_stages` decomposes every
completed request's latency into ``ff_request_stage_seconds{stage}``
observations (queue / prefill / decode / stall / total, and per-token
``tpot``) and feeds the `SLOMonitor`, which counts
``ff_slo_violations_total{slo}`` against the TTFT / p99 targets and gives
the ReplicaSet autoscaler and adaptive admission an SLO-violation signal.
"""
from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from typing import Optional

from .tracer import _NULL_SPAN

REQUEST_CAT = "requests"
ADMISSION_LANE = "admission"
STAGE_HELP = ("per-request latency decomposition by stage "
              "(tpot is seconds per generated token)")


class _NullRequestTrace:
    """Shared no-op trace for unsampled requests / no active session."""

    __slots__ = ()
    sampled = False
    trace_id = ""

    def event(self, name, replica=ADMISSION_LANE, **args):
        return None

    def span(self, name, replica=ADMISSION_LANE, **args):
        return _NULL_SPAN

    def queue_begin(self, **args):
        return None

    def queue_end(self, **args):
        return None

    def admitted(self, replica, **args):
        return None

    def shed(self, reason, stage, replica=ADMISSION_LANE, **args):
        return None

    def requeued(self, replica, generation, **args):
        return None

    def iteration(self, replica, *, t0, dur_s, **args):
        return None

    def completed(self, replica, **args):
        return None


NULL_REQUEST_TRACE = _NullRequestTrace()


class RequestTrace:
    """One sampled request's emitter: every method lands spans/instants
    on the shared tracer under cat "requests", tid = the named replica
    lane. Thread-compat note: the queue span opens on the submit thread
    and closes on a batcher thread — Span only touches its own fields
    until the final emit, which the tracer locks."""

    __slots__ = ("trace_id", "_tracer", "_queue_span")
    sampled = True

    def __init__(self, trace_id: str, tracer):
        self.trace_id = trace_id
        self._tracer = tracer
        self._queue_span = None

    def _lane(self, replica: str) -> int:
        return self._tracer.lane(REQUEST_CAT, replica)

    # -- generic ---------------------------------------------------------
    def event(self, name, replica=ADMISSION_LANE, **args):
        self._tracer.instant(name, cat=REQUEST_CAT,
                             tid=self._lane(replica),
                             request=self.trace_id, **args)

    def span(self, name, replica=ADMISSION_LANE, **args):
        return self._tracer.span(name, cat=REQUEST_CAT,
                                 tid=self._lane(replica),
                                 request=self.trace_id, **args)

    # -- lifecycle stages ------------------------------------------------
    def queue_begin(self, **args) -> None:
        """Open the queue-wait span (submit or failover requeue)."""
        if self._queue_span is None:
            self._queue_span = self.span("queue", **args)

    def queue_end(self, **args) -> None:
        sp = self._queue_span
        if sp is not None:
            self._queue_span = None
            if args:
                sp.set(**args)
            sp.done()

    def admitted(self, replica, **args) -> None:
        self.queue_end(admitted_by=replica)
        self.event("admit", replica=replica, **args)

    def shed(self, reason, stage, replica=ADMISSION_LANE, **args) -> None:
        self.queue_end(shed=reason)
        self.event("shed", replica=replica, reason=reason, stage=stage,
                   **args)

    def requeued(self, replica, generation, **args) -> None:
        """Failover hand-off: same trace id, new generation; the next
        queue wait gets its own span."""
        self.event("requeue", replica=replica, generation=generation,
                   **args)
        self.queue_begin(generation=generation, requeue=True)

    def iteration(self, replica, *, t0: float, dur_s: float, **args) -> None:
        """One decode iteration's share of this request, as a completed
        span at an explicit perf_counter start (the batched device step
        already ran when this is called)."""
        tr = self._tracer
        tr.emit({"ts": t0 - tr.t0, "ph": "X", "name": "decode",
                 "cat": REQUEST_CAT, "dur": dur_s,
                 "tid": self._lane(replica),
                 "args": {"request": self.trace_id, **args}})

    def completed(self, replica, **args) -> None:
        self.event("complete", replica=replica, **args)


def _sampled(request_id: str, rate: float) -> bool:
    """Deterministic head-based decision: same id -> same verdict, so a
    failover re-mint can never flip a request's sampling."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = zlib.crc32(request_id.encode("utf-8", "ignore")) & 0xFFFFFFFF
    return (h % 10_000) < rate * 10_000


def mint_request_trace(request_id: str):
    """A RequestTrace when a session is active AND the id wins the
    `request_sample_rate` draw; the shared NULL_REQUEST_TRACE otherwise
    (zero per-request allocation on the disabled/unsampled path)."""
    from . import active

    tel = active()
    if tel is None:
        return NULL_REQUEST_TRACE
    rate = float(getattr(tel.config, "request_sample_rate", 1.0))
    if not _sampled(request_id, rate):
        return NULL_REQUEST_TRACE
    return RequestTrace(request_id, tel.tracer)


# ----------------------------------------------------------------------
# stage decomposition + SLO monitoring (all requests, sampled or not)
# ----------------------------------------------------------------------
def record_request_stages(req, *, generated: Optional[int] = None,
                          slo: Optional["SLOMonitor"] = None,
                          replica: Optional[str] = None) -> dict:
    """Decompose a finished request's latency from its lifecycle
    timestamps into ff_request_stage_seconds{stage} observations and
    feed the SLO monitor. Returns the stage dict (also attached to the
    sampled trace's `complete` event by the caller).

    With `replica` (the serving batcher passes its name) observations
    and SLO violation counts carry a `replica` label, so the fleet page
    pins p99 violations to a replica instead of a blended histogram;
    without it the series stay unlabeled (back-compatible keys).

    queue   = submit -> last admission
    prefill = admission -> first token
    decode  = first token -> finish
    stall   = everything the final attempt doesn't account for (earlier
              attempts lost to failover, requeue waits)
    total   = submit -> finish
    tpot    = decode seconds per generated token past the first
    """
    from . import observe

    finished = req.finished_t if req.finished_t is not None \
        else time.monotonic()
    total = max(0.0, finished - req.submitted_t)
    stages = {"total": total}
    admitted = req.admitted_t
    first = req.first_token_t
    if admitted is not None:
        stages["queue"] = max(0.0, admitted - req.submitted_t)
        if first is not None and first >= admitted:
            stages["prefill"] = first - admitted
            stages["decode"] = max(0.0, finished - first)
            accounted = (stages["queue"] + stages["prefill"]
                         + stages["decode"])
            stages["stall"] = max(0.0, total - accounted)
            extra = (generated if generated is not None
                     else req.max_new_tokens) - 1
            if extra > 0:
                stages["tpot"] = stages["decode"] / extra
    labels = {"replica": replica} if replica is not None else {}
    for stage, v in stages.items():
        observe("ff_request_stage_seconds", v, help=STAGE_HELP,
                stage=stage, **labels)
    if slo is not None:
        ttft = (first - req.submitted_t) if first is not None else None
        slo.observe(ttft_s=ttft, latency_s=total, replica=replica)
    return stages


class SLOMonitor:
    """Rolling SLO compliance over recent completed requests.

    Targets are optional: with neither set the monitor is inert
    (`enabled` False, `should_scale_up` never fires). Each completion
    contributes a violated/ok verdict per configured SLO into a bounded
    window; violations also count in ff_slo_violations_total{slo}. The
    ReplicaSet autoscaler scales up on a sustained violation fraction,
    and adaptive admission reads `latency_quantile` (server-side
    completion latencies — a richer population than the client-side
    reservoir) instead of raw client latency."""

    def __init__(self, *, ttft_target_s: Optional[float] = None,
                 latency_p99_target_s: Optional[float] = None,
                 window: int = 512):
        self.ttft_target_s = ttft_target_s
        self.latency_p99_target_s = latency_p99_target_s
        self._lock = threading.Lock()
        self._verdicts = {"ttft": deque(maxlen=window),
                          "p99_latency": deque(maxlen=window)}
        from .metrics import Histogram

        self.latency = Histogram(threading.Lock())
        # ttft reservoir: the anomaly sentinel reads its p95 (a target-
        # relative verdict window can't see a spike still under target)
        self.ttft = Histogram(threading.Lock())
        self.violations = {"ttft": 0, "p99_latency": 0}

    @property
    def enabled(self) -> bool:
        return (self.ttft_target_s is not None
                or self.latency_p99_target_s is not None)

    def _count(self, slo: str, replica: Optional[str] = None) -> None:
        from . import count

        labels = {"replica": replica} if replica is not None else {}
        count("ff_slo_violations_total", 1.0,
              help="completed requests that violated a serving SLO "
                   "target", slo=slo, **labels)

    def observe(self, *, ttft_s: Optional[float] = None,
                latency_s: Optional[float] = None,
                replica: Optional[str] = None) -> None:
        if latency_s is not None:
            self.latency.observe(latency_s)
        if ttft_s is not None:
            self.ttft.observe(ttft_s)
        with self._lock:
            if self.ttft_target_s is not None and ttft_s is not None:
                bad = ttft_s > self.ttft_target_s
                self._verdicts["ttft"].append(bad)
                if bad:
                    self.violations["ttft"] += 1
                    self._count("ttft", replica)
            if (self.latency_p99_target_s is not None
                    and latency_s is not None):
                bad = latency_s > self.latency_p99_target_s
                self._verdicts["p99_latency"].append(bad)
                if bad:
                    self.violations["p99_latency"] += 1
                    self._count("p99_latency", replica)

    def latency_quantile(self, q: float) -> float:
        return self.latency.quantile(q)

    @property
    def sample_count(self) -> int:
        return self.latency.count

    def violation_rate(self, slo: Optional[str] = None) -> float:
        """Recent violation fraction for one SLO window, or (default)
        the worst fraction across configured SLOs — what the autoscale
        event reports as the cause's magnitude."""
        with self._lock:
            windows = ([self._verdicts[slo]] if slo is not None
                       else list(self._verdicts.values()))
            rates = [sum(w) / len(w) for w in windows if w]
            if not rates:
                return float("nan")
            return max(rates)

    def should_scale_up(self, threshold: float = 0.1,
                        min_samples: int = 8) -> bool:
        """True when a configured SLO's recent violation fraction is
        sustained above `threshold` — the autoscaler's signal. p99 SLO
        compliance means a 1% violation budget, so 10% violating is
        unambiguous overload, not noise."""
        with self._lock:
            for slo, target in (("ttft", self.ttft_target_s),
                                ("p99_latency",
                                 self.latency_p99_target_s)):
                if target is None:
                    continue
                window = self._verdicts[slo]
                if len(window) < min_samples:
                    continue
                if sum(window) / len(window) > threshold:
                    return True
        return False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ttft_target_s": self.ttft_target_s,
                "latency_p99_target_s": self.latency_p99_target_s,
                "violations": dict(self.violations),
                "window": {k: (sum(v), len(v))
                           for k, v in self._verdicts.items()},
            }
