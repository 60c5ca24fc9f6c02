"""Metrics registry: counters, gauges, histograms.

The PyTorch port's copy of flexflow_tpu/obs/metrics.py (pure Python),
so both packages write the same Prometheus text and JSONL.

The reference surfaces runtime health as scattered prints; here every
runtime subsystem feeds named series in one registry, exported as a
Prometheus text file (node-exporter textfile-collector compatible) and as
JSONL snapshots. Series support optional labels (`registry.counter(name,
kind="all-reduce")`) and are thread-safe: family/label-map creation is
guarded by the registry lock, and every series carries its OWN lock for
value updates (reservoir appends included) — updates come from the
training loop, every replica's serve thread, the batcher, watchdog and
health-monitor threads concurrently, so hot-path observes must not
serialize against each other on one global lock.

Naming follows Prometheus conventions: `ff_<noun>_<unit>` gauges /
histograms, `ff_<noun>_total` counters, base units (seconds, bytes).
"""
from __future__ import annotations

import json
import math
import threading
import time
from typing import Dict, List, Optional, Tuple

# default histogram buckets: 100us .. ~2min, log-spaced — wide enough for
# both per-step wall times and serving latencies
DEFAULT_BUCKETS = tuple(
    1e-4 * (2.5 ** i) for i in range(12)
) + (float("inf"),)

_RESERVOIR = 4096  # raw samples kept per histogram for exact quantiles


class Counter:
    __slots__ = ("value", "_lock")

    kind = "counter"

    def __init__(self, lock):
        self.value = 0.0
        self._lock = lock

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("value", "_lock")

    kind = "gauge"

    def __init__(self, lock):
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Histogram:
    """Cumulative-bucket histogram + a bounded reservoir of raw samples
    (newest `_RESERVOIR`) so `quantile()` reports exact percentiles of
    recent traffic instead of bucket-edge approximations."""

    __slots__ = ("buckets", "counts", "sum", "count", "_samples", "_lock")

    kind = "histogram"

    def __init__(self, lock, buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        if not self.buckets or self.buckets[-1] != float("inf"):
            self.buckets = self.buckets + (float("inf"),)
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0
        self._samples: List[float] = []
        self._lock = lock

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.sum += v
            self.count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    break
            self._samples.append(v)
            if len(self._samples) > _RESERVOIR:
                del self._samples[: len(self._samples) - _RESERVOIR]

    def quantile(self, q: float) -> float:
        with self._lock:
            if not self._samples:
                return float("nan")
            s = sorted(self._samples)
        i = min(len(s) - 1, max(0, int(math.ceil(q * len(s))) - 1))
        return s[i]

    # -- mergeable state (fleet aggregation) ----------------------------
    def state(self, max_samples: int = _RESERVOIR) -> dict:
        """JSON-serializable mergeable state: bucket edges/counts, sum,
        count, and (a bounded stride-subsample of) the reservoir, so a
        fleet aggregator can reconstruct cross-process percentiles."""
        with self._lock:
            samples = list(self._samples)
            counts = list(self.counts)
            total, n = self.sum, self.count
        if len(samples) > max_samples:
            stride = len(samples) / max_samples
            samples = [samples[int(i * stride)] for i in range(max_samples)]
        return {"buckets": list(self.buckets), "counts": counts,
                "sum": total, "count": n, "samples": samples}

    def merge_state(self, state: dict) -> None:
        """Fold another histogram's `state()` into this one. Bucket edges
        must match (or this histogram must still be empty, in which case
        it adopts the incoming edges); the reservoirs are concatenated
        and stride-subsampled back under the cap so merged quantiles
        reflect both populations."""
        edges = tuple(float(b) for b in state["buckets"])
        with self._lock:
            if self.count == 0 and not self._samples:
                self.buckets = edges
                self.counts = [0] * len(edges)
            elif edges != self.buckets:
                raise ValueError(
                    f"histogram bucket edges differ: {edges!r} vs "
                    f"{self.buckets!r}"
                )
            for i, c in enumerate(state["counts"]):
                self.counts[i] += int(c)
            self.sum += float(state["sum"])
            self.count += int(state["count"])
            self._samples.extend(float(v) for v in state["samples"])
            if len(self._samples) > _RESERVOIR:
                stride = len(self._samples) / _RESERVOIR
                self._samples = [self._samples[int(i * stride)]
                                 for i in range(_RESERVOIR)]


def _fmt_labels(labels: Optional[Tuple[Tuple[str, str], ...]],
                extra: Optional[Dict[str, str]] = None) -> str:
    items = list(labels or ())
    if extra:
        items += list(extra.items())
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v != v:
        return "NaN"
    return repr(float(v))


class MetricsRegistry:
    """Get-or-create registry of named (and optionally labeled) series."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (kind, help, {label-tuple: series})
        self._families: Dict[str, Tuple[str, str, Dict]] = {}

    def _series(self, cls, name: str, help_: str, labels: dict, **kw):
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (cls.kind, help_, {})
                self._families[name] = fam
            elif fam[0] != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam[0]}, "
                    f"requested {cls.kind}"
                )
            series = fam[2].get(key)
            if series is None:
                series = cls(threading.Lock(), **kw)
                fam[2][key] = series
            return series

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._series(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._series(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS, **labels) -> Histogram:
        return self._series(Histogram, name, help, labels, buckets=buckets)

    def find(self, name: str, **labels) -> Optional[object]:
        """The existing series, or None — WITHOUT creating one. Readers
        that merely inspect (the serving runtime's adaptive rate limiter
        polls the latency p95) must not pollute the export with empty
        series the way the get-or-create accessors would."""
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            return fam[2].get(key)

    # -- export ----------------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines: List[str] = []
        with self._lock:
            fams = {
                name: (kind, help_, dict(series))
                for name, (kind, help_, series) in sorted(
                    self._families.items()
                )
            }
        for name, (kind, help_, series) in fams.items():
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for key, s in series.items():
                if kind == "histogram":
                    cum = 0
                    for b, c in zip(s.buckets, s.counts):
                        cum += c
                        lines.append(
                            f"{name}_bucket"
                            + _fmt_labels(key, {"le": _fmt_value(b)})
                            + f" {cum}"
                        )
                    lines.append(f"{name}_sum{_fmt_labels(key)} "
                                 f"{_fmt_value(s.sum)}")
                    lines.append(f"{name}_count{_fmt_labels(key)} {s.count}")
                else:
                    lines.append(
                        f"{name}{_fmt_labels(key)} {_fmt_value(s.value)}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> List[dict]:
        """One JSON-serializable record per series (the metrics.jsonl
        lines): histograms carry sum/count plus p50/p95/p99 of the recent
        reservoir."""
        out: List[dict] = []
        now = time.time()
        with self._lock:
            fams = {
                name: (kind, dict(series))
                for name, (kind, _h, series) in sorted(self._families.items())
            }
        for name, (kind, series) in fams.items():
            for key, s in series.items():
                rec = {"time": now, "name": name, "kind": kind,
                       "labels": dict(key)}
                if kind == "histogram":
                    rec.update(sum=s.sum, count=s.count,
                               p50=s.quantile(0.50), p95=s.quantile(0.95),
                               p99=s.quantile(0.99))
                else:
                    rec["value"] = s.value
                out.append(rec)
        return out

    def to_jsonl(self) -> str:
        return "".join(json.dumps(r) + "\n" for r in self.snapshot())

    def export_state(self) -> List[dict]:
        """One mergeable record per series — unlike `snapshot()` (which
        reduces histograms to fixed percentiles), histogram records carry
        the full `Histogram.state()` so a `FleetAggregator` can merge
        reservoirs across processes without precision loss."""
        out: List[dict] = []
        with self._lock:
            fams = {
                name: (kind, dict(series))
                for name, (kind, _h, series) in sorted(self._families.items())
            }
        for name, (kind, series) in fams.items():
            for key, s in series.items():
                rec = {"name": name, "kind": kind, "labels": dict(key)}
                if kind == "histogram":
                    rec["state"] = s.state()
                else:
                    rec["value"] = s.value
                out.append(rec)
        return out


def parse_prometheus(text: str) -> Dict[str, float]:
    """Minimal parser for the text exposition format (tests + the CLI's
    `prom` round-trip check): returns {series-with-labels: value},
    raising ValueError on malformed sample lines."""
    out: Dict[str, float] = {}
    for i, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            series, value = line.rsplit(" ", 1)
            out[series] = (float("inf") if value == "+Inf"
                           else float(value))
        except ValueError as e:
            raise ValueError(f"line {i}: bad sample {line!r} ({e})") from e
    return out


def merge_histogram_states(states) -> dict:
    """Merge an iterable of `Histogram.state()` dicts into one. Raises
    ValueError on mismatched bucket edges (series exported with custom
    buckets cannot be silently blended into default-bucket series)."""
    acc = Histogram(threading.Lock())
    for st in states:
        acc.merge_state(st)
    return acc.state()


def parse_series_key(series: str) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    """Split a `name{k="v",...}` series key into (name, sorted label
    tuple) — the inverse of `_fmt_labels`, so `parse_prometheus` output
    round-trips into the structured form the aggregator merges on."""
    if "{" not in series:
        return series, ()
    name, _, rest = series.partition("{")
    body = rest.rstrip()
    if not body.endswith("}"):
        raise ValueError(f"bad series key {series!r}: unterminated labels")
    body = body[:-1]
    labels: List[Tuple[str, str]] = []
    # values are always double-quoted by _fmt_labels and never contain
    # quotes themselves in this codebase's label vocabulary
    for part in filter(None, body.split(",")):
        k, _, v = part.partition("=")
        if not _ or not v.startswith('"') or not v.endswith('"'):
            raise ValueError(f"bad label {part!r} in series {series!r}")
        labels.append((k.strip(), v[1:-1]))
    return name, tuple(sorted(labels))


def parse_prometheus_labeled(
    text: str,
) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """Structured variant of `parse_prometheus`: keys are (name, sorted
    label tuple) so callers can filter/merge by label without re-parsing
    the flat series strings."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for series, value in parse_prometheus(text).items():
        out[parse_series_key(series)] = value
    return out
