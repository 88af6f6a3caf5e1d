"""Unified metrics registry: counters, gauges, histograms.

A copy of `tpu_tree_search/obs/metrics.py` (stdlib only): the port's
checkpoint layer records the same `tts_*` series under the same names.

One registry replaces the repo's scattered counter dicts (the service's
hand-rolled ``self.counters``, the executor cache's bare ints, the
retry tier's warnings-only accounting). Metric types follow the
Prometheus model — monotonic ``Counter``, settable ``Gauge`` (optionally
callback-backed so live values like queue depth are read at scrape
time), bucketed ``Histogram`` — all label-aware, all thread-safe, with
two expositions:

- :meth:`Registry.to_json` — nested JSON for ``status_snapshot()`` and
  the ``/status`` endpoint;
- :meth:`Registry.to_prometheus` — the Prometheus text format for
  ``/metrics`` (``# HELP`` / ``# TYPE`` / ``name{label="v"} value``,
  histograms as cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``).

Scoping: engine-level instrumentation (checkpoint I/O, retries, faults,
segments) writes to the process-global default registry
(:func:`default`; swap with :func:`install` for test isolation). The
search server builds its OWN registry for request/queue/cache metrics —
two servers in one process (the test suite does this constantly) must
not bleed counters into each other — and the HTTP front-end exposes
both, server-scoped first.

Metric names use the ``tts_`` prefix and Prometheus conventions
(``_total`` for counters, base units in the name). The full name table
lives in README.md's Observability section.
"""

from __future__ import annotations

import math
import threading
import time

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "default",
           "install", "DEFAULT_BUCKETS"]

# latency-shaped default buckets (seconds): checkpoint saves and segment
# times span ~1 ms (tests, tiny instances) to minutes (production pools)
DEFAULT_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0, 300.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class _Metric:
    """Shared label-series bookkeeping for all three metric types."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: dict[tuple, object] = {}  # guarded-by: self._lock
        # cardinality valve (set by the owning Registry): a NEW label
        # set beyond the cap is dropped (and reported via _on_drop)
        # instead of growing the metric without bound — a leaked
        # per-request label degrades one metric, not the process
        self._series_cap: int | None = None
        self._on_drop = None

    def _admit(self, key: tuple) -> bool:
        """Whether a write to `key` may proceed (caller holds the
        lock). Existing series always update; only NEW series count
        against the cap."""
        if (key in self._series or self._series_cap is None
                or len(self._series) < self._series_cap):
            return True
        if self._on_drop is not None:
            self._on_drop(self.name)
        return False

    def _labelnames(self) -> list[tuple]:
        with self._lock:
            return sorted(self._series)

    def remove_matching(self, **labels) -> int:
        """Drop every series whose labels include these pairs; returns
        how many were dropped. The cardinality valve for per-request
        label series (tts_phase_seconds{request=...}): the publisher
        removes a request's series at its terminal transition so a
        long-serving process cannot accumulate series without bound."""
        want = {(str(k), str(v)) for k, v in labels.items()}
        with self._lock:
            keys = [k for k in self._series if want <= set(k)]
            for k in keys:
                del self._series[k]
            return len(keys)


class Counter(_Metric):
    """Monotonic counter; `inc()` only goes up."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({n})")
        key = _label_key(labels)
        with self._lock:
            if self._admit(key):
                self._series[key] = self._series.get(key, 0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0)

    def value_matching(self, **labels) -> float:
        """Sum every series whose labels include these pairs — the
        read-side aggregate for a family that grew an extra label
        (tts_requests_total{state,tenant}: `value_matching(state="done")`
        still answers "how many DONE" across all tenants)."""
        want = {(str(k), str(v)) for k, v in labels.items()}
        with self._lock:
            return sum(v for k, v in self._series.items()
                       if want <= set(k))

    def samples(self) -> list[tuple[str, tuple, float]]:
        # no synthetic zero sample when only labeled series exist (or
        # none yet): an unlabeled `name 0` that vanishes once the first
        # labeled increment lands reads as a stale/reset series to a
        # scraper — Prometheus convention is series appear on first use
        with self._lock:
            items = sorted(self._series.items())
        return [(self.name, k, v) for k, v in items]

    def to_json(self):
        with self._lock:
            if set(self._series) <= {()}:
                return self._series.get((), 0)
            return {_fmt_labels(k) or "": v
                    for k, v in sorted(self._series.items())}


class Gauge(_Metric):
    """Settable instantaneous value; `set_fn` registers a zero-label
    callback evaluated at scrape time (live queue depth, occupancy)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._fn = None

    def set(self, v: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            if self._admit(key):
                self._series[key] = float(v)

    def inc(self, n: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            if self._admit(key):
                self._series[key] = self._series.get(key, 0) + n

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)

    def set_fn(self, fn) -> None:
        self._fn = fn

    def value(self, **labels) -> float:
        if self._fn is not None and not labels:
            return float(self._fn())
        with self._lock:
            return self._series.get(_label_key(labels), 0.0)

    def samples(self) -> list[tuple[str, tuple, float]]:
        if self._fn is not None:
            try:
                return [(self.name, (), float(self._fn()))]
            except Exception:  # noqa: BLE001 — scrape must not die on
                return []      # a callback racing server shutdown
        with self._lock:
            items = sorted(self._series.items())
        return [(self.name, k, v) for k, v in items]

    def to_json(self):
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001
                return None
        with self._lock:
            if set(self._series) <= {()}:
                return self._series.get((), 0.0)
            return {_fmt_labels(k) or "": v
                    for k, v in sorted(self._series.items())}


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: bucket `le=x`
    counts every observation <= x; `+Inf` == `_count`)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def observe(self, v: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if not self._admit(key):
                    return
                s = self._series[key] = _HistSeries(len(self.buckets))
            for i, b in enumerate(self.buckets):
                if v <= b:
                    s.counts[i] += 1
            s.sum += v
            s.count += 1

    def snapshot(self, **labels) -> dict:
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None:
                return {"count": 0, "sum": 0.0}
            return {"count": s.count, "sum": s.sum,
                    "buckets": dict(zip(map(str, self.buckets),
                                        s.counts))}

    def snapshot_matching(self, **labels) -> dict:
        """Merged snapshot over every series whose labels include these
        pairs — the histogram counterpart of ``Counter.value_matching``
        for a family that grew an extra label
        (tts_queue_wait_seconds{tenant}: ``snapshot_matching()`` still
        answers the all-tenants p99 the health rule judges)."""
        want = {(str(k), str(v)) for k, v in labels.items()}
        counts = [0] * len(self.buckets)
        total, count = 0.0, 0
        with self._lock:
            for k, s in self._series.items():
                if not want <= set(k):
                    continue
                for i, n in enumerate(s.counts):
                    counts[i] += n
                total += s.sum
                count += s.count
        if count == 0:
            return {"count": 0, "sum": 0.0}
        return {"count": count, "sum": total,
                "buckets": dict(zip(map(str, self.buckets), counts))}

    def to_json(self):
        with self._lock:
            keys = sorted(self._series)
        out = {_fmt_labels(k) or "": self.snapshot(**dict(k))
               for k in keys}
        if set(out) <= {""}:
            return out.get("", {"count": 0, "sum": 0.0})
        return out


class Registry:
    """A named collection of metrics with get-or-create accessors (the
    instrumentation sites' idiom: `REG.counter("tts_x_total").inc()`
    is safe to call from anywhere, any number of times)."""

    # the per-metric cap's own accounting metric: exempt from the cap
    # (its cardinality is bounded by the number of metric NAMES) and
    # never dropped, or the valve could silence its own report
    DROPPED = "tts_metrics_dropped_total"

    def __init__(self, namespace: str = "",
                 max_series_per_metric: int | None = None):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}  # guarded-by: self._lock
        self.created_unix = time.time()
        if max_series_per_metric is None:
            try:
                from ..utils.config import env_int
                # env_int falls back to the registry default on a
                # typo'd value — a bad knob must not take down every
                # Registry() construction in the process
                max_series_per_metric = env_int("TTS_METRIC_MAX_SERIES")
            except ImportError:     # keep the registry usable solo
                max_series_per_metric = 2048
        self.max_series_per_metric = (max_series_per_metric
                                      if max_series_per_metric
                                      and max_series_per_metric > 0
                                      else None)

    def _dropped(self, metric_name: str) -> None:
        self.counter(self.DROPPED,
                     "label sets dropped by the per-metric cardinality "
                     "cap").inc(metric=metric_name)

    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
                if name != self.DROPPED:
                    m._series_cap = self.max_series_per_metric
                    m._on_drop = self._dropped
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def remove_matching(self, name: str, **labels) -> int:
        """Drop `name`'s series whose labels include these pairs;
        returns how many were dropped (0 when the metric was never
        created — unlike `reg.gauge(name).remove_matching(...)`, this
        does not materialize an empty metric just to clean it)."""
        with self._lock:
            m = self._metrics.get(name)
        return m.remove_matching(**labels) if m is not None else 0

    # -------------------------------------------------------- exposition

    def to_json(self) -> dict:
        """Nested JSON view: {metric_name: value | {labels: value}}."""
        return {m.name: m.to_json() for m in self.metrics()}

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                with m._lock:
                    keys = sorted(m._series)
                for k in (keys or [()]):
                    snap = m.snapshot(**dict(k))
                    acc_labels = dict(k)
                    for b in m.buckets:
                        bl = _fmt_labels(_label_key(
                            {**acc_labels, "le": _fmt_value(b)}))
                        n = snap.get("buckets", {}).get(str(b), 0)
                        lines.append(f"{m.name}_bucket{bl} {n}")
                    bl = _fmt_labels(_label_key(
                        {**acc_labels, "le": "+Inf"}))
                    lines.append(f"{m.name}_bucket{bl} {snap['count']}")
                    sl = _fmt_labels(k)
                    lines.append(
                        f"{m.name}_sum{sl} {_fmt_value(snap['sum'])}")
                    lines.append(f"{m.name}_count{sl} {snap['count']}")
            else:
                for name, k, v in m.samples():
                    lines.append(f"{name}{_fmt_labels(k)} {_fmt_value(v)}")
        return "\n".join(lines) + "\n"


# -------------------------------------------------------- default registry

_default: Registry | None = None
_default_lock = threading.Lock()


def default() -> Registry:
    """The process-global registry engine-level instrumentation writes
    to (checkpoint/retry/fault/segment metrics)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Registry("tts")
        return _default


def install(reg: Registry | None) -> Registry | None:
    """Swap the process-global registry (tests; None re-arms the lazy
    build). Returns the previous one."""
    global _default
    with _default_lock:
        prev = _default
        _default = reg
        return prev
