"""OpenTelemetry export of the flight recorder.

Reproduces `tpu_tree_search/obs/otel.py` (`available`, `records_to_otlp`,
`export`, `IncrementalExporter`); only the service and scope names are the
port's. The tracelog record schema (obs/tracelog: flat span and event
JSON with a monotonic ``ts`` anchored to wall time by the sink's meta
line) maps one to one onto OTLP:

- records are grouped into one OTLP **trace per request**
  (``request_id`` attribute; records without one share a ``session``
  trace), under a synthetic root span covering the group's time range, so
  Jaeger or Tempo show each served request as one trace;
- ``kind: "span"`` records become child **spans** (start = t0 + ts, end
  = start + dur, every flat attribute kept);
- ``kind: "event"`` records become **span events** on the group's root
  (same name, same attributes, exact timestamp).

Two layers, so the program never needs opentelemetry installed:

- :func:`records_to_otlp`: the mapping alone, giving the OTLP/JSON
  (``resourceSpans``/``scopeSpans``) encoding with no import at all;
- :func:`export`: ships records through the OpenTelemetry **SDK**
  (``TracerProvider`` and the OTLP/HTTP exporter) when it can be imported,
  and does nothing, with one warning a process, when it cannot. The import
  is tried at each call (``_sdk``): ``opentelemetry`` can exist as a bare
  API package, so the check asks for the SDK and the exporter, the parts an
  export needs. This is JAX's design, not a stand-in for anything on the
  card.

Usage::

    from tpu_tree_search_torch.obs import otel, tracelog
    otel.export(tracelog.get().records(),
                endpoint="http://localhost:4318/v1/traces")

or ``serve --otel-endpoint http://...:4318/v1/traces`` (with
``--otel-interval-s N`` to flush every N seconds as well).
"""

from __future__ import annotations

import os
import struct
import time
import warnings
import zlib

__all__ = ["available", "records_to_otlp", "export",
           "IncrementalExporter"]

SERVICE_NAME = "tpu_tree_search_torch"
_SESSION_GROUP = "session"
# the instrumentation scope of every exported span: the port's recorder
SCOPE_NAME = "tpu_tree_search_torch.obs.tracelog"

_warned = False


def _sdk():
    """The guarded SDK import: (trace_api, TracerProvider, Resource,
    SimpleSpanProcessor, OTLPSpanExporter) or None when any piece is
    missing. `opentelemetry` alone proves nothing — the API package
    installs as a namespace shell without the SDK."""
    try:
        from opentelemetry import trace as trace_api
        from opentelemetry.exporter.otlp.proto.http.trace_exporter \
            import OTLPSpanExporter
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import SimpleSpanProcessor
    except ImportError:
        return None
    return (trace_api, TracerProvider, Resource, SimpleSpanProcessor,
            OTLPSpanExporter)


def available() -> bool:
    """True when the OpenTelemetry SDK + OTLP exporter are importable."""
    return _sdk() is not None


# ------------------------------------------------------------ pure mapping

def _attr_value(v):
    """One OTLP AnyValue (the JSON encoding's tagged union)."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}       # OTLP/JSON int64s are strings
    if isinstance(v, float):
        return {"doubleValue": v}
    if v is None:
        return {"stringValue": ""}
    if isinstance(v, (list, tuple)):
        return {"arrayValue": {"values": [_attr_value(x) for x in v]}}
    return {"stringValue": str(v)}


def _attrs(rec: dict, skip=("kind", "name", "ts", "dur", "seq")) -> list:
    return [{"key": k, "value": _attr_value(v)}
            for k, v in rec.items() if k not in skip]


def _span_id(*parts) -> str:
    """Deterministic 8-byte span id from the record identity (CRC64-ish
    via two CRC32s) — deterministic so re-exports of the same log are
    idempotent on the backend."""
    seed = "\x00".join(str(p) for p in parts)
    a = zlib.crc32(seed.encode())
    b = zlib.crc32(seed.encode()[::-1], 0xDEADBEEF)
    return struct.pack(">II", a, b).hex()


def _trace_id(group: str, t0_unix: float) -> str:
    return _span_id(group, t0_unix) + _span_id(t0_unix, group)


def _anchor(records: list[dict], t0_unix: float | None) -> float:
    """Wall-clock anchor for the records' monotonic ts (the sink meta
    line's value when the caller has it; defaults to now minus the
    largest ts — a best-effort anchor for ring snapshots)."""
    if t0_unix is not None:
        return t0_unix
    horizon = max((float(r.get("ts", 0.0)) + float(r.get("dur", 0.0))
                   for r in records), default=0.0)
    return time.time() - horizon


def _grouped(records: list[dict]) -> list[tuple[str, list[dict]]]:
    """One OTLP trace per request_id (records without one share the
    session group), sorted for deterministic export order — THE
    grouping rule, shared by the pure mapping and the SDK export so
    the pinned schema and the shipped spans cannot drift."""
    groups: dict[str, list[dict]] = {}
    for r in records:
        if r.get("kind") == "meta":
            continue
        groups.setdefault(str(r.get("request_id") or _SESSION_GROUP),
                          []).append(r)
    return sorted(groups.items())


def records_to_otlp(records: list[dict],
                    service_name: str = SERVICE_NAME,
                    t0_unix: float | None = None) -> dict:
    """Map tracelog records to the OTLP/JSON trace encoding (pure — no
    opentelemetry import). `t0_unix` anchors the records' monotonic
    clock to wall time (see _anchor)."""
    records = [r for r in records if r.get("kind") != "meta"]
    t0_unix = _anchor(records, t0_unix)

    def ns(ts: float) -> str:
        return str(int((t0_unix + ts) * 1e9))

    spans = []
    for group, recs in _grouped(records):
        trace_id = _trace_id(group, t0_unix)
        root_id = _span_id(group, "root", t0_unix)
        lo = min(float(r.get("ts", 0.0)) for r in recs)
        hi = max(float(r.get("ts", 0.0)) + float(r.get("dur", 0.0))
                 for r in recs)
        events = []
        children = []
        for r in recs:
            ts = float(r.get("ts", 0.0))
            if r.get("kind") == "span":
                children.append({
                    "traceId": trace_id,
                    "spanId": _span_id(group, r.get("name"), ts,
                                       r.get("seq")),
                    "parentSpanId": root_id,
                    "name": str(r.get("name", "?")),
                    "kind": 1,                    # SPAN_KIND_INTERNAL
                    "startTimeUnixNano": ns(ts),
                    "endTimeUnixNano": ns(ts + float(r.get("dur", 0.0))),
                    "attributes": _attrs(r),
                })
            else:
                events.append({
                    "name": str(r.get("name", "?")),
                    "timeUnixNano": ns(ts),
                    "attributes": _attrs(r),
                })
        spans.append({
            "traceId": trace_id, "spanId": root_id,
            "name": group, "kind": 1,
            "startTimeUnixNano": ns(lo), "endTimeUnixNano": ns(hi),
            "attributes": [{"key": "tts.group",
                            "value": _attr_value(group)}],
            "events": events,
        })
        spans.extend(children)

    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name", "value": _attr_value(service_name)},
            {"key": "process.pid", "value": _attr_value(os.getpid())},
        ]},
        "scopeSpans": [{
            "scope": {"name": SCOPE_NAME},
            "spans": spans,
        }],
    }]}


# ----------------------------------------------------------- SDK export

def export(records: list[dict], endpoint: str | None = None,
           service_name: str = SERVICE_NAME,
           t0_unix: float | None = None) -> int:
    """Export tracelog records as OTLP spans/events via the
    OpenTelemetry SDK. Returns the number of OTLP spans shipped; when
    the SDK is NOT installed this is a clean no-op returning 0 (one
    RuntimeWarning per process) — observability extras must never take
    the search down or force a dependency into the container.

    `endpoint` is the OTLP/HTTP traces URL (default: the SDK's own
    OTEL_EXPORTER_OTLP_* environment handling)."""
    global _warned
    sdk = _sdk()
    if sdk is None:
        if not _warned:
            _warned = True
            warnings.warn(
                "opentelemetry SDK not installed; OTel export skipped "
                "(pip install opentelemetry-sdk "
                "opentelemetry-exporter-otlp-proto-http to enable)",
                RuntimeWarning, stacklevel=2)
        return 0
    trace_api, TracerProvider, Resource, SimpleSpanProcessor, \
        OTLPSpanExporter = sdk
    records = [r for r in records if r.get("kind") != "meta"]
    if not records:
        return 0
    t0_unix = _anchor(records, t0_unix)

    def ns(ts: float) -> int:
        return int((t0_unix + ts) * 1e9)

    provider = TracerProvider(resource=Resource.create(
        {"service.name": service_name}))
    exporter = (OTLPSpanExporter(endpoint=endpoint) if endpoint
                else OTLPSpanExporter())
    provider.add_span_processor(SimpleSpanProcessor(exporter))
    tracer = provider.get_tracer(SCOPE_NAME)

    def flat(rec):
        # same value semantics as _attr_value, in the SDK's native
        # types: None -> "", primitive lists kept, the rest stringified
        out = {}
        for k, v in rec.items():
            if k in ("kind", "name", "ts", "dur", "seq"):
                continue
            if v is None:
                out[k] = ""
            elif isinstance(v, (str, bool, int, float)):
                out[k] = v
            elif isinstance(v, (list, tuple)) and all(
                    isinstance(x, (str, bool, int, float)) for x in v):
                out[k] = list(v)
            else:
                out[k] = str(v)
        return out

    n = 0
    for group, recs in _grouped(records):
        lo = min(float(r.get("ts", 0.0)) for r in recs)
        hi = max(float(r.get("ts", 0.0)) + float(r.get("dur", 0.0))
                 for r in recs)
        root = tracer.start_span(group, start_time=ns(lo),
                                 attributes={"tts.group": group})
        ctx = trace_api.set_span_in_context(root)
        n += 1
        for r in recs:
            ts = float(r.get("ts", 0.0))
            if r.get("kind") == "span":
                sp = tracer.start_span(str(r.get("name", "?")),
                                       context=ctx, start_time=ns(ts),
                                       attributes=flat(r))
                sp.end(end_time=ns(ts + float(r.get("dur", 0.0))))
                n += 1
            else:
                root.add_event(str(r.get("name", "?")),
                               attributes=flat(r), timestamp=ns(ts))
        root.end(end_time=ns(hi))
    provider.shutdown()
    return n


class IncrementalExporter:
    """Repeated export without duplication: tracks the tracelog ``seq``
    watermark (every record carries the process-wide monotonic counter)
    and each :meth:`flush` ships only records newer than the last one
    shipped. This is what ``serve --otel-interval-s`` drives — a
    kill -9'd server has exported everything up to its last interval
    instead of nothing — and a final shutdown flush through the SAME
    instance ships only the tail. Span/trace ids are deterministic
    (CRC of the record identity), so a request whose records land in
    two flushes still renders as one trace on the backend."""

    def __init__(self, endpoint: str | None = None,
                 service_name: str = SERVICE_NAME):
        self.endpoint = endpoint
        self.service_name = service_name
        self.last_seq = -1
        self.spans = 0       # cumulative spans shipped
        self.flushes = 0     # flushes that shipped anything

    def flush(self, records: list[dict]) -> int:
        """Export the records past the watermark; returns spans shipped
        (0 when nothing is new or the SDK is absent)."""
        fresh = [r for r in records
                 if int(r.get("seq", -1)) > self.last_seq]
        if not fresh:
            return 0
        n = export(fresh, endpoint=self.endpoint,
                   service_name=self.service_name)
        # watermark moves AFTER the export: an exporter exception leaves
        # it in place so the next flush retries the same tail
        self.last_seq = max(int(r.get("seq", -1)) for r in fresh)
        if n:
            self.spans += n
            self.flushes += 1
        return n
