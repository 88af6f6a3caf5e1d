"""The port's `obs/otel.py` against the JAX package's.

`records_to_otlp` of one record list, with the same `t0_unix` and the
same `service_name` given to both packages, equals JAX's document once
the instrumentation scope (each package names its own recorder) is set
aside; the process id is the same process's. Without the SDK, `export`
ships nothing, returns 0 and warns once a process, in both packages. An
`IncrementalExporter` ships each record once across flushes, keeps its
watermark when the collector fails, and through a fake SDK (`_sdk`
replaced, as JAX's tests replace `export`) ships as many spans as
`records_to_otlp` maps. The `serve` flags parse as JAX's."""

import argparse
import copy
import warnings

import pytest

from tpu_tree_search import cli as jcli
from tpu_tree_search.obs import otel as jotel
from tpu_tree_search.obs import tracelog as jtracelog
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.obs import otel


def sample_records() -> list[dict]:
    log = jtracelog.TraceLog()
    with log.context(request_id="req-0000", submesh=1):
        with log.span("request.execute", dispatch=1, flags=[1, 2]):
            log.event("request.dispatch", queue_depth=0, ok=True,
                      none=None, ratio=0.5)
    with log.context(request_id="req-0001"):
        with log.span("checkpoint.save", bytes=4096):
            pass
    log.event("server.close")
    return [{"kind": "meta", "t0_unix": 1.0}] + log.records()


def without_scope(doc: dict) -> dict:
    doc = copy.deepcopy(doc)
    for rs in doc["resourceSpans"]:
        for ss in rs["scopeSpans"]:
            ss["scope"].pop("name")
    return doc


def test_records_to_otlp_equals_jax():
    recs = sample_records()
    got = otel.records_to_otlp(recs, service_name="svc", t0_unix=1000.0)
    want = jotel.records_to_otlp(recs, service_name="svc", t0_unix=1000.0)
    assert without_scope(got) == without_scope(want)
    scope = got["resourceSpans"][0]["scopeSpans"][0]
    assert scope["scope"]["name"] == "tpu_tree_search_torch.obs.tracelog"
    spans = scope["spans"]
    # three groups (two requests and the session), each a root span
    roots = [s for s in spans if "parentSpanId" not in s]
    assert sorted(s["name"] for s in roots) == ["req-0000", "req-0001",
                                                "session"]
    assert len(spans) == 3 + 2
    # the default service name is the port's
    doc = otel.records_to_otlp(recs, t0_unix=1000.0)
    attrs = doc["resourceSpans"][0]["resource"]["attributes"]
    assert attrs[0] == {"key": "service.name",
                        "value": {"stringValue": "tpu_tree_search_torch"}}


@pytest.mark.parametrize("mod", [otel, jotel], ids=["torch", "jax"])
def test_export_without_the_sdk_warns_once(monkeypatch, mod):
    monkeypatch.setattr(mod, "_sdk", lambda: None)
    monkeypatch.setattr(mod, "_warned", False)
    assert not mod.available()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert mod.export(sample_records(), endpoint="http://x") == 0
        assert mod.export(sample_records(), endpoint="http://x") == 0
    assert [w.category for w in caught] == [RuntimeWarning]
    assert "opentelemetry SDK not installed" in str(caught[0].message)


class FakeSpan:
    def __init__(self, sink, name, attributes):
        self.sink, self.name, self.events = sink, name, []
        sink.append(self)

    def add_event(self, name, attributes=None, timestamp=None):
        self.events.append(name)

    def end(self, end_time=None):
        self.ended = end_time


def fake_sdk(sink: list, endpoints: list):
    class Tracer:
        def start_span(self, name, context=None, start_time=None,
                       attributes=None):
            return FakeSpan(sink, name, attributes)

    class Provider:
        def __init__(self, resource=None):
            self.resource = resource

        def add_span_processor(self, proc):
            pass

        def get_tracer(self, name):
            assert name == otel.SCOPE_NAME
            return Tracer()

        def shutdown(self):
            pass

    class TraceApi:
        @staticmethod
        def set_span_in_context(span):
            return span

    class Resource:
        @staticmethod
        def create(attrs):
            return attrs

    def exporter(endpoint=None):
        endpoints.append(endpoint)

    return (TraceApi, Provider, Resource, lambda exp: None, exporter)


def test_incremental_exporter_ships_each_record_once(monkeypatch):
    sink, endpoints = [], []
    monkeypatch.setattr(otel, "_sdk", lambda: fake_sdk(sink, endpoints))
    exp = otel.IncrementalExporter(endpoint="http://collector:4318")
    recs = sample_records()
    n = exp.flush(recs)
    want = otel.records_to_otlp(recs, t0_unix=0.0)
    assert n == len(want["resourceSpans"][0]["scopeSpans"][0]["spans"])
    assert exp.flush(recs) == 0            # nothing ships twice
    assert len(sink) == n and endpoints == ["http://collector:4318"]
    tail = {"kind": "event", "name": "late", "ts": 9.0,
            "seq": exp.last_seq + 1}
    assert exp.flush(recs + [tail]) == 1    # only the new record's group
    assert [s.name for s in sink[n:]] == ["session"]
    assert sink[n].events == ["late"]
    assert exp.spans == n + 1 and exp.flushes == 2

    # a collector failure leaves the watermark: the tail retries whole
    def boom(records, **kw):
        raise OSError("collector down")

    monkeypatch.setattr(otel, "export", boom)
    tail2 = {"kind": "event", "name": "later", "ts": 10.0,
             "seq": exp.last_seq + 1}
    mark = exp.last_seq
    with pytest.raises(OSError):
        exp.flush(recs + [tail, tail2])
    assert exp.last_seq == mark
    monkeypatch.undo()
    monkeypatch.setattr(otel, "_sdk", lambda: fake_sdk(sink, endpoints))
    assert exp.flush(recs + [tail, tail2]) == 1
    assert exp.last_seq == tail2["seq"]


def serve_parsers():
    ap = argparse.ArgumentParser()
    jcli._serve_parser(ap.add_subparsers(dest="cmd"))
    return ap, cli.build_parser()


def test_serve_otel_flags_parse_as_jax():
    jap, tap = serve_parsers()
    argv = ["serve", "--spool", "sp", "--otel-endpoint", "http://c:4318",
            "--otel-interval-s", "2.5", "--http-port", "0", "--http-host",
            "0.0.0.0", "--profile-dir", "pd"]
    j, t = jap.parse_args(argv), tap.parse_args(argv)
    for key in ("otel_endpoint", "otel_interval_s", "http_port",
                "http_host", "profile_dir"):
        assert getattr(t, key) == getattr(j, key), key
    j, t = jap.parse_args(["serve", "--spool", "sp"]), \
        tap.parse_args(["serve", "--spool", "sp"])
    assert (t.otel_interval_s, t.http_host, t.http_port) \
        == (j.otel_interval_s, j.http_host, j.http_port) \
        == (0.0, "127.0.0.1", None)
