"""The port's `obs/dashboard.py` against the JAX package's.

`render_server` of one status snapshot, alert snapshot and history, and
`render_fleet` of one merged fleet document, give JAX's page once the
package name is substituted (the port's pages name
`tpu_tree_search_torch`), with the clock both modules read pinned. The
inputs reach every panel: stat tiles with the ledger and failover tiles,
firing and resolved alerts, the remediation journal, sparklines, lane
stripes, requests with and without estimates, and fleet rows healthy,
down, degraded, fenced and paused; and a real port server's snapshot. No
page holds a script tag, an `@import` or a `url(`."""

import time

import pytest

from tpu_tree_search.obs import dashboard as jdash
from tpu_tree_search_torch.obs import dashboard as tdash
from tpu_tree_search_torch.service import SearchServer

import _torch_isolation
import _torch_threads

_torch_threads.share_cores()


@pytest.fixture(autouse=True)
def iso(monkeypatch):
    monkeypatch.setattr(time, "strftime",
                        lambda fmt, *a: "2026-01-02 03:04:05")
    with _torch_isolation.isolated():
        yield


SNAPSHOT = {
    "uptime_s": 12.5,
    "queue": {"depth": 3},
    "submeshes": [{"running": "req-0001"}, {"running": None}],
    "counters": {"done": 4, "failed": 1, "preemptions": 2},
    "executor_cache": {"hits": 7, "misses": 1},
    "remediation": {
        "mode": "act", "quarantined": [1], "admission_paused": "storm",
        "actions": [{"rule": "stall", "action": "preempt",
                     "outcome": "applied", "detail": {"s": 1.5}},
                    {"rule": "fail", "action": "quarantine",
                     "outcome": "failed", "detail": {"submesh": 1}},
                    {"rule": "x", "action": "y", "outcome": "skipped"}]},
    "ledger": {"restarts": 2, "lag_s": 0.25,
               "recovered": {"queued": 1, "active": 2, "terminal": 9}},
    "failover": {"fenced": False, "mode": "act", "lease": {"epoch": 3},
                 "takeovers": 1,
                 "peers": [{"expired": True, "released": False},
                           {"expired": True, "released": True}]},
    "capacity": {"lanes_detail": [
        {"lane": 0, "state": "executing", "lifetime_s": 10.0,
         "utilization": 0.75,
         "seconds": {"executing": 7.5, "idle": 2.0, "compiling": 0.5,
                     "draining": 0.001}},
        {"lane": 1, "state": "quarantined", "lifetime_s": 0.0,
         "utilization": None, "seconds": {}}]},
    "requests": {
        "req-0001": {"id": "req-0001", "state": "RUNNING", "submesh": 0,
                     "dispatches": 2, "preemptions": 1, "spent_s": 3.25,
                     "progress": {"best": 1081, "estimate": {
                         "progress_ratio": 0.4321, "eta_s": 12.5}}},
        "req-0000": {"id": "req-0000", "state": "DONE", "dispatches": 1,
                     "result": {"best": 1278}, "error": None},
        "req-0002": {"id": "req-0002", "state": "FAILED",
                     "error": "boom <b>&</b>"}},
}
ALERTS = {"firing": 1, "evaluations": 42, "alerts": [
    {"rule": "stall", "severity": "critical", "state": "firing",
     "fired_count": 2, "detail": {"age_s": 31.5, "submesh": 0}},
    {"rule": "queue", "severity": "warn", "state": "resolved",
     "fired_count": 1, "detail": {}},
    {"rule": "info", "severity": "info", "state": "pending"}]}
HISTORY = {"queue_depth": [(0.0, 1), (1.0, 3), (2.0, 2.5e6)],
           "flat": [(0.0, 2.0), (1.0, 2.0)], "empty": []}
MERGED = {"firing": 1, "servers": [
    {"origin": "a:1", "ok": True, "healthz": "ok", "firing": 0,
     "queue_depth": 0, "submeshes": 2, "submeshes_busy": 1, "requests": 2,
     "uptime_s": 5.0, "quarantined": 0, "utilization": 0.5},
    {"origin": "b:2", "ok": False, "error": "refused", "healthz": None},
    {"origin": "c:3", "ok": True, "healthz": "ok", "quarantined": 1,
     "admission_paused": "storm", "restarts": 1, "recovered_requests": 2,
     "ledger_lag_s": 0.5, "failover_mode": "observe", "lease_epoch": 2,
     "peers_down": 1, "takeovers": 0},
    {"origin": "d:4", "ok": True, "healthz": "closing", "fenced": True,
     "failover_mode": "act", "lease_epoch": 5}],
    "alerts": [{"origin": "a:1", "rule": "r", "severity": "warn",
                "state": "firing", "detail": {"x": 1.25}}],
    "requests": [{"origin": "a:1", "id": "req-0003", "state": "QUEUED"}]}


def same_page(got: str, want: str) -> None:
    assert got == want.replace("tpu_tree_search ",
                               "tpu_tree_search_torch ")
    for bad in ("<script", "@import", "url("):
        assert bad not in got


@pytest.mark.parametrize("case", ["full", "empty", "no_alerts"])
def test_render_server_equals_jax(case):
    args = {"full": (SNAPSHOT, ALERTS, HISTORY), "empty": (None, None, None),
            "no_alerts": ({"queue": {}, "requests": {}}, {}, {})}[case]
    got = tdash.render_server(*args)
    same_page(got, jdash.render_server(*args))
    assert "tpu_tree_search_torch — server health" in got


def test_render_server_of_a_port_snapshot(tmp_path):
    srv = SearchServer(n_submeshes=1, devices=["cpu"], workdir=tmp_path,
                       autostart=False, health_interval_s=0,
                       resource_sample_s=0)
    try:
        snap = srv.status_snapshot()
        alerts = srv.health.alerts_snapshot()
        hist = dict(srv.health.history)
    finally:
        srv.close()
    same_page(tdash.render_server(snap, alerts, hist),
              jdash.render_server(snap, alerts, hist))


@pytest.mark.parametrize("merged", [MERGED, {"servers": [], "alerts": [],
                                             "requests": [], "firing": 0}],
                         ids=["fleet", "empty"])
def test_render_fleet_equals_jax(merged):
    got = tdash.render_fleet(merged)
    same_page(got, jdash.render_fleet(merged))
    assert "tpu_tree_search_torch — fleet health" in got


def test_sparkline_equals_jax():
    for pts in HISTORY.values():
        assert tdash.sparkline_svg(pts) == jdash.sparkline_svg(pts)
    assert tdash.sparkline_svg([(0, 1.0)], width=50, height=10) \
        == jdash.sparkline_svg([(0, 1.0)], width=50, height=10)
