"""The port's `obs/aggregate.py` and the `doctor` and `capacity` commands
against the JAX package's.

`parse_prometheus` of a port registry's text (odd lines included),
`merge` and `fleet_to_prometheus` of one fleet scrape (a rich server and a
down one), `verdict` and `needs_takeover` over healthy, firing, degraded,
down-with-lease-held and expired-lease fleets give JAX's results, exactly.
`fleet_lease_report` of lease files the port's `LeaseKeeper` wrote (one
live, one released, one expired) reads alike in both packages (the age,
a wall-clock reading, aside). Against in-process port servers behind
`start_http_server`: `doctor` exits 0 on the healthy fleet (writing the
dashboard and the merged metrics), 1 with a firing alert or a closed
port, and 2 (`DOCTOR_TAKEOVER_EXIT_CODE`) with an expired unreleased
lease in `--fleet-dir`, as JAX's `doctor` does against the same servers;
`capacity` exits 0 and prints every server's document, 1 when one is
unreachable, as JAX's `capacity` does."""

import contextlib
import io
import json
import socket
import time

import pytest

from tpu_tree_search import cli as jcli
from tpu_tree_search.obs import aggregate as jagg
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.obs import aggregate as tagg
from tpu_tree_search_torch.obs import health, metrics
from tpu_tree_search_torch.obs.httpd import start_http_server
from tpu_tree_search_torch.service import SearchServer
from tpu_tree_search_torch.service import lease as tlease

import _torch_isolation
import _torch_threads

_torch_threads.share_cores()

QUIET = dict(health_interval_s=0, resource_sample_s=0)


@pytest.fixture(autouse=True)
def iso(monkeypatch):
    for k in ("TTS_LEDGER", "TTS_FLEET_DIR", "TTS_FAILOVER",
              "TTS_OBS_STORE", "TTS_FAULTS"):
        monkeypatch.delenv(k, raising=False)
    with _torch_isolation.isolated():
        yield


def registry_text() -> str:
    reg = metrics.Registry("tts")
    reg.counter("tts_requests_total", "r").inc(3, state="done", tenant="-")
    reg.gauge("tts_queue_depth", "q").set(2.5)
    reg.histogram("tts_queue_wait_seconds", "w").observe(0.25)
    return (reg.to_prometheus() + '\nbad line without value\n'
            'x{a="1,2",b="y"} +Inf\n\n# comment\n')


def test_parse_prometheus_equals_jax():
    text = registry_text()
    got = tagg.parse_prometheus(text)
    assert got == jagg.parse_prometheus(text)
    assert ("tts_requests_total", {"state": "done", "tenant": "-"},
            3.0) in got
    assert ("x", {"a": "1,2", "b": "y"}, float("inf")) in got


def fleet() -> dict:
    rich = {
        "uptime_s": 9.5, "queue": {"depth": 1},
        "submeshes": [{"running": "req-0001"}, {"running": None}],
        "aot_cache": None,
        "remediation": {"quarantined": [1], "admission_paused": None},
        "ledger": {"restarts": 1, "lag_s": 0.5,
                   "recovered": {"queued": 2, "terminal": 5}},
        "failover": {"fenced": False, "mode": "observe",
                     "lease": {"epoch": 4}, "takeovers": 0,
                     "peers": [{"expired": True, "released": False}]},
        "portfolio": {"active": 1, "won": 2, "cancelled_members": 3},
        "capacity": {"utilization": 0.5, "headroom": 0.5},
        "requests": {
            "req-0001": {"id": "req-0001", "state": "RUNNING",
                         "progress": {"estimate": {
                             "progress_ratio": 0.25, "eta_s": 30.0}}},
            "req-0002": {"id": "req-0002", "state": "RUNNING",
                         "progress": {"estimate": {
                             "progress_ratio": 0.75, "eta_s": 10.0}}},
            "req-0000": {"id": "req-0000", "state": "DONE"}}}
    return {"t": 123.0, "servers": [
        {"origin": "a:1", "url": "http://a:1", "ok": True, "error": None,
         "healthz": {"code": 200, "status": "ok"}, "status": rich,
         "alerts": {"firing": 1, "alerts": [
             {"rule": "stall", "state": "firing", "severity": "critical",
              "detail": {"s": 1}},
             {"rule": "q", "state": "resolved"}]},
         "metrics": tagg.parse_prometheus(registry_text())},
        {"origin": "b:2", "url": "http://b:2", "ok": False,
         "error": "healthz: refused", "healthz": None, "status": None,
         "alerts": None, "metrics": []}]}


def test_merge_and_exposition_equal_jax():
    got, want = tagg.merge(fleet()), jagg.merge(fleet())
    assert got == want
    assert got["firing"] == 1 and len(got["requests"]) == 3
    row = got["servers"][0]
    assert row["progress_mean"] == 0.5 and row["eta_max_s"] == 30.0
    assert tagg.fleet_to_prometheus(got) == jagg.fleet_to_prometheus(want)
    assert 'origin="a:1"' in tagg.fleet_to_prometheus(got)
    assert tagg.recovered_live(fleet()["servers"][0]["status"]["ledger"]) \
        == jagg.recovered_live(fleet()["servers"][0]["status"]["ledger"]) \
        == 2


def test_verdict_and_takeover_equal_jax():
    merged = tagg.merge(fleet())
    healthy = tagg.merge({"t": 0.0, "servers": [
        {"origin": "c:3", "ok": True, "error": None,
         "healthz": {"status": "ok"}, "status": {}, "alerts": {
             "firing": 0, "alerts": []}, "metrics": []}]})
    down = tagg.merge({"t": 0.0, "servers": [
        {"origin": "d:4", "ok": False, "error": "refused", "healthz": None,
         "status": None, "alerts": None, "metrics": []}]})
    live = {"dir": "f/a", "owner": "o", "epoch": 1, "age_s": 0.1,
            "ttl_s": 10.0, "released": False, "expired": False}
    dead = {**live, "dir": "f/b", "expired": True, "age_s": 11.0}
    gone = {**live, "dir": "f/c", "released": True, "expired": True}
    for m in (merged, healthy, down):
        for report in (None, [], [live], [live, gone], [live, dead, gone]):
            assert tagg.verdict(m, lease_report=report) \
                == jagg.verdict(m, lease_report=report)
            if report:
                assert tagg.needs_takeover(report) \
                    == jagg.needs_takeover(report)
    assert tagg.verdict(healthy) == (True, [])
    ok, reasons = tagg.verdict(down, lease_report=[live])
    assert not ok and any("DOWN-with-lease-held" in r for r in reasons)
    assert tagg.needs_takeover([live, dead, gone]) == [dead]


def keeper_dir(fleet_dir, name, ttl, release=False, die=False):
    d = fleet_dir / name
    d.mkdir(parents=True)
    k = tlease.LeaseKeeper(d, owner=f"own-{name}", ttl_s=ttl).acquire()
    if release:
        k.release()
    if die:     # the daemon stops, the file stays: the lease ages out
        k._stop.set()
        k._thread.join(timeout=5.0)
    return k


def without_age(rows: list[dict]) -> list[dict]:
    return [{k: v for k, v in r.items() if k != "age_s"} for r in rows]


def test_fleet_lease_report_of_port_leases(tmp_path):
    fleet_dir = tmp_path / "fleet"
    live = keeper_dir(fleet_dir, "a", 30.0)
    keeper_dir(fleet_dir, "b", 30.0, release=True)
    keeper_dir(fleet_dir, "c", 0.2, die=True)
    (fleet_dir / "no-lease").mkdir()
    try:
        time.sleep(0.5)
        got = tagg.fleet_lease_report(fleet_dir)
        want = jagg.fleet_lease_report(fleet_dir)
    finally:
        live.release()
    assert without_age(got) == without_age(want)
    assert [(r["owner"], r["released"], r["expired"]) for r in got] == [
        ("own-a", False, False), ("own-b", True, True),
        ("own-c", False, True)]
    assert tagg.needs_takeover(got) == [got[2]]
    assert tagg.fleet_lease_report(tmp_path / "missing") == []


def run(main, argv) -> tuple[int, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue()


@contextlib.contextmanager
def fronted(tmp_path, n):
    """`n` idle port servers on the CPU, each behind its HTTP front end;
    all closed on exit."""
    with contextlib.ExitStack() as stack:
        pairs = []
        for i in range(n):
            srv = SearchServer(n_submeshes=1, devices=["cpu"],
                               workdir=tmp_path / f"wd{i}",
                               autostart=False, **QUIET)
            stack.callback(srv.close)
            httpd = start_http_server(srv)
            stack.callback(httpd.close)
            pairs.append((srv, httpd))
        yield pairs


def closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_doctor_exit_codes_against_port_servers(tmp_path):
    with fronted(tmp_path, 2) as pairs:
        urls = [h.url for _, h in pairs]
        html, prom = tmp_path / "fleet.html", tmp_path / "fleet.prom"
        rc, text = run(cli.main, ["doctor", *urls, "--dashboard", str(html),
                                  "--metrics-out", str(prom),
                                  "--timeout", "10"])
        assert rc == 0 and text.strip().endswith("healthy")
        assert run(jcli.main, ["doctor", *urls, "--timeout", "10"])[0] == 0
        page = html.read_text()
        assert "tpu_tree_search_torch — fleet health" in page
        assert "<script" not in page
        assert f'origin="127.0.0.1:{pairs[1][1].port}"' in prom.read_text()
        rc, text = run(cli.main, ["doctor", *urls, "--json"])
        doc = json.loads(text)
        assert rc == 0 and doc["healthy"] and len(doc["servers"]) == 2

        # one member with a firing alert: 1 in both packages' doctor
        mon = pairs[1][0].health
        mon.rules.append(health.Rule(
            "synthetic", lambda ctx: (True, {"injected": True}),
            severity="critical"))
        mon.evaluate_now()
        rc, text = run(cli.main, ["doctor", *urls])
        assert rc == 1 and "synthetic" in text and "UNHEALTHY" in text
        assert run(jcli.main, ["doctor", *urls])[0] == 1

        # a closed port: unreachable, 1
        dead = f"http://127.0.0.1:{closed_port()}"
        rc, text = run(cli.main, ["doctor", urls[0], dead, "--timeout",
                                  "0.5"])
        assert rc == 1 and "unreachable" in text

        # an expired unreleased lease in the fleet root: 2
        fleet_dir = tmp_path / "fleet"
        keeper_dir(fleet_dir, "gone", 0.2, die=True)
        time.sleep(0.5)
        rc, text = run(cli.main, ["doctor", urls[0], "--fleet-dir",
                                  str(fleet_dir)])
        assert rc == cli.DOCTOR_TAKEOVER_EXIT_CODE == 2
        assert "DOWN-lease-expired" in text and "EXPIRED" in text
        assert run(jcli.main, ["doctor", urls[0], "--fleet-dir",
                               str(fleet_dir)])[0] == 2


def test_capacity_command_against_port_servers(tmp_path):
    with fronted(tmp_path, 1) as pairs:
        url = pairs[0][1].url
        rc, text = run(cli.main, ["capacity", url, "--timeout", "10"])
        assert rc == 0 and f"127.0.0.1:{pairs[0][1].port}: lanes=" in text
        assert "  lane 0: idle" in text
        rc, text = run(cli.main, ["capacity", url, "--json"])
        (doc,) = json.loads(text)
        assert rc == 0 and doc["enabled"] is True
        jrc, jtext = run(jcli.main, ["capacity", url, "--json"])
        assert jrc == 0 and set(json.loads(jtext)[0]) == set(doc)
        dead = f"http://127.0.0.1:{closed_port()}"
        rc, text = run(cli.main, ["capacity", url, dead, "--timeout",
                                  "0.5"])
        assert rc == 1 and "UNREACHABLE" in text
        assert run(jcli.main, ["capacity", url, dead, "--timeout",
                               "0.5"])[0] == 1
