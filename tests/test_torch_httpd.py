"""The port's `obs/httpd.py` in front of a port `SearchServer` on the CPU,
against JAX's front end in front of JAX's server.

Every GET route answers with JAX's status code and content type, and its
JSON holds JAX's keys (both servers idle, built alike). `POST /submit` of
a small PFSP instance reaches JAX's `(tree, sol, best)` (its standalone
two-worker search, the server's submesh). The error paths mirror JAX's
`tests/test_telemetry.py` (400, 429 and 503 on submit; 200 and 404 on
cancel; 404 and 405 on unknown paths and verbs), `tests/test_profiling.py`
(200 with an artifact, 409 while a capture runs, 400 on a bad duration,
503 once closing) and `tests/test_obs.py` (`/healthz` 503 after close).
With a ledger, a request admitted over HTTP survives a hard kill before
anything ran (`tests/test_ledger.py`). The `serve` command with
`--http-port 0` prints its URL and serves the routes. Every HTTP call has
a timeout of 10 s or less; every server and front end closes in the
test."""

import contextlib
import io
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import pytest

from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.obs.httpd import start_http_server as jstart
from tpu_tree_search.service import SearchServer as JServer
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.obs import chrome_trace, profiler
from tpu_tree_search_torch.obs.httpd import start_http_server
from tpu_tree_search_torch.service import SearchServer, spool

import _torch_isolation
import _torch_threads
from _torch_durable import KW, QUIET, crash, small, totals, wait_until

_torch_threads.share_cores()

GETS = ("/healthz", "/metrics", "/status", "/trace", "/alerts",
        "/capacity", "/dashboard", "/journey", "/journey?tag=none", "/",
        "/nope", "/submit")


@pytest.fixture(autouse=True)
def iso(monkeypatch):
    for k in ("TTS_MEGABATCH", "TTS_OVERLAP", "TTS_SHARE_INCUMBENT",
              "TTS_REMEDIATE", "TTS_LEDGER", "TTS_FLEET_DIR",
              "TTS_PORTFOLIO", "TTS_FAILOVER", "TTS_OBS_STORE",
              "TTS_TUNE_CACHE", "TTS_TUNE", "TTS_PREWARM", "TTS_FAULTS"):
        monkeypatch.delenv(k, raising=False)
    with _torch_isolation.isolated():
        yield


def get(url) -> tuple[int, str, bytes]:
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def post(url, payload=None) -> tuple[int, dict]:
    data = b"" if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@contextlib.contextmanager
def fronted(server, start=start_http_server, **kw):
    """A server behind its front end; both closed on exit."""
    httpd = start(server, **kw)
    try:
        yield httpd
    finally:
        httpd.close()
        server.close()


def answers(httpd) -> dict:
    out = {}
    for path in GETS:
        code, ctype, body = get(httpd.url + path)
        keys = (sorted(json.loads(body)) if ctype == "application/json"
                else None)
        out[path] = (code, ctype, keys)
    return out


def test_get_routes_answer_as_jax(tmp_path):
    port = SearchServer(n_submeshes=1, devices=["cpu"],
                        workdir=tmp_path / "t", autostart=False, **QUIET)
    jsrv = JServer(n_submeshes=1, devices=jax.devices()[:1],
                   workdir=tmp_path / "j", autostart=False, **QUIET)
    with fronted(port) as th, fronted(jsrv, start=jstart) as jh:
        got, want = answers(th), answers(jh)
        metrics_text = get(th.url + "/metrics")[2].decode()
    assert got == want
    assert got["/healthz"][:2] == (200, "application/json")
    assert got["/dashboard"][:2] == (200, "text/html; charset=utf-8")
    assert got["/metrics"][:2] == (
        200, "text/plain; version=0.0.4; charset=utf-8")
    assert got["/nope"][0] == 404 and got["/submit"][0] == 405
    assert 'tts_http_requests_total{path="/healthz"} 1' in metrics_text


@pytest.fixture(scope="module")
def golden():
    """JAX's standalone two-worker totals of the instance served here."""
    got = jdist.search(small(1).p_times, lb_kind=1, init_ub=None,
                       n_devices=2, **KW)
    return got.explored_tree, got.explored_sol, got.best


def test_submit_reaches_the_jax_golden(golden, tmp_path):
    inst = small(1)
    srv = SearchServer(n_submeshes=1, devices=["cpu"] * 2,
                       workdir=tmp_path, **QUIET)
    with fronted(srv) as httpd:
        code, body = post(httpd.url + "/submit", {
            "p_times": inst.p_times.tolist(), "lb": 1, **KW})
        assert code == 200 and body["state"] in ("QUEUED", "RUNNING")
        rec = srv.result(body["request_id"], timeout=120)
        status = json.loads(get(httpd.url + "/status")[2])
    assert rec.state == "DONE" and totals(rec) == golden
    assert status["requests"][body["request_id"]]["state"] == "DONE"


def test_submit_and_cancel_errors(tmp_path):
    inst = small(5, jobs=8)
    payload = {"p_times": inst.p_times.tolist(), "lb": 1, **KW}
    srv = SearchServer(n_submeshes=1, devices=["cpu"], workdir=tmp_path,
                       autostart=False, max_queue_depth=1, **QUIET)
    with fronted(srv) as httpd:
        code, body = post(httpd.url + "/submit", payload)
        assert code == 200 and body["state"] == "QUEUED"
        rid = body["request_id"]
        code, body = post(httpd.url + "/submit", payload)   # queue full
        assert code == 429 and "error" in body
        for bad in ({"lb": 1}, {"request_id": None}, None, [1, 2]):
            assert post(httpd.url + "/submit", bad)[0] == 400
        code, body = post(httpd.url + "/cancel", {"request_id": rid})
        assert (code, body["cancelled"]) == (200, True)
        assert srv.status(rid)["state"] == "CANCELLED"
        code, body = post(httpd.url + "/cancel", {"request_id": rid})
        assert (code, body["cancelled"]) == (200, False)
        assert post(httpd.url + "/cancel", {"nope": 1})[0] == 400
        assert post(httpd.url + "/cancel",
                    {"request_id": "req-9999"})[0] == 404
        assert post(httpd.url + "/metrics")[0] == 405
        assert post(httpd.url + "/nope")[0] == 404
        srv.close()
        code, body = post(httpd.url + "/submit", payload)
        assert code == 503 and "error" in body


def test_profile_409_400_and_503(tmp_path):
    srv = SearchServer(n_submeshes=1, devices=["cpu"], workdir=tmp_path,
                       autostart=False, **QUIET)
    with fronted(srv, profile_dir=str(tmp_path / "prof")) as httpd:
        code, body = post(httpd.url + "/profile?duration_s=0.05")
        assert code == 200 and body["duration_s"] == 0.05
        assert body["artifact"].startswith(str(tmp_path / "prof"))
        assert os.path.isdir(body["artifact"])
        assert chrome_trace.load_profile_trace(body["artifact"]) != []
        sess = profiler.session()
        sess.start(sess.fresh_dir(tmp_path / "prof"))
        try:
            code, body = post(httpd.url + "/profile?duration_s=0.05")
            assert code == 409 and "already running" in body["error"]
        finally:
            sess.stop()
        for bad in ("-3", "0", "301", "x"):
            assert post(httpd.url + f"/profile?duration_s={bad}")[0] == 400
        srv.close()
        assert post(httpd.url + "/profile?duration_s=0.05")[0] == 503
    # without --profile-dir the captures go under the server's workdir
    srv = SearchServer(n_submeshes=1, devices=["cpu"],
                       workdir=tmp_path / "wd", autostart=False, **QUIET)
    with fronted(srv) as httpd:
        assert httpd.profile_dir == str(tmp_path / "wd" / "profiles")


def test_healthz_flips_to_503_on_close(tmp_path):
    srv = SearchServer(n_submeshes=1, devices=["cpu"], workdir=tmp_path,
                       autostart=False, **QUIET)
    with fronted(srv) as httpd:
        assert get(httpd.url + "/healthz")[:2] == (200, "application/json")
        srv.close()
        code, ctype, body = get(httpd.url + "/healthz")
        assert (code, json.loads(body)) == (503, {"status": "closing"})
        assert get(httpd.url + "/nope")[0] == 404


def test_http_submit_survives_a_hard_kill(golden, tmp_path):
    """A 200 from POST /submit is a journaled admission: a kill before
    anything ran loses nothing, and the restarted server completes the
    request to JAX's standalone totals."""
    inst = small(1)
    srv = SearchServer(n_submeshes=1, devices=["cpu"] * 2,
                       workdir=tmp_path / "wd",
                       ledger_dir=str(tmp_path / "led"), autostart=False,
                       **QUIET)
    httpd = start_http_server(srv)
    try:
        code, body = post(httpd.url + "/submit", {
            "p_times": inst.p_times.tolist(), "lb": 1, "tag": "http1",
            **KW})
        assert code == 200
        rid = body["request_id"]
    finally:
        httpd.close()
        crash(srv)
    srv2 = SearchServer(n_submeshes=1, devices=["cpu"] * 2,
                        workdir=tmp_path / "wd",
                        ledger_dir=str(tmp_path / "led"), **QUIET)
    try:
        assert srv2._recovered["queued"] == 1
        rec = srv2.result(rid, timeout=120)
        snap = srv2.status_snapshot()
    finally:
        srv2.close()
    assert rec.state == "DONE", (rec.state, rec.error)
    assert totals(rec) == golden
    assert snap["ledger"]["restarts"] == 1
    assert snap["ledger"]["last_shutdown"] == "crash"
    assert snap["requests"][rid]["tag"] == "http1"


def test_serve_command_fronts_the_spool(tmp_path):
    """`serve --http-port 0 --otel-endpoint ...` on the CPU: the printed
    URL answers, a request over HTTP and one from the spool both end DONE,
    and the shutdown prints JAX's `otel:` line (no SDK here: 0 spans)."""
    sp = tmp_path / "spool"
    inst = small(1)
    sid = spool.submit_file(sp, {"p_times": inst.p_times.tolist(),
                                 "lb": 1, **KW})
    out, rc = io.StringIO(), {}

    def serve():
        rc["serve"] = cli.main([
            "serve", "--spool", str(sp), "--device", "cpu", "--idle-exit",
            "1.5", "--status-every", "0", "--workdir", str(tmp_path / "wd"),
            "--health-interval-s", "0", "--resource-sample-s", "0",
            "--http-port", "0", "--otel-endpoint",
            "http://127.0.0.1:9/v1/traces", "--profile-dir",
            str(tmp_path / "prof")])

    th = threading.Thread(target=serve)
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        th.start()
        wait_until(lambda: "observability: " in out.getvalue()
                   or not th.is_alive(), timeout=60, msg="front end")
        line = next(ln for ln in out.getvalue().splitlines()
                    if ln.startswith("observability: "))
        url = line.split()[1].rsplit("/healthz", 1)[0]
        assert get(url + "/healthz")[0] == 200
        code, body = post(url + "/submit", {
            "p_times": small(2).p_times.tolist(), "lb": 1, **KW})
        assert code == 200
        res = spool.wait_result(sp, sid, timeout=60)
        wait_until(lambda: json.loads(get(url + "/status")[2])["requests"]
                   [body["request_id"]]["state"] == "DONE", timeout=60,
                   msg="HTTP request done")
        th.join(timeout=60)
    text = out.getvalue()
    assert not th.is_alive() and rc == {"serve": 0}, text
    assert res["state"] == "DONE"
    assert "otel: exported 0 span(s) at shutdown (0 total) to " \
        "http://127.0.0.1:9/v1/traces" in text
    assert "served 1 request(s)" in text
    with pytest.raises(OSError):
        urllib.request.urlopen(url + "/healthz", timeout=2)


def test_aot_cache_flag_still_names_a9d(tmp_path):
    sp = str(tmp_path / "spool")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["serve", "--spool", sp, "--device", "cpu",
                       "--aot-cache", "a", "--http-port", "0"])
    assert rc == 1 and "ROADMAP A9d" in err.getvalue()
    assert not os.path.exists(sp)
