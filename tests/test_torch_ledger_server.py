"""The port's server on a request ledger, against the JAX package's.

Mirrors `tests/test_ledger.py` on the CPU (port servers on `["cpu"] * n`
workers, JAX's on the conftest's CPU devices, `KW = dict(chunk=8,
capacity=1 << 12, min_seed=4)`, `PFSPInstance.synthetic` tables):

- replay at boot: queued requests, exclusions, a quarantine and an
  admission pause survive a hard death; both packages recover the same
  counts, request and ledger snapshots and remediation journal, serve the
  same totals, and journal the same records (wall-clock keys left out);
  a DONE tag submitted again is served again with no dispatch;
- a request running at the crash resumes from its checkpoint to the JAX
  package's standalone totals, its budget cumulative and its drill
  stripped, also behind a torn ledger tail;
- either package's server boots on a ledger and checkpoints the other
  wrote and resumes the request to the same `(tree, sol, best)`;
- the workdir defaults to `<ledger>/workdir`; close() under a ledger is a
  drain.

Spool reconnection and the `serve` command on a ledger are
test_torch_ledger_serve.py's.

Tolerance: exact (integer counts, JSON records)."""

import os

import jax
import pytest

from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.service import SearchRequest as JRequest
from tpu_tree_search.service import SearchServer as JServer
from tpu_tree_search.service.queueing import AdmissionPaused as JPaused
from tpu_tree_search_torch.service import SearchRequest, SearchServer
from tpu_tree_search_torch.service.ledger import RequestLedger
from tpu_tree_search_torch.service.queueing import AdmissionPaused

import _torch_isolation
import _torch_threads
from _torch_durable import (KW, QUIET, crash, ledger_records, small,
                            strip, totals, wait_segment)

_torch_threads.share_cores()


@pytest.fixture(autouse=True)
def iso(monkeypatch):
    for k in ("TTS_MEGABATCH", "TTS_OVERLAP", "TTS_SHARE_INCUMBENT",
              "TTS_REMEDIATE", "TTS_LEDGER", "TTS_FLEET_DIR",
              "TTS_PORTFOLIO", "TTS_FAILOVER", "TTS_OBS_STORE",
              "TTS_TUNE_CACHE", "TTS_TUNE", "TTS_PREWARM", "TTS_FAULTS",
              "TTS_PROGRESS", "TTS_CAPACITY", "TTS_LEASE_TTL_S"):
        # set, then removed: monkeypatch restores the variable as unset
        # even where a command under test exported it
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    with _torch_isolation.isolated():
        yield


def servers(n_workers):
    """(name, Server, Request, devices) of both packages."""
    return (("jax", JServer, JRequest, jax.devices()[:n_workers]),
            ("torch", SearchServer, SearchRequest, ["cpu"] * n_workers))


@pytest.fixture(scope="module")
def base2():
    """JAX's standalone two-worker totals of the instance served here."""
    out = {}
    for seed, jobs in ((5, 8),):
        got = jdist.search(small(seed, jobs).p_times, lb_kind=1,
                           init_ub=None, n_devices=2, **KW)
        out[seed] = (got.explored_tree, got.explored_sol, got.best)
    return out


def by_rid(records):
    """Ledger records grouped by request (executor threads interleave
    different requests' records), budget heartbeats left out (they are
    throttled by wall time)."""
    out = {}
    for r in records:
        if r["k"] != "budget":
            out.setdefault(r.get("rid"), []).append(r)
    return out


def test_replay_at_boot_equals_jax(tmp_path):
    got = {}
    for name, Server, Request, devs in servers(4):
        ld, wd = tmp_path / name / "led", tmp_path / name / "wd"
        mk = dict(n_submeshes=2, devices=devs, workdir=wd,
                  ledger_dir=str(ld), **QUIET)
        srv = Server(autostart=False, **mk)
        a = srv.submit(Request(p_times=small(0).p_times, lb_kind=1,
                               tag="q1", **KW))
        b = srv.submit(Request(p_times=small(1).p_times, lb_kind=2,
                               tag="q2", tenant="team-a", **KW))
        srv.add_exclusion(srv.records[a], 1)
        srv.quarantine_submesh(0, "drill quarantine")
        srv.pause_admission("compile storm drill")
        crash(srv)

        srv2 = Server(autostart=False, **mk)
        snap = srv2.status_snapshot()
        boot = dict(
            recovered=dict(srv2._recovered),
            ledger=strip(snap["ledger"]), failover=snap["failover"],
            portfolio=snap["portfolio"],
            requests=[strip(srv2.status(r)) for r in (a, b)],
            paused=srv2.admission_paused(),
            quarantined=[(s.quarantined, s.quarantine_reason)
                         for s in srv2.slots],
            excluded=[sorted(srv2.records[r].excluded_submeshes)
                      for r in (a, b)],
            remediation=[(x["rule"], x["action"], x["outcome"],
                          strip(x["detail"]))
                         for x in snap["remediation"]["actions"]])
        with pytest.raises((AdmissionPaused, JPaused)):
            srv2.submit(Request(p_times=small(0).p_times, **KW))
        srv2.resume_admission()
        srv2.readmit_submesh(0)
        srv2.start()
        try:
            done = [totals(srv2.result(r, timeout=300)) for r in (a, b)]
            before = srv2.records[a].dispatches
            again = srv2.submit(Request(p_times=small(0).p_times,
                                        lb_kind=1, tag="q1", **KW))
            assert again == a and srv2.records[a].dispatches == before
            # submitted and cancelled under the server's lock: no
            # scheduler tick can dispatch it in between, so both
            # packages journal the same records for it
            with srv2._lock:
                other = srv2.submit(Request(p_times=small(1).p_times,
                                            lb_kind=1, tag="q1", **KW))
                srv2.cancel(other)
            assert other != a
        finally:
            srv2.close()
        got[name] = (boot, done, strip(by_rid(ledger_records(ld))))
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][2] == got["jax"][2]
    boot = got["torch"][0]
    assert boot["recovered"] == {"queued": 2, "active": 0, "held": 0,
                                 "terminal": 0}
    assert boot["paused"] == "compile storm drill"
    assert boot["quarantined"][0] == (True, "drill quarantine")
    assert boot["excluded"] == [[1], []]
    assert ("quarantine", "quarantine_submesh", "restored") in [
        x[:3] for x in boot["remediation"]]
    assert boot["ledger"]["restarts"] == 1
    assert boot["ledger"]["last_shutdown"] == "crash"


@pytest.mark.parametrize("tail", ["clean", "torn"])
def test_running_request_resumes_after_a_crash(base2, tmp_path, tail):
    inst = small(5, jobs=8)
    ld, wd = tmp_path / "led", tmp_path / "wd"
    mk = dict(n_submeshes=1, devices=["cpu"] * 2, workdir=wd,
              ledger_dir=str(ld), **QUIET)
    srv = SearchServer(**mk)
    rid = srv.submit(SearchRequest(
        p_times=inst.p_times, lb_kind=1, tag="run1", segment_iters=8,
        checkpoint_every=1, faults="delay_every=0.1", **KW))
    wait_segment(srv, rid, 2)
    assert srv.status(rid)["state"] == "RUNNING"
    crash(srv)
    spent = srv.records[rid].spent_prev_s
    assert spent > 0 and os.path.exists(srv.records[rid].checkpoint_path)
    if tail == "torn":
        seg = sorted(ld.glob("seg-*.jsonl"))[-1]
        with open(seg, "ab") as f:
            f.write(b'{"c": 1, "r": {"k": "terminal", "rid": "' + b"x" * 9)
    srv2 = SearchServer(**mk)
    try:
        rec = srv2.records[rid]
        assert srv2._recovered["queued"] + srv2._recovered["active"] == 1
        assert rec.spent_prev_s >= spent - 0.01
        assert rec.dispatches >= 1 and rec.request.faults is None
        out = srv2.result(rid, timeout=300)
        assert out.state == "DONE", (out.state, out.error)
        assert totals(out) == base2[5]
        assert out.spent_s() >= spent - 0.01
        assert srv2.status_snapshot()["ledger"]["truncated"] == (
            1 if tail == "torn" else 0)
    finally:
        srv2.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_boots_on_the_other_packages_ledger_and_checkpoints(
        base2, tmp_path, writer):
    """A request running on one package's server at its death resumes on
    the other package's server from the ledger and the checkpoint the
    first one wrote, to JAX's standalone totals."""
    pkgs = {n: (S, R, d) for n, S, R, d in servers(2)}
    inst = small(5, jobs=8)
    ld, wd = tmp_path / "led", tmp_path / "wd"
    S, R, devs = pkgs[writer]
    srv = S(n_submeshes=1, devices=devs, workdir=wd, ledger_dir=str(ld),
            **QUIET)
    rid = srv.submit(R(p_times=inst.p_times, lb_kind=1, tag="x1",
                       segment_iters=8, checkpoint_every=1,
                       faults="delay_every=0.1", **KW))
    wait_segment(srv, rid, 2)
    crash(srv)
    ckpt = srv.records[rid].checkpoint_path
    assert os.path.exists(ckpt)
    S, R, devs = pkgs["torch" if writer == "jax" else "jax"]
    srv2 = S(n_submeshes=1, devices=devs, workdir=wd, ledger_dir=str(ld),
             **QUIET)
    try:
        assert srv2.records[rid].dispatches >= 1
        out = srv2.result(rid, timeout=300)
        assert out.state == "DONE", (out.state, out.error)
        assert totals(out) == base2[5]
        assert srv2.ledger.snapshot()["restarts"] == 1
    finally:
        srv2.close()
    kinds = [r["k"] for r in ledger_records(ld)]
    assert kinds.count("boot") == 2 and kinds[-1] == "drain"
    assert kinds.count("terminal") == 1


def test_workdir_defaults_under_the_ledger_and_close_drains(tmp_path):
    srv = SearchServer(n_submeshes=1, devices=["cpu"],
                       ledger_dir=str(tmp_path / "led"), autostart=False,
                       **QUIET)
    assert srv.workdir == tmp_path / "led" / "workdir"
    rid = srv.submit(SearchRequest(p_times=small(0).p_times, lb_kind=1,
                                   tag="drain1", **KW))
    srv.close()
    assert srv.records[rid].state == "QUEUED"
    assert srv.records[rid].done_event.is_set()
    led = RequestLedger(tmp_path / "led")
    assert led.snapshot()["last_shutdown"] == "clean"
    assert led.state.requests[rid]["state"] == "QUEUED"
    led.close()
    # the ledger off: queued requests cancel and no snapshot key appears
    srv = SearchServer(n_submeshes=1, devices=["cpu"], autostart=False,
                       workdir=tmp_path / "wd0", **QUIET)
    rid = srv.submit(SearchRequest(p_times=small(0).p_times, **KW))
    snap = srv.status_snapshot()
    assert (snap["ledger"], snap["failover"], snap["portfolio"]) == (
        None, None, None)
    srv.close()
    assert srv.records[rid].state == "CANCELLED"
