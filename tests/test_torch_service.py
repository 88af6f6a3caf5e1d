"""The port's search server against the JAX package's.

Mirrors `tests/test_service.py` on the CPU: two submeshes of two CPU
workers each (the port's `devices=["cpu"] * 4`, JAX's first four devices
of the conftest's mesh), `KW = dict(chunk=8, capacity=1 << 12,
min_seed=4)`, `PFSPInstance.synthetic` tables from numpy seeds. Every
served request's `(explored_tree, explored_sol, best)` equals the JAX
package's standalone `distributed.search` on two workers (JAX's own test
holds its server to that search); concurrent requests, preemption and
resume, deadlines with partial counters, admission and cancel, a
duplicate active tag, fault isolation, the executor cache (same shape
hits, another lb misses), two instances of one class through one cached
loop (each its solo run, the caller's tables untouched), megabatching, a
failed first dispatch redispatched with the remediation journal, the
`serve` and `client` commands, the front end's flags starting `serve`,
and the left-out arguments naming their ROADMAP item (the durability layer's own tests are test_torch_ledger*.py,
test_torch_lease*.py, test_torch_failover.py, test_torch_portfolio*.py and
test_torch_journey*.py). One scenario runs through both servers and their request
and status snapshots are compared key by key, the wall-clock keys listed
in `WALL` left out. Tolerance is exact: all of it is integer and host
logic."""

import contextlib
import io
import json
import os
import threading
import time

import jax
import numpy as np
import pytest

from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.parallel.mesh import partition_submeshes as jpartition
from tpu_tree_search.service import AdmissionError as JAdmissionError
from tpu_tree_search.service import ExecutorCache as JCache
from tpu_tree_search.service import SearchRequest as JRequest
from tpu_tree_search.service import SearchServer as JServer
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.engine import distributed as tdist
from tpu_tree_search_torch.problems.pfsp import PFSPInstance
from tpu_tree_search_torch.service import (AdmissionError, ExecutorCache,
                                           SearchRequest, SearchServer,
                                           TERMINAL_STATES)

import _torch_isolation
import _torch_threads

_torch_threads.share_cores()

KW = dict(chunk=8, capacity=1 << 12, min_seed=4)
CPUS = ["cpu"] * 4

# the snapshot keys that hold wall-clock values (or values computed from
# them), left out of the comparison with JAX's snapshots
WALL = {"t", "uptime_s", "spent_s", "elapsed_s", "heartbeat_age_s",
        "dispatch_wait_s", "created_unix", "since", "eta_s"}
# metric families left out: histograms and gauges of wall-clock seconds and
# rates, the memory sampler's (the port's CPU record is the process's
# resident set, JAX's one series per CPU device), the health daemon's
# evaluation count (its interval against the run's wall time)
WALL_METRICS = {"tts_queue_wait_seconds", "tts_request_spent_seconds",
                "tts_compile_seconds", "tts_lane_seconds_total",
                "tts_capacity_headroom", "tts_capacity_predicted_wait_s",
                "tts_capacity_utilization", "tts_device_bytes_in_use",
                "tts_device_bytes_peak", "tts_device_bytes_limit",
                "tts_host_rss_bytes", "tts_health_evaluations_total"}


@pytest.fixture(autouse=True)
def iso(monkeypatch):
    for k in ("TTS_MEGABATCH", "TTS_OVERLAP", "TTS_SHARE_INCUMBENT",
              "TTS_REMEDIATE", "TTS_LADDER", "TTS_SEARCH_TELEMETRY",
              "TTS_LEDGER", "TTS_FLEET_DIR", "TTS_AOT_CACHE",
              "TTS_PORTFOLIO", "TTS_FAILOVER", "TTS_OBS_STORE",
              "TTS_TUNE_CACHE", "TTS_TUNE", "TTS_PREWARM", "TTS_FAULTS"):
        monkeypatch.delenv(k, raising=False)
    with _torch_isolation.isolated():
        yield


def small(seed, jobs=7):
    return PFSPInstance.synthetic(jobs=jobs, machines=3, seed=seed)


@pytest.fixture(scope="module")
def baselines():
    """The JAX package's standalone `distributed.search` on two workers
    (the submesh size the two-submesh tests serve at); one JAX executor
    cache, so each shape compiles once."""
    cache = JCache()
    out = {}
    for seed, jobs in [(0, 7), (1, 7), (2, 7), (3, 7), (5, 8), (6, 7)]:
        got = jdist.search(small(seed, jobs).p_times, lb_kind=1,
                           init_ub=None, n_devices=2, loop_cache=cache,
                           **KW)
        out[seed] = (got.explored_tree, got.explored_sol, got.best)
    return out


def wait_state(srv, rid, state, timeout=120.0):
    t0 = time.monotonic()
    while True:
        now = srv.status(rid)["state"]
        if now == state:
            return
        assert now not in TERMINAL_STATES, srv.status(rid)
        assert time.monotonic() - t0 < timeout, srv.status(rid)
        time.sleep(0.02)


def totals(rec):
    res = rec.result
    return (res.explored_tree, res.explored_sol, res.best)


def test_partition_and_slot_ids_as_jax():
    for n in (1, 2, 4, 8):
        srv = SearchServer(n_submeshes=n, devices=["cpu"] * 8,
                           autostart=False, health_interval_s=0,
                           resource_sample_s=0)
        try:
            want = [[int(d.id) for d in m.devices.flat]
                    for m in jpartition(n)]
            assert [s.device_ids for s in srv.slots] == want
        finally:
            srv.close()
    with pytest.raises(ValueError, match="do not split"):
        SearchServer(n_submeshes=3, devices=["cpu"] * 8, autostart=False)


def test_concurrent_requests_equal_jax_and_reuse_loops(baselines,
                                                       tmp_path):
    """Four concurrent requests on two submeshes, each equal to JAX's
    standalone search; each submesh builds one loop and the second request
    on it reuses it."""
    insts = {s: small(s) for s in range(4)}
    with SearchServer(n_submeshes=2, devices=CPUS, workdir=tmp_path,
                      segment_iters=256) as srv:
        rids = {s: srv.submit(SearchRequest(p_times=i.p_times, lb_kind=1,
                                            **KW))
                for s, i in insts.items()}
        for s, rid in rids.items():
            rec = srv.result(rid, timeout=300)
            assert rec.state == "DONE", (rec.state, rec.error)
            assert totals(rec) == baselines[s]
        snap = srv.status_snapshot()
    json.dumps(snap)
    assert snap["executor_cache"] == {"entries": 2, "hits": 2, "misses": 2}
    assert snap["counters"]["done"] == 4
    assert all(sm["running"] is None for sm in snap["submeshes"])
    assert all("tree_per_worker" in r["result"]
               for r in snap["requests"].values())


def test_executor_cache_same_shape_hits_lb_misses(tmp_path):
    a, b = small(0), small(1)
    with SearchServer(n_submeshes=1, devices=CPUS[:2], workdir=tmp_path,
                      segment_iters=256) as srv:
        for p, lb in [(a.p_times, 1), (b.p_times, 1), (a.p_times, 2)]:
            rid = srv.submit(SearchRequest(p_times=p, lb_kind=lb, **KW))
            assert srv.result(rid, timeout=300).state == "DONE"
        snap = srv.status_snapshot()
    assert snap["executor_cache"] == {"entries": 2, "hits": 1, "misses": 2}
    assert [r["key"] for r in snap["compile_ledger"]] == [
        "pfsp/7/3/1/8/int16/0/1/4096/4/256/16/3584",
        "pfsp/7/3/2/8/int16/0/1/4096/4/256/16/3584"]
    assert all(r["source"] == "capture" and r["method"] == "eager"
               and r["flops"] is None for r in snap["compile_ledger"])


@pytest.mark.parametrize("seeds", [(1, 2, 0, 3)])
def test_one_cached_loop_serves_each_instance_its_own_tables(
        baselines, seeds):
    """The stale-table check: instances of one class served one after the
    other through one cached loop; the later ones hit the cache and each
    gives its own solo totals, and no caller's table changes."""
    cache = ExecutorCache()
    tables = [small(s).p_times for s in seeds]
    kept = [t.copy() for t in tables]
    got = [tdist.search(t, devices=CPUS[:2], lb_kind=1, loop_cache=cache,
                        worker_ids=(0, 1), **KW) for t in tables]
    assert [(r.explored_tree, r.explored_sol, r.best) for r in got] == [
        baselines[s] for s in seeds]
    assert cache.snapshot() == {"entries": 1, "hits": len(seeds) - 1,
                                "misses": 1}
    assert all(np.array_equal(a, b) for a, b in zip(tables, kept))


def test_priority_preemption_and_checkpoint_resume(baselines, tmp_path):
    slow, fast = small(5, jobs=8), small(6)
    with SearchServer(n_submeshes=2, devices=CPUS, workdir=tmp_path,
                      share_incumbent=False) as srv:
        slow_ids = [srv.submit(SearchRequest(
            p_times=slow.p_times, lb_kind=1, priority=0,
            segment_iters=32, checkpoint_every=1,
            faults="delay_every=0.15", **KW)) for _ in range(2)]
        for rid in slow_ids:
            wait_state(srv, rid, "RUNNING")
        hi = srv.submit(SearchRequest(p_times=fast.p_times, lb_kind=1,
                                      priority=10, segment_iters=256, **KW))
        rec_hi = srv.result(hi, timeout=300)
        assert rec_hi.state == "DONE", (rec_hi.state, rec_hi.error)
        assert totals(rec_hi) == baselines[6]
        assert srv.counters["preemptions"] >= 1
        recs = [srv.result(rid, timeout=600) for rid in slow_ids]
    assert all(r.state == "DONE" for r in recs), \
        [(r.state, r.error) for r in recs]
    assert sum(r.preemptions for r in recs) >= 1
    for r in recs:
        assert totals(r) == baselines[5]


def test_fault_injection_isolated_to_one_submesh(baselines, tmp_path):
    a, b = small(2), small(3)
    with SearchServer(n_submeshes=2, devices=CPUS, workdir=tmp_path) as srv:
        ra = srv.submit(SearchRequest(p_times=a.p_times, lb_kind=1,
                                      segment_iters=64,
                                      faults="delay_segment=1:3.0", **KW))
        wait_state(srv, ra, "RUNNING")
        rb = srv.submit(SearchRequest(p_times=b.p_times, lb_kind=1,
                                      segment_iters=256, **KW))
        rec_b = srv.result(rb, timeout=300)
        assert rec_b.state == "DONE" and totals(rec_b) == baselines[3]
        assert srv.status(ra)["state"] == "RUNNING"
        rec_a = srv.result(ra, timeout=300)
    assert rec_a.state == "DONE" and totals(rec_a) == baselines[2]


def test_deadline_stops_with_partial_result(tmp_path):
    inst = small(5, jobs=8)
    with SearchServer(n_submeshes=2, devices=CPUS, workdir=tmp_path) as srv:
        rid = srv.submit(SearchRequest(
            p_times=inst.p_times, lb_kind=1, deadline_s=0.5,
            segment_iters=16, checkpoint_every=1,
            faults="delay_every=0.2", tag="budgeted", **KW))
        rec = srv.result(rid, timeout=300)
        snap = srv.status(rid)
    assert rec.state == "DEADLINE"
    assert rec.result is not None and not rec.result.complete
    assert snap["result"]["complete"] is False
    assert snap["stop_reason"] == "deadline"
    assert os.path.exists(rec.checkpoint_path)


def _strip(x):
    """A snapshot without its wall-clock keys and metric families."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items()
                if k not in WALL and k not in WALL_METRICS}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _shape(x):
    """The keys and types of a snapshot part whose values are rates and
    seconds (the capacity model's)."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_shape(v) for v in x]
    return type(x).__name__ if isinstance(x, float) else x


@pytest.mark.parametrize("kind", ["admission", "served"])
def test_snapshots_equal_jax(tmp_path, kind):
    """Request and status snapshots of both servers after the same
    scenario: `admission`, two submeshes and nothing run (queue order,
    rejections, cancel, close); `served`, three instances at LB1 and one at
    LB2 on one submesh of two workers."""
    snaps = {}
    n = 2 if kind == "admission" else 1     # one slot: a fixed dispatch
    for name, Server, Request, Rejected, devs in (
            ("jax", JServer, JRequest, JAdmissionError,
             jax.devices()[:2 * n]),
            ("torch", SearchServer, SearchRequest, AdmissionError,
             CPUS[:2 * n])):
        srv = Server(n_submeshes=n, devices=devs,
                     workdir=tmp_path / name, segment_iters=256,
                     autostart=False, health_interval_s=0,
                     resource_sample_s=0,
                     max_queue_depth=3 if kind == "admission" else 64)
        mk = lambda seed, **kw: Request(  # noqa: E731
            p_times=small(seed).p_times, **KW, **kw)
        if kind == "admission":
            rids = [srv.submit(mk(0, priority=p)) for p in (0, 2, 1)]
            with pytest.raises(Rejected, match="queue full"):
                srv.submit(mk(1))
            with pytest.raises(Rejected, match="invalid request"):
                srv.submit(mk(1, lb_kind=7))
            assert srv.cancel(rids[1]) and not srv.cancel(rids[1])
            rids.append(srv.submit(mk(2, tag="t")))
            with pytest.raises(Rejected, match="already active"):
                srv.submit(mk(3, tag="t"))
            mid = srv.status_snapshot()
            srv.close()
        else:
            rids = [srv.submit(mk(s)) for s in (0, 1, 2)]
            rids.append(srv.submit(mk(0, lb_kind=2)))
            srv.start()
            for rid in rids:
                assert srv.result(rid, timeout=300).state == "DONE"
            mid = srv.status_snapshot()
            srv.close()
        snaps[name] = (json.loads(json.dumps(mid)),
                       [json.loads(json.dumps(srv.status(r)))
                        for r in rids])
    (js, jr), (ts, tr) = snaps["jax"], snaps["torch"]
    assert _strip(tr) == _strip(jr)
    # the compile ledger: the same entries and keys (method, source and
    # the cost fields differ by design: a capture, not an XLA compile)
    assert [r["key"] for r in ts["compile_ledger"]] == [
        r["key"] for r in js["compile_ledger"]]
    assert set(js["compile_ledger"][0]) <= set(ts["compile_ledger"][0]) \
        if js["compile_ledger"] else not ts["compile_ledger"]
    assert _shape(ts.pop("capacity")) == _shape(js.pop("capacity"))
    for s in (js, ts):
        s.pop("compile_ledger")
    assert _strip(ts) == _strip(js)


def test_megabatch_one_batch_of_the_class(baselines, tmp_path,
                                          monkeypatch):
    """TTS_MEGABATCH=1: three same-class requests close as one batch on
    one submesh (size 3), each member its solo totals, then a second
    batch of the class reuses the cached batch loop."""
    monkeypatch.setenv("TTS_MEGABATCH", "1")
    with SearchServer(n_submeshes=1, devices=CPUS[:2], workdir=tmp_path,
                      segment_iters=64, autostart=False, batch_max=3,
                      batch_age_s=30.0) as srv:
        for round_ in range(2):
            seeds = (0, 1, 2) if round_ == 0 else (3, 2, 1)
            rids = [srv.submit(SearchRequest(p_times=small(s).p_times,
                                             lb_kind=1, **KW))
                    for s in seeds]
            srv.start()
            recs = [srv.result(r, timeout=300) for r in rids]
            assert [r.state for r in recs] == ["DONE"] * 3
            assert [totals(r) for r in recs] == [baselines[s] for s in seeds]
            assert len({r.batch_id for r in recs}) == 1
        snap = srv.status_snapshot()
    assert snap["megabatch"]["enabled"] and snap["megabatch"]["max"] == 3
    assert snap["metrics"]["tts_batches_formed_total"] == {
        '{reason="size"}': 2}
    assert snap["executor_cache"] == {"entries": 1, "hits": 1, "misses": 1}
    assert "/batch/3/0/1/" in snap["compile_ledger"][0]["key"]


def test_failed_dispatch_redispatched_and_journaled(baselines, tmp_path):
    """A request whose fault kills its first dispatch is redispatched to
    its solo totals; the observe-mode remediation journal holds the
    exclusion it would have made."""
    with SearchServer(n_submeshes=1, devices=CPUS[:2], workdir=tmp_path,
                      service_retry_base_s=0.01, health_interval_s=0) as srv:
        rid = srv.submit(SearchRequest(p_times=small(1).p_times, lb_kind=1,
                                       segment_iters=16,
                                       faults="kill_submesh=1:1", **KW))
        rec = srv.result(rid, timeout=300)
        snap = srv.status_snapshot()
    assert rec.state == "DONE" and totals(rec) == baselines[1]
    assert rec.dispatches == 2 and rec.failures == 1
    assert snap["counters"]["redispatches"] == 1
    acts = [(a["rule"], a["action"], a["outcome"], a["detail"])
            for a in snap["remediation"]["actions"]]
    assert acts == [("retry", "exclude_submesh", "observed",
                     {"request_id": rid, "submesh": 0})]
    assert snap["requests"][rid]["failure_log"][0]["attempt"] == 1


def test_serve_and_client_commands(tmp_path):
    """`serve --device cpu` over a spool and `client` with one 7x3
    request, in one process."""
    sp = str(tmp_path / "spool")
    out = io.StringIO()
    rc = {}

    def serve():
        rc["serve"] = cli.main(["serve", "--spool", sp, "--device", "cpu",
                                "-D", "2", "--idle-exit", "1",
                                "--status-every", "0",
                                "--workdir", str(tmp_path / "wd"),
                                "--health-interval-s", "0",
                                "--resource-sample-s", "0"])

    th = threading.Thread(target=serve)
    with contextlib.redirect_stdout(out):
        th.start()
        rc["client"] = cli.main(["client", "--spool", sp, "--size", "7",
                                 "--machines", "3", "--seed", "1", "-l",
                                 "1", "--chunk", "8", "--capacity", "4096",
                                 "--timeout", "120"])
        th.join(timeout=120)
    assert not th.is_alive() and rc == {"serve": 0, "client": 0}
    text = out.getvalue()
    res = json.loads(text[text.index("{"):text.index("\n}\n") + 2])
    # the client's payload leaves min_seed at the request default (32)
    want = jdist.search(small(1).p_times, lb_kind=1, n_devices=2, chunk=8,
                        capacity=4096)
    assert res["state"] == "DONE"
    assert (res["result"]["explored_tree"], res["result"]["explored_sol"],
            res["result"]["best"]) == (want.explored_tree,
                                       want.explored_sol, want.best)
    assert "served 1 request(s)" in text


@pytest.mark.parametrize("kw,env,item", [
    (dict(aot_cache_dir="A"), {}, "A9d"),
    ({}, {"TTS_AOT_CACHE": "A"}, "A9d")])
def test_left_out_server_parts_name_their_roadmap_item(tmp_path,
                                                      monkeypatch, kw, env,
                                                      item):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    match = f"ROADMAP {item}"
    with pytest.raises(NotImplementedError, match=match):
        SearchServer(n_submeshes=1, devices=["cpu"], autostart=False,
                     workdir=tmp_path, **kw)


@pytest.mark.parametrize("argv,line", [
    (["--http-port", "0"], "observability: http://127.0.0.1:"),
    (["--otel-endpoint", "http://127.0.0.1:9/v1/traces"],
     "otel: exported 0 span(s) at shutdown (0 total) to "
     "http://127.0.0.1:9/v1/traces"),
    (["--profile-dir", "prof"], "served 0 request(s)")])
def test_front_end_flags_start_the_server(tmp_path, argv, line):
    """`--http-port`, `--otel-endpoint` and `--profile-dir` are taken:
    `serve` on an empty spool prints the line the flag adds and exits 0,
    naming no ROADMAP item."""
    sp = str(tmp_path / "spool")
    args = ["serve", "--spool", sp, "--device", "cpu", "--idle-exit", "0.3",
            "--status-every", "0", "--workdir", str(tmp_path / "wd"),
            "--health-interval-s", "0", "--resource-sample-s", "0"]
    args += [str(tmp_path / a) if a == "prof" else a for a in argv]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    assert rc == 0, err.getvalue()
    assert line in out.getvalue() and "served 0 request(s)" in out.getvalue()
    assert "ROADMAP" not in err.getvalue()


@pytest.mark.parametrize("argv,item", [(["--aot-cache", "a"], "A9d")])
def test_left_out_flags_name_their_roadmap_item(tmp_path, argv, item):
    sp = str(tmp_path / "spool")
    args = ["serve", "--spool", sp, "--device", "cpu"] + argv
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(args)
    assert rc == 1 and f"ROADMAP {item}" in err.getvalue()
    assert not os.path.exists(sp)
