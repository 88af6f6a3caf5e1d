"""Fleet failover on the port's server (`service/failover.py`, the lease,
`SearchServer.adopt_ledger`), against the JAX package's.

Mirrors `tests/test_failover.py` on the CPU, lease TTLs of 0.5-1 s and a
timeout on every wait:

- observe only (TTS_FAILOVER unset): the watchers of both packages detect
  the same expired peer, journal it alike and adopt nothing (the orphan's
  directory stays byte for byte as it was); the health layer's
  `peer_down` rule fires;
- armed: a server of either package dies mid-request without releasing
  its lease; a port server adopts its ledger after the TTL, copies its
  checkpoint, and the request ends at JAX's standalone totals with its
  lineage (`origin_rid`, `origin_owner`) and cumulative budget; the stale
  owner restarted on its ledger boots FENCED and commits nothing; the
  journey chains both rids;
- the `pause_server` drill: the owner stalls alive, a peer adopts inside
  the pause, the owner self-fences at its next commit (the request
  PREEMPTED, never FAILED), and the fleet holds exactly one terminal;
- a fleet server's checkpoint saves carry its lease epoch, and a save by
  an older epoch is refused;
- a JAX server and a port server racing `adopt_ledger` on one orphan give
  exactly one adopter.

Tolerance: exact (integer counts, epochs, JSON)."""

import threading
import types

import jax
import numpy as np
import pytest

from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.service import SearchServer as JServer
from tpu_tree_search.service import SearchRequest as JRequest
from tpu_tree_search.service.lease import LeaseLost as JLeaseLost
from tpu_tree_search_torch.obs import health as thealth
from tpu_tree_search_torch.obs import journey as tjourney
from tpu_tree_search_torch.service import SearchRequest, SearchServer
from tpu_tree_search_torch.service import lease as tlease
from tpu_tree_search_torch.service.ledger import RequestLedger
from tpu_tree_search_torch.service.lease import LeaseKeeper, LeaseLost
from tpu_tree_search_torch.service.spool import payload_from_request

import _torch_isolation
import _torch_threads
from _torch_durable import (KW, QUIET, crash, ledger_records, small,
                            strip, totals, wait_segment, wait_until)

_torch_threads.share_cores()


@pytest.fixture(autouse=True)
def iso(monkeypatch):
    for k in ("TTS_MEGABATCH", "TTS_OVERLAP", "TTS_SHARE_INCUMBENT",
              "TTS_REMEDIATE", "TTS_LEDGER", "TTS_FLEET_DIR",
              "TTS_PORTFOLIO", "TTS_FAILOVER", "TTS_OBS_STORE",
              "TTS_TUNE_CACHE", "TTS_TUNE", "TTS_PREWARM", "TTS_FAULTS",
              "TTS_PROGRESS", "TTS_CAPACITY", "TTS_LEASE_TTL_S"):
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    with _torch_isolation.isolated():
        yield


@pytest.fixture(scope="module")
def base_slow():
    """JAX's standalone two-worker totals of the request moved between
    servers."""
    got = jdist.search(small(5, jobs=8).p_times, lb_kind=1, init_ub=None,
                       n_devices=2, **KW)
    return (got.explored_tree, got.explored_sol, got.best)


def dir_bytes(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.is_file()}


def ledger_bytes(d):
    """`dir_bytes` less the lease file and the temporaries its keeper
    renews it through: what the ledger's owner committed."""
    return {k: v for k, v in dir_bytes(d).items()
            if k != "lease.json" and not k.startswith(".lease.json.")}


def orphan(a_dir, n=1):
    """A dead owner's ledger: `n` admitted requests under a lease that
    was never released, expired."""
    a_dir.mkdir(parents=True)
    keeper = LeaseKeeper(a_dir, ttl_s=0.5)
    keeper.acquire()
    led = RequestLedger(a_dir, lease=keeper)
    for i in range(n):
        led.journal("admit", rid=f"req-{i:04d}", tag=f"orph{i}", seq=i,
                    payload=payload_from_request(SearchRequest(
                        p_times=small(i).p_times, lb_kind=1, **KW)),
                    tenant="acme", spent_s=0.25)
    led.close()
    keeper._stop.set()
    keeper._thread.join(timeout=5.0)
    wait_until(lambda: tlease.read_lease(a_dir).expired(), timeout=30,
               msg="orphan lease expires")


def test_observe_only_detects_and_adopts_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("TTS_LEASE_TTL_S", "0.5")
    fleet = tmp_path / "fleet"
    orphan(fleet / "a")
    before = dir_bytes(fleet / "a")
    views = {}
    for name, Server, devs in (("torch", SearchServer, ["cpu"]),
                               ("jax", JServer, jax.devices()[:1])):
        srv = Server(n_submeshes=1, devices=devs,
                     ledger_dir=str(fleet / f"b_{name}"),
                     fleet_dir=str(fleet), autostart=False, **QUIET)
        try:
            wait_until(lambda: srv.watcher.observed >= 1, timeout=60,
                       msg="the expired peer observed")
            assert srv.watcher.takeovers == 0
            assert not any(r.request.tag == "orph0"
                           for r in srv.records.values())
            snap = srv.status_snapshot()["failover"]
            if name == "torch":
                rule = next(r for r in thealth.default_rules(
                    thealth.Thresholds()) if r.name == "peer_down")
                active, detail = rule.check(types.SimpleNamespace(
                    server=srv, snapshot=None))
                assert active and detail["peers_down"] == 1
                assert detail["epoch"] == 1 and detail["mode"] == "observe"
        finally:
            srv.close()
        down = [p for p in snap["peers"] if p["dir"].endswith("/a")]
        views[name] = dict(
            keys=sorted(snap), lease=sorted(snap["lease"]),
            mode=snap["mode"], fenced=snap["fenced"],
            adopted=snap["adopted"], counts=(snap["takeovers"],
                                             snap["observed"],
                                             snap["errors"]),
            down=strip(down), actions=strip(snap["actions"]),
            epoch=snap["lease"]["epoch"])
    assert views["torch"] == views["jax"]
    assert views["torch"]["mode"] == "observe"
    assert views["torch"]["down"] == [{
        "epoch": 1, "ttl_s": 0.5, "released": False, "expired": True}]
    assert views["torch"]["actions"] == [{"epoch": 1,
                                          "outcome": "observed"}]
    assert dir_bytes(fleet / "a") == before


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_armed_takeover_resumes_and_the_stale_owner_boots_fenced(
        base_slow, tmp_path, monkeypatch, first):
    """Owner A (`first`'s server) dies mid-request; port server B adopts
    A's ledger and finishes the request at JAX's standalone totals; A
    restarted on its ledger boots fenced."""
    monkeypatch.setenv("TTS_LEASE_TTL_S", "1.0")
    fleet = tmp_path / "fleet"
    a_dir, b_dir = fleet / "a", fleet / "b"
    Server, Request, devs = ((JServer, JRequest, jax.devices()[:2])
                             if first == "jax"
                             else (SearchServer, SearchRequest,
                                   ["cpu"] * 2))
    mk_a = dict(n_submeshes=1, devices=devs, ledger_dir=str(a_dir),
                fleet_dir=str(fleet), **QUIET)
    srv_a = Server(**mk_a)
    rid_a = srv_a.submit(Request(
        p_times=small(5, jobs=8).p_times, lb_kind=1, tag="mv1",
        segment_iters=8, checkpoint_every=1, faults="delay_every=0.1",
        tenant="acme", **KW))
    wait_segment(srv_a, rid_a, 2)
    crash(srv_a)
    spent_a = srv_a.records[rid_a].spent_prev_s
    srv_b = SearchServer(n_submeshes=1, devices=["cpu"] * 2,
                         ledger_dir=str(b_dir), fleet_dir=str(fleet),
                         failover=True, **QUIET)
    try:
        wait_until(lambda: srv_b.watcher.takeovers >= 1, timeout=60,
                   msg="B adopts A's ledger")
        with srv_b._lock:
            rec = next(r for r in srv_b.records.values()
                       if r.request.tag == "mv1")
        out = srv_b.result(rec.id, timeout=300)
        assert out.state == "DONE", (out.state, out.error)
        assert totals(out) == base_slow
        assert (rec.origin_rid, rec.origin_owner) == (rid_a, "a")
        assert rec.request.tenant == "acme" and rec.request.faults is None
        assert out.spent_s() >= spent_a - 0.01
        act = srv_b.status_snapshot()["failover"]["actions"][-1]
        assert (act["outcome"], act["epoch"], act["moved"]) == (
            "adopted", 2, 1)
        info = tlease.read_lease(a_dir)
        assert info.epoch == 2 and not info.expired()
        kinds = [r["k"] for r in ledger_records(a_dir)]
        assert kinds[-2:] == ["takeover", "forget"]
        (j,) = srv_b.journeys(tag="mv1")
        assert [(r["owner"], r["rid"]) for r in j["rids"]] == [
            ("a", rid_a), ("b", rec.id)]
        assert (j["takeovers"], j["terminals"], j["state"]) == (
            1, 1, "DONE")
        assert j["budget_monotone"]
        # the stale owner restarts while B holds its lease: fenced
        a_before = ledger_bytes(a_dir)
        srv_a2 = Server(**mk_a)
        try:
            assert srv_a2.fenced and srv_a2.ledger is None
            with pytest.raises((LeaseLost, JLeaseLost)):
                srv_a2.submit(Request(p_times=small(0).p_times, **KW))
            fo = srv_a2.status_snapshot()["failover"]
            assert fo["fenced"] and "held by" in fo["fence_reason"]
        finally:
            srv_a2.close()
        assert ledger_bytes(a_dir) == a_before
    finally:
        srv_b.close()


def test_pause_server_drill_leaves_one_terminal(base_slow, tmp_path,
                                                monkeypatch):
    monkeypatch.setenv("TTS_LEASE_TTL_S", "0.6")
    fleet = tmp_path / "fleet"
    a_dir, b_dir = fleet / "a", fleet / "b"
    srv_a = SearchServer(n_submeshes=1, devices=["cpu"] * 2,
                         ledger_dir=str(a_dir), fleet_dir=str(fleet),
                         **QUIET)
    rid_a = srv_a.submit(SearchRequest(
        p_times=small(5, jobs=8).p_times, lb_kind=1, tag="split1",
        segment_iters=8, checkpoint_every=1,
        faults="delay_every=0.1,pause_server=3:6", **KW))
    try:
        wait_until(lambda: tlease.read_lease(a_dir).expired(),
                   timeout=120, msg="A's lease expires mid-pause")
        srv_b = SearchServer(n_submeshes=1, devices=["cpu"] * 2,
                             ledger_dir=str(b_dir), fleet_dir=str(fleet),
                             failover=True, **QUIET)
        try:
            wait_until(lambda: srv_b.watcher.takeovers >= 1, timeout=60,
                       msg="B adopts mid-pause")
            wait_until(lambda: srv_a.fenced, timeout=60,
                       msg="A fences itself on waking")
            wait_until(lambda: srv_a.status(rid_a)["state"] != "RUNNING",
                       timeout=60, msg="A's slot clears")
            assert srv_a.status(rid_a)["state"] == "PREEMPTED"
            with srv_b._lock:
                rec = next(r for r in srv_b.records.values()
                           if r.request.tag == "split1")
            out = srv_b.result(rec.id, timeout=300)
            assert out.state == "DONE", (out.state, out.error)
            assert totals(out) == base_slow
            terms = {d.name: [r["rid"] for r in ledger_records(d)
                              if r["k"] == "terminal"]
                     for d in (a_dir, b_dir)}
            assert terms == {"a": [], "b": [rec.id]}
            led = RequestLedger(a_dir)
            assert (led.state.epoch, led.state.fenced_discards) == (2, 0)
            assert rid_a not in led.state.requests
            led.close()
            js = tjourney.find_journeys(fleet_dir=fleet, tag="split1")
            assert [j["terminals"] for j in js] == [1]
        finally:
            srv_b.close()
    finally:
        srv_a.close()


def test_checkpoint_saves_carry_the_lease_epoch(tmp_path, monkeypatch):
    """Every save of a fleet server's request carries `meta_lease_epoch`
    (its epoch), and a save by an older epoch is refused."""
    from tpu_tree_search_torch.engine import checkpoint

    monkeypatch.setenv("TTS_LEASE_TTL_S", "1.0")
    fleet = tmp_path / "fleet"
    srv = SearchServer(n_submeshes=1, devices=["cpu"] * 2,
                       ledger_dir=str(fleet / "a"), fleet_dir=str(fleet),
                       **QUIET)
    try:
        rid = srv.submit(SearchRequest(
            p_times=small(5, jobs=8).p_times, lb_kind=1, tag="ep1",
            segment_iters=8, checkpoint_every=1, faults="delay_every=0.1",
            **KW))
        wait_segment(srv, rid, 2)
        # parked, so no save of its own rotates the file under the reads
        assert srv.preempt(rid, hold=True)
        wait_until(lambda: srv.status(rid)["state"] == "PREEMPTED",
                   timeout=120, msg="the request parks")
        path = srv.records[rid].checkpoint_path
        with np.load(path) as z:
            assert int(z["meta_lease_epoch"]) == srv.lease.epoch == 1
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        arrays["meta_lease_epoch"] = np.asarray(0)
        with pytest.raises(checkpoint.StaleCheckpointError):
            checkpoint._write_snapshot(path, arrays)
    finally:
        srv.close()


def test_racing_adopters_have_one_winner(tmp_path, monkeypatch):
    """A JAX server and a port server adopt one expired orphan at once:
    one adopts (the request moves to it), the other loses the race."""
    monkeypatch.setenv("TTS_LEASE_TTL_S", "0.5")
    fleet = tmp_path / "fleet"
    orphan(fleet / "a", n=2)
    srvs = [JServer(n_submeshes=1, devices=jax.devices()[:1],
                    ledger_dir=str(fleet / "b1"), autostart=False, **QUIET),
            SearchServer(n_submeshes=1, devices=["cpu"],
                         ledger_dir=str(fleet / "b2"), autostart=False,
                         **QUIET)]
    gate = threading.Barrier(2)
    res = [None, None]

    def adopt(i):
        gate.wait(timeout=10)
        res[i] = srvs[i].adopt_ledger(str(fleet / "a"), current_epoch=1)

    threads = [threading.Thread(target=adopt, args=(i,)) for i in (0, 1)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        outcomes = [r["outcome"] for r in res]
        assert sorted(outcomes) == ["adopted", "lost_race"]
        win = outcomes.index("adopted")
        assert res[win]["moved"] == 2 and res[win]["epoch"] == 2
        tags = [sorted(r.request.tag for r in s.records.values())
                for s in srvs]
        assert tags[win] == ["orph0", "orph1"] and tags[1 - win] == []
        origins = sorted(r.origin_rid for r in srvs[win].records.values())
        assert origins == ["req-0000", "req-0001"]
    finally:
        for s in srvs:
            s.close()
