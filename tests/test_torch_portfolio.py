"""Bound-portfolio racing on the port's server (`service/portfolio.py`,
`SearchServer._submit_portfolio`), against the JAX package's.

Mirrors `tests/test_portfolio.py` on the CPU (`plan_members` alone is
test_torch_portfolio_plan.py's):

- a race on one submesh with megabatch off: both servers pick the same
  winner, end the members in the same states, give the winner's
  `(tree, sol, best)` and journal the same ledger records (the
  `portfolio` record included; wall-clock keys left out); no member is
  dispatched after the proof;
- a race admitted, then the server dead before it ran, replays on the
  next boot to the optimum and serves the recorded winner after;
- with `portfolio` off the path is exactly the one without portfolio;
  TTS_PORTFOLIO fans requests out and TTS_PORTFOLIO_MAX caps K;
- `client --portfolio K` races through `serve`.

Tolerance: exact (integer counts, JSON)."""

import contextlib
import io
import json
import threading

import jax
import pytest

from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.service import SearchRequest as JRequest
from tpu_tree_search.service import SearchServer as JServer
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.obs import tracelog as ttracelog
from tpu_tree_search_torch.service import SearchRequest, SearchServer

import _torch_isolation
import _torch_threads
from _torch_durable import (KW, QUIET, crash, ledger_records, small,
                            strip, totals)

_torch_threads.share_cores()


@pytest.fixture(autouse=True)
def iso(monkeypatch):
    for k in ("TTS_MEGABATCH", "TTS_OVERLAP", "TTS_SHARE_INCUMBENT",
              "TTS_REMEDIATE", "TTS_LEDGER", "TTS_FLEET_DIR",
              "TTS_PORTFOLIO", "TTS_PORTFOLIO_MAX", "TTS_FAILOVER",
              "TTS_OBS_STORE", "TTS_TUNE_CACHE", "TTS_TUNE", "TTS_PREWARM",
              "TTS_FAULTS", "TTS_PROGRESS", "TTS_CAPACITY"):
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    with _torch_isolation.isolated():
        yield


@pytest.fixture(scope="module")
def base2():
    out = {}
    for seed, jobs in ((0, 7), (1, 7), (3, 8)):
        got = jdist.search(small(seed, jobs).p_times, lb_kind=1,
                           init_ub=None, n_devices=2, **KW)
        out[seed] = (got.explored_tree, got.explored_sol, got.best)
    return out


def test_race_on_one_submesh_equals_jax(base2, tmp_path):
    got = {}
    for name, Server, Request, devs in (
            ("jax", JServer, JRequest, jax.devices()[:2]),
            ("torch", SearchServer, SearchRequest, ["cpu"] * 2)):
        ld = tmp_path / name / "led"
        srv = Server(n_submeshes=1, devices=devs, workdir=tmp_path / name /
                     "wd", ledger_dir=str(ld), autostart=False,
                     share_incumbent=True, **QUIET)
        try:
            rid = srv.submit(Request(p_times=small(1).p_times, lb_kind=1,
                                     portfolio=3, tag="race", **KW))
            srv.start()
            rec = srv.result(rid, timeout=300)
            members = list(rec.portfolio_members)
            mrecs = [srv.result(m, timeout=120) for m in members]
            snap = srv.status_snapshot()
            # before close(): close marks whatever record its slot still
            # lists (the winner, until its executor clears the slot) with
            # a "shutdown" stop reason
            views = [strip(x.snapshot()) for x in [rec] + mrecs]
        finally:
            srv.close()
        got[name] = dict(
            parent=views[0],
            winner=members.index(rec.portfolio_winner),
            states=[m.state for m in mrecs],
            members=views[1:],
            totals=totals(rec), portfolio=snap["portfolio"],
            records=strip([r for r in ledger_records(ld)
                           if r["k"] != "budget"]))
    for key in got["jax"]:
        assert got["torch"][key] == got["jax"][key], key
    race = got["torch"]
    assert race["winner"] == 0
    assert race["states"] == ["DONE", "CANCELLED", "CANCELLED"]
    assert race["totals"] == base2[1]
    assert race["portfolio"] == {"parents": 1, "active": 0, "won": 1,
                                 "cancelled_members": 2}
    pf = [r for r in race["records"] if r["k"] == "portfolio"]
    assert [[m["config"]["lb_kind"] for m in r["members"]]
            for r in pf] == [[1, 0, 2]]
    # no member dispatch after the proof (the port's flight recorder)
    recs = ttracelog.get().records()
    win = next(r["seq"] for r in recs if r["name"] == "portfolio.win")
    assert not [r for r in recs if r["name"] == "request.dispatch"
                and r["seq"] > win]


def test_race_replays_across_restart(tmp_path):
    inst = small(3, jobs=8)
    opt = jdist.search(inst.p_times, lb_kind=1, init_ub=None,
                       n_devices=2, **KW).best
    mk = dict(n_submeshes=2, devices=["cpu"] * 4, workdir=tmp_path / "wd",
              ledger_dir=str(tmp_path / "led"), share_incumbent=True,
              **QUIET)
    srv = SearchServer(autostart=False, **mk)
    rid = srv.submit(SearchRequest(p_times=inst.p_times, lb_kind=1,
                                   portfolio=3, tag="race", **KW))
    members = list(srv.records[rid].portfolio_members)
    crash(srv)
    srv2 = SearchServer(**mk)
    try:
        rec = srv2.records[rid]
        assert rec.portfolio_members == members
        assert rid in srv2.portfolio.races
        out = srv2.result(rid, timeout=300)
        assert out.state == "DONE" and int(out.result.best) == int(opt)
        winner = out.portfolio_winner
        for m in members:
            srv2.result(m, timeout=120)
    finally:
        srv2.close()
    srv3 = SearchServer(**mk)
    try:
        rec3 = srv3.records[rid]
        assert rec3.state == "DONE" and int(rec3.result.best) == int(opt)
        assert rec3.portfolio_winner == winner
        assert rec3.portfolio_config is not None
        assert srv3.submit(SearchRequest(p_times=inst.p_times, lb_kind=1,
                                         portfolio=3, tag="race",
                                         **KW)) == rid
    finally:
        srv3.close()


def test_portfolio_off_is_the_path_without_it(base2, tmp_path):
    srv = SearchServer(n_submeshes=2, devices=["cpu"] * 4,
                       workdir=tmp_path / "wd",
                       ledger_dir=str(tmp_path / "led"), **QUIET)
    try:
        rid = srv.submit(SearchRequest(p_times=small(0).p_times,
                                       lb_kind=1, **KW))
        rec = srv.result(rid, timeout=300)
        assert rec.state == "DONE" and totals(rec) == base2[0]
        assert rec.portfolio_members is None
        assert rec.portfolio_parent is None
        assert "portfolio" not in rec.snapshot()
        assert srv.portfolio.races == {}
        assert srv.status_snapshot()["portfolio"] is None
    finally:
        srv.close()
    assert not [r for r in ttracelog.get().records()
                if r["name"].startswith("portfolio.")]
    assert not [r for r in ledger_records(tmp_path / "led")
                if r["k"] == "portfolio"]


def test_env_default_fans_out_and_max_caps(monkeypatch, base2):
    monkeypatch.setenv("TTS_PORTFOLIO", "5")
    monkeypatch.setenv("TTS_PORTFOLIO_MAX", "2")
    srv = SearchServer(n_submeshes=2, devices=["cpu"] * 4,
                       share_incumbent=True, **QUIET)
    try:
        rid = srv.submit(SearchRequest(p_times=small(1).p_times,
                                       lb_kind=1, **KW))
        rec = srv.result(rid, timeout=300)
        assert rec.state == "DONE"
        assert int(rec.result.best) == base2[1][2]
        assert len(rec.portfolio_members) == 2
        assert rec.request.portfolio == 2
        for m in rec.portfolio_members:
            assert srv.records[m].portfolio_members is None
    finally:
        srv.close()


def test_client_portfolio_races_through_serve(tmp_path, base2):
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
                                 "--portfolio", "2", "--timeout", "120"])
        th.join(timeout=120)
    assert not th.is_alive() and rc == {"serve": 0, "client": 0}
    text = out.getvalue()
    res = json.loads(text[text.index("{"):text.index("\n}\n") + 2])
    assert res["state"] == "DONE"
    assert res["portfolio"]["k"] == 2
    assert res["portfolio"]["winner"] in res["portfolio"]["members"]
    assert res["result"]["best"] == base2[1][2]
