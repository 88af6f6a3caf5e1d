"""Request journeys (`obs/journey.py`, the `journey` command) against the
JAX package's.

Over the same ledger and fleet directories, written by either package
(journal calls scripting a restart, a takeover's `origin_rid` link, a
portfolio fan-out and a megabatch terminal, plus the ledgers a real port
server writes for a race), the port's `find_journeys`, `to_json` and
`render_journey` equal JAX's, with and without a flight-recorder store.
The `journey` command is test_torch_journey_command.py's. Tolerance:
exact (JSON and text)."""

import pytest

from tpu_tree_search.obs import journey as jjourney
from tpu_tree_search.service import ledger as jledger
from tpu_tree_search_torch.obs import journey as tjourney
from tpu_tree_search_torch.obs import store as tstore
from tpu_tree_search_torch.service import SearchRequest, SearchServer
from tpu_tree_search_torch.service import ledger as tledger

import _torch_isolation
import _torch_threads
from _torch_durable import KW, QUIET, small
from _torch_journey_fleet import write_fleet

_torch_threads.share_cores()

LEDGERS = {"jax": jledger, "torch": tledger}


@pytest.fixture(autouse=True)
def iso(monkeypatch):
    for k in ("TTS_LEDGER", "TTS_FLEET_DIR", "TTS_PORTFOLIO",
              "TTS_OBS_STORE", "TTS_MEGABATCH", "TTS_PROGRESS"):
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    with _torch_isolation.isolated():
        yield


def both(**kw):
    out = {}
    for name, mod in (("jax", jjourney), ("torch", tjourney)):
        js = mod.find_journeys(**kw)
        out[name] = (mod.to_json(js), [mod.render_journey(j) for j in js])
    return out


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("with_store", [False, True])
def test_journeys_equal_jax(tmp_path, writer, with_store):
    fleet = tmp_path / "fleet"
    write_fleet(fleet, LEDGERS[writer])
    kw = {}
    if with_store:
        st = tstore.ObsStore(tmp_path / "store", "w1")
        st.append("event", name="failover.adopted", orphan_id="req-0000")
        st.append("event", name="alert.firing", tag="j1")
        st.append("event", name="unrelated", request_id="req-9999")
        st.flush()
        st.close()
        kw["store"] = str(tmp_path / "store")
    for query in (dict(fleet_dir=fleet), dict(fleet_dir=fleet, tag="j1"),
                  dict(ledger_dirs=[fleet / "b"], tag="pf"),
                  dict(ledger_dirs=[fleet / "a", fleet / "b"],
                       tag="req-0005")):
        got = both(**query, **kw)
        assert got["torch"] == got["jax"], query
    (j,) = tjourney.find_journeys(fleet_dir=fleet, tag="j1", **kw)
    assert [(r["owner"], r["rid"]) for r in j["rids"]] == [
        ("a", "req-0000"), ("b", "req-0003")]
    assert (j["admits"], j["takeovers"], j["terminals"], j["state"]) == (
        1, 1, 1, "DONE")
    assert j["budget_monotone"] and j["spent_s"] == 4.0
    assert [(lt["owner"], lt["lifetime"]) for lt in j["lifetimes"]] == [
        ("a", 1), ("a", 2), ("b", 1)]
    assert j["batches"] == ["batch-0001"]
    if with_store:
        assert [e["name"] for e in j["store_events"]] == [
            "failover.adopted", "alert.firing"]


def test_journeys_of_a_real_race_equal_jax(tmp_path):
    """The ledger a port server writes for a portfolio race and a plain
    request, read by both packages."""
    led = tmp_path / "led"
    srv = SearchServer(n_submeshes=1, devices=["cpu"] * 2, ledger_dir=str(
        led), share_incumbent=True, **QUIET)
    try:
        for req in (SearchRequest(p_times=small(1).p_times, lb_kind=1,
                                  portfolio=2, tag="race", **KW),
                    SearchRequest(p_times=small(0).p_times, lb_kind=1,
                                  tag="solo", **KW)):
            assert srv.result(srv.submit(req), timeout=300).state == "DONE"
        mine = srv.journeys()
    finally:
        srv.close()
    for tag in (None, "race", "solo", "race.pf1"):
        got = both(ledger_dirs=[led], tag=tag)
        assert got["torch"] == got["jax"], tag
    assert len(mine) >= 2
    (race,) = tjourney.find_journeys(ledger_dirs=[led], tag="race")
    assert race["state"] == "DONE" and race["portfolio"]["k"] == 2
