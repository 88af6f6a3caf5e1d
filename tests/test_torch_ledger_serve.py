"""The `serve` command and the spool on a request ledger, in the port.

Mirrors the restart half of `tests/test_ledger.py` on the CPU (port
servers on `["cpu"] * 2` workers, `KW = dict(chunk=8, capacity=1 << 12,
min_seed=4)`, `PFSPInstance.synthetic` tables, totals held to the JAX
package's standalone two-worker search):

- spool requests reconnect after a restart;
- a true crash: `serve --device cpu --ledger L` killed by
  `TTS_FAULTS=kill_server=2` (exit 137), started again on L, the request
  at its golden, and `journey --ledger L --tag T` shows one journey over
  two lifetimes with a monotone `spent_s`;
- `serve --ledger --fleet-dir` prints JAX's ledger and failover lines,
  and on a ledger a live peer holds boots fenced and exits 0.

Tolerance: exact (integer counts, JSON records)."""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.service import SearchServer
from tpu_tree_search_torch.service import spool as tspool
from tpu_tree_search_torch.service.lease import LeaseKeeper

import _torch_isolation
import _torch_threads
from _torch_durable import KW, QUIET, crash, small

_torch_threads.share_cores()

ROOT = pathlib.Path(__file__).resolve().parents[1]


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


@pytest.fixture(scope="module")
def base2():
    """JAX's standalone two-worker totals of the instances served here."""
    out = {}
    for seed, jobs in ((0, 7), (5, 8)):
        got = jdist.search(small(seed, jobs).p_times, lb_kind=1,
                           init_ub=None, n_devices=2, **KW)
        out[seed] = (got.explored_tree, got.explored_sol, got.best)
    return out


def test_spool_requests_reconnect_after_restart(base2, tmp_path):
    sp = tmp_path / "spool"
    sid = tspool.submit_file(sp, {"p_times": small(0).p_times.tolist(),
                                  "lb": 1, "tag": "sp1", **KW})
    mk = dict(n_submeshes=1, devices=["cpu"] * 2, workdir=tmp_path / "wd",
              ledger_dir=str(tmp_path / "led"), **QUIET)
    srv = SearchServer(autostart=False, **mk)
    payload = json.loads((sp / f"{sid}{tspool.REQ_SUFFIX}").read_text())
    srv.submit(tspool.request_from_payload(payload), spool_id=sid)
    crash(srv)
    srv2 = SearchServer(**mk)
    try:
        assert sid in srv2.replayed_spool
        lines = []
        served = tspool.serve_spool(srv2, sp, idle_exit_s=2.0, poll_s=0.05,
                                    emit=lines.append)
        assert served == 1 and json.loads(lines[0]) == {
            "spool_reconnected": 1}
        res = json.loads((sp / f"{sid}{tspool.RES_SUFFIX}").read_text())
        assert res["state"] == "DONE"
        assert (res["result"]["explored_tree"], res["result"]["explored_sol"],
                res["result"]["best"]) == base2[0]
    finally:
        srv2.close()


def serve_proc(tmp_path, ledger, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("TTS_FAULTS", None)
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "-m", "tpu_tree_search_torch", "serve", "--spool",
         str(tmp_path / "spool"), "--device", "cpu", "-D", "2",
         "--ledger", str(ledger), "--idle-exit", "2", "--status-every",
         "0", "--health-interval-s", "0", "--resource-sample-s", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def test_true_crash_restart_and_journey(base2, tmp_path):
    led = tmp_path / "led"
    sid = tspool.submit_file(tmp_path / "spool", {
        "p_times": small(5, jobs=8).p_times.tolist(), "lb": 1,
        "tag": "crash1", "segment_iters": 8, "checkpoint_every": 1, **KW})
    first = serve_proc(tmp_path, led, {"TTS_FAULTS": "kill_server=2"})
    assert first.returncode == 137, first.stdout + first.stderr
    assert not (tmp_path / "spool" / f"{sid}.res.json").exists()
    second = serve_proc(tmp_path, led)
    assert second.returncode == 0, second.stdout + second.stderr
    assert "ledger: " in second.stdout and "restart #1" in second.stdout
    assert '{"spool_reconnected": 1}' in second.stdout
    res = json.loads((tmp_path / "spool" / f"{sid}.res.json").read_text())
    assert res["state"] == "DONE"
    assert (res["result"]["explored_tree"], res["result"]["explored_sol"],
            res["result"]["best"]) == base2[5]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["journey", "--ledger", str(led), "--tag", "crash1",
                       "--json"])
    assert rc == 0 and not torch.cuda.is_initialized()
    (j,) = json.loads(out.getvalue())["journeys"]
    assert (j["state"], j["admits"], j["terminals"]) == ("DONE", 1, 1)
    assert j["budget_monotone"] and j["dispatches"] == 2
    assert [lt["lifetime"] for lt in j["lifetimes"]] == [1, 2]


def test_serve_banners_and_a_fenced_boot_exit_clean(tmp_path, monkeypatch):
    """`serve --ledger --fleet-dir` prints JAX's ledger and failover lines;
    on a ledger whose lease a live peer holds it boots FENCED, commits
    nothing and exits 0."""
    fleet = tmp_path / "fleet"
    mine, held = fleet / "a", fleet / "b"
    held.mkdir(parents=True)
    keeper = LeaseKeeper(held, ttl_s=30.0)
    keeper.acquire()
    monkeypatch.setenv("TTS_LEASE_TTL_S", "30")
    text = {}
    try:
        for name, ledger in (("mine", mine), ("held", held)):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["serve", "--spool", str(tmp_path / "sp"),
                               "--device", "cpu", "--ledger", str(ledger),
                               "--fleet-dir", str(fleet), "--idle-exit",
                               "0.5", "--status-every", "0",
                               "--health-interval-s", "0",
                               "--resource-sample-s", "0"])
            assert rc == 0, out.getvalue()
            text[name] = out.getvalue()
    finally:
        keeper._stop.set()
    assert (f"ledger: {mine} (restart #0, replayed 0 record(s), recovered "
            "0q/0a/0h/0t, truncated 0)") in text["mine"]
    assert ("failover: observe-mode, lease epoch 1, ttl 30s "
            "(TTS_FLEET_DIR/TTS_FAILOVER)") in text["mine"]
    assert "failover: FENCED-mode, lease epoch -" in text["held"]
    assert "exited without commits" in text["held"]
    assert "ledger: " not in text["held"]
    assert not list(held.glob("seg-*.jsonl"))
