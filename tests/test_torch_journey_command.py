"""The `journey` command against the JAX package's `run_journey`.

Over a fleet directory written by the port's ledger (journal calls
scripting a restart, a takeover's `origin_rid` link, a portfolio fan-out
and a megabatch terminal), the command prints what JAX's prints and exits
as it does (2 without a directory, 1 when a tag matches nothing); after
it `torch.cuda.is_initialized()` is False. Tolerance: exact (text)."""

import argparse
import contextlib
import io

import pytest
import torch

from tpu_tree_search import cli as jcli
from tpu_tree_search_torch import cli as tcli
from tpu_tree_search_torch.service import ledger as tledger

import _torch_isolation
import _torch_threads
from _torch_journey_fleet import write_fleet

_torch_threads.share_cores()


@pytest.fixture(autouse=True)
def iso(monkeypatch):
    for k in ("TTS_LEDGER", "TTS_FLEET_DIR", "TTS_PORTFOLIO",
              "TTS_OBS_STORE", "TTS_MEGABATCH", "TTS_PROGRESS"):
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    with _torch_isolation.isolated():
        yield


def run(main_fn, args):
    out = io.StringIO()
    err = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main_fn(args)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [
    [], ["--tag", "nope"], ["--tag", "j1"], ["--json"],
    ["--tag", "pf", "--json"]])
def test_journey_command_prints_and_exits_as_jax(tmp_path, argv):
    write_fleet(tmp_path / "fleet", tledger)
    if argv:
        argv = ["--fleet-dir", str(tmp_path / "fleet")] + argv
    rc_t, out_t, err_t = run(tcli.main, ["journey"] + argv)
    ns = argparse.Namespace(ledger=[], fleet_dir=None, store=None,
                            tag=None, json=False)
    it = iter(argv)
    for flag in it:
        if flag == "--json":
            ns.json = True
        else:
            setattr(ns, flag[2:].replace("-", "_"), next(it))
    rc_j, out_j, err_j = run(jcli.run_journey, ns)
    assert (rc_t, out_t, err_t) == (rc_j, out_j, err_j)
    want_rc = 2 if not argv else (1 if "nope" in argv else 0)
    assert rc_t == want_rc
    assert not torch.cuda.is_initialized()
