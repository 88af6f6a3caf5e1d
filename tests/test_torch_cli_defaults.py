"""The `-D` defaults and long flags of the port's CLI against the JAX
CLI's, and the route a bare `pfsp` takes.

Both packages' `pfsp`, `nqueens` and `solve` parsers give the same `-D`
default (0, every device, for `pfsp` and `nqueens`; 1 for `solve`), and
`pfsp` takes `--inst`, `--lb` and `--ub` as JAX's does. With no `-D`,
`pfsp --device cpu` runs the single-device search, and on a one-card host
the same call as `-D 1` (`device.search` on the same device); on a
four-card host it runs the multi-worker search on the four cards."""

import argparse
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_tree_search import cli as jcli
from tpu_tree_search_torch import cli as tcli
from tpu_tree_search_torch.engine import device as tdevice
from tpu_tree_search_torch.engine import distributed as tdist

ROOT = Path(__file__).resolve().parents[1]


def jax_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    jcli._pfsp_parser(sub)
    jcli._nq_parser(sub)
    jcli._solve_parser(sub)
    return ap


@pytest.mark.parametrize("argv", [["pfsp"], ["nqueens"], ["solve"],
                                  ["pfsp", "-D", "3"], ["nqueens", "-D", "2"]])
def test_worker_defaults_match_jax(argv):
    want = jax_parser().parse_args(argv).D
    got = tcli.build_parser().parse_args(argv).D
    assert got == want
    assert got == {"pfsp": 0, "nqueens": 0, "solve": 1}[argv[0]] \
        or "-D" in argv


@pytest.mark.parametrize("argv", [
    ["pfsp", "--inst", "3", "--lb", "2", "--ub", "0"],
    ["pfsp", "-i", "3", "-l", "2", "-u", "0"],
    ["pfsp", "--inst", "21", "-l", "0", "--ub", "1"]])
def test_pfsp_long_flags_match_jax(argv):
    j = jax_parser().parse_args(argv)
    t = tcli.build_parser().parse_args(argv)
    assert (t.inst, t.lb, t.ub) == (j.inst, j.lb, j.ub)


def test_bare_pfsp_on_the_cpu_is_single_worker():
    out = subprocess.run(
        [sys.executable, "-m", "tpu_tree_search_torch", "pfsp", "-i", "2",
         "-l", "1", "-u", "1", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "GPU B&B (1 device(s) - cpu)" in out.stdout
    assert "Size of the explored tree: 30" in out.stdout


def route(monkeypatch, cards: int, argv: list) -> list:
    """The search calls a `pfsp` command line makes on a host with
    `cards` cards (torch.cuda's answers faked, the searches stubbed)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)

    class Res:
        explored_tree, explored_sol, best, complete = 1, 0, 1278, True
        telemetry, evals, iters = None, 0, 0
        per_device = {"tree": [1]}

    def one(p, **kw):
        calls.append(("device.search", str(kw["device"])))
        return Res()

    def many(p, **kw):
        calls.append(("distributed.search",
                      [str(d) for d in kw["devices"]]))
        return Res()

    monkeypatch.setattr(tdevice, "search", one)
    monkeypatch.setattr(tdist, "search", many)
    assert tcli.main(argv) == 0
    return calls


def test_bare_pfsp_on_one_card_is_d1(monkeypatch, capsys):
    base = ["pfsp", "-i", "1", "-l", "1", "-u", "1"]
    bare = route(monkeypatch, 1, base)
    d1 = route(monkeypatch, 1, base + ["-D", "1"])
    assert bare == d1 == [("device.search", "cuda")]
    four = route(monkeypatch, 4, base)
    assert four == [("distributed.search",
                     ["cuda:0", "cuda:1", "cuda:2", "cuda:3"])]
    assert "GPU B&B (1 device(s) - cuda)" in capsys.readouterr().out
