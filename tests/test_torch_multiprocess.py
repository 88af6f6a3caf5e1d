"""The port's multi-process runs (`torch.distributed`, gloo) against the
JAX package's eight-worker search.

Two processes of four CPU workers each (`tests/_torch_mp_worker.py`,
joined from the environment as `torch.distributed.run` joins them) run
the job of eight workers that the JAX package runs on the conftest's
8-device CPU mesh, on the shape of `tests/test_torch_distributed.py`
(`PFSPInstance.synthetic(8, 4, 3)`, LB1, ub=inf, where the schedule
matters): the totals and `per_device` of `distributed.search`; the
gathered stacked state after 1, 2 and 3 macro-iterations against JAX's
`fetch_state` at the same ceilings, row by row; a truncated segmented run
whose checkpoint rank 0 alone wrote, resumed by the two processes, by the
port in one process and by JAX; a one-process checkpoint resumed by the
two processes; the tuning fingerprint's process count; and `--multihost
pfsp -D 8` through the command to the golden, with one `dist` CSV row.
All exact (integer math). Each subprocess has a 120 s limit."""

import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_tree_search import problems as jproblems
from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.parallel.mesh import worker_mesh
from tpu_tree_search_torch.engine import distributed as tdist
from tpu_tree_search_torch.parallel import mesh as tmesh
from tpu_tree_search_torch.problems.pfsp import PFSPInstance
from tpu_tree_search_torch.tune import cache as tcache
from tpu_tree_search_torch.utils import csv_stats

import _torch_threads

_torch_threads.share_cores()

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = pathlib.Path(__file__).with_name("_torch_mp_worker.py")
TABLE = PFSPInstance.synthetic(jobs=8, machines=4, seed=3).p_times
KW = dict(chunk=4, balance_period=2, transfer_cap=16, min_transfer=4,
          min_seed=4, capacity=1 << 10)
_COUNTERS = ("size", "best", "tree", "sol", "evals", "iters", "sent",
             "recv", "steals", "overflow")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_pair(argv: list, cwd) -> list:
    """Run `argv` as ranks 0 and 1 of a two-process job; returns each
    rank's (returncode, stdout, stderr)."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(REPO)] + os.environ.get("PYTHONPATH", "")
                       .split(os.pathsep)))
        procs.append(subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(cwd)))
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            out.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _totals(res):
    return [res.explored_tree, res.explored_sol, res.best, res.complete]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The two-process job's reports (rank 0's and rank 1's), its output
    directory, and the JAX eight-worker result it should equal."""
    out = tmp_path_factory.mktemp("mp")
    one = out / "one.npz"
    part = tdist.search(TABLE, lb_kind=1, devices=["cpu"] * 8,
                        segment_iters=2, max_rounds=2,
                        checkpoint_path=str(one), **KW)
    assert not part.complete
    runs = _launch_pair([sys.executable, str(WORKER), str(out), str(one)],
                        REPO)
    for rc, stdout, stderr in runs:
        assert rc == 0, stderr[-4000:]
    reports = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(2)]
    want = jdist.search(TABLE, lb_kind=1, n_devices=8, **KW)
    return reports, out, want


def _same_result(got: dict, want):
    assert got["totals"] == _totals(want)
    assert sorted(got["per_device"]) == sorted(want.per_device)
    for f, v in want.per_device.items():
        np.testing.assert_array_equal(np.asarray(got["per_device"][f]),
                                      np.asarray(v), err_msg=f)


def test_two_processes_match_jax_eight_workers(job):
    reports, _, want = job
    assert want.complete and int(np.asarray(want.per_device["sent"])
                                 .sum()) > 0
    for rep in reports:
        assert rep["world"] == 2
        _same_result(rep["plain"], want)


def _jax_states(rounds):
    jp = jproblems.get("pfsp")
    drv = jdist._problem_driver(
        jp, worker_mesh(8), jp.make_tables(TABLE), TABLE, 1, KW["chunk"],
        KW["balance_period"], KW["transfer_cap"], KW["min_transfer"],
        jp.aux_dtype(TABLE), None)
    fr = jp.warmup(TABLE, 1, None, target=KW["min_seed"] * 8)
    fr.aux = jp.seed_aux(TABLE, fr.prmu, fr.depth)
    s0 = drv.seed(fr, KW["capacity"], TABLE.shape[1], fr.best)
    return [jdist.fetch_state(drv.run(s0, max_iters=k * KW["balance_period"]))
            for k in rounds]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_gathered_state_after_each_round_matches_jax(job, k):
    """Rank 0's gathered (8, ...) state after k macro-iterations against
    JAX's `fetch_state` at the same ceiling, worker by worker, row by
    row."""
    _, out, _ = job
    (want,) = _jax_states([k])
    with np.load(out / f"round{k}.npz") as z:
        got = {f: z[f] for f in z.files}
    want = {f: np.asarray(getattr(want, f)) for f in got}
    for f in _COUNTERS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for d, n in enumerate(want["size"]):
        for f in ("prmu", "depth", "aux"):
            np.testing.assert_array_equal(got[f][d, ..., :n],
                                          want[f][d, ..., :n],
                                          err_msg=f"worker {d} {f}")


def test_truncated_run_rank0_alone_wrote_and_resumes(job):
    reports, out, want = job
    assert reports[0]["trunc_writes"] >= 2
    assert reports[1]["trunc_writes"] == 0
    assert reports[1]["resume_writes"] == 0
    for rep in reports:
        assert rep["trunc"]["totals"][3] is False
        assert rep["resume"]["totals"] == _totals(want)
        # a one-process checkpoint, resumed by the two processes
        assert rep["from_one"]["totals"] == _totals(want)


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_two_process_file_resumes_in_one_process(job, reader, tmp_path):
    _, out, want = job
    ck = tmp_path / "ck.npz"
    shutil.copy(out / "mp_copy.npz", ck)
    with np.load(ck) as z:
        assert z["prmu"].shape[0] == 8
    if reader == "port":
        res = tdist.search(TABLE, lb_kind=1, devices=["cpu"] * 8,
                           checkpoint_path=str(ck), **KW)
    else:
        res = jdist.search(TABLE, lb_kind=1, n_devices=8,
                           checkpoint_path=str(ck), **KW)
    assert _totals(res) == _totals(want)


def test_fingerprint_counts_the_processes(job, tmp_path):
    """The tuning fingerprint of a two-process job holds process_count 2,
    so an entry tuned by one process is not taken by it."""
    reports, _, _ = job
    one = tcache.tuning_fingerprint(device="cpu")
    assert one["process_count"] == 1
    for rep in reports:
        assert rep["fingerprint"] == {**one, "process_count": 2}
    c = tcache.TuningCache(tmp_path, device="cpu")
    c.store(("k",), {"chunk": 64})
    assert c.load(("k",)) == {"chunk": 64}
    c.fingerprint = reports[0]["fingerprint"]
    assert c.load(("k",)) is None and c.mismatches == 1


def test_local_worker_devices_split(monkeypatch):
    """`-D` counts the job's workers: each rank takes an equal share, and a
    count that does not divide across the ranks is refused."""
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    assert tmesh.local_worker_devices(8, "cpu") == [torch.device("cpu")] * 4
    for n in (1, 3):
        with pytest.raises(ValueError, match="split evenly"):
            tmesh.local_worker_devices(n, "cpu")


def test_multihost_pfsp_command(tmp_path):
    """`python -m tpu_tree_search_torch --multihost pfsp -D 8 --device cpu`
    as two ranks: both print the golden (ta002 LB1 ub=opt: tree 30), and
    rank 0 alone appends the `dist` CSV row."""
    csv = tmp_path / "r.csv"
    runs = _launch_pair(
        [sys.executable, "-m", "tpu_tree_search_torch", "--multihost",
         "pfsp", "-i", "2", "-l", "1", "-u", "1", "-D", "8", "-m", "1",
         "--chunk", "1", "--capacity", "4096", "--device", "cpu",
         "--csv", str(csv)], REPO)
    for rc, stdout, stderr in runs:
        assert rc == 0, stderr[-4000:]
        assert "GPU B&B (8 device(s)" in stdout
        assert "Size of the explored tree: 30" in stdout
        assert "Optimal makespan: 1359" in stdout
    lines = csv.read_text().splitlines()
    assert lines[0] == csv_stats.DIST_HEADER and len(lines) == 2
    assert lines[1].startswith("2,8,0,2,1,")
