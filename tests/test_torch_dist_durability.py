"""Durability of the port's multi-worker search, against the JAX package.

Mirrors `tests/test_dist_durability.py` with the port's workers on
`[cpu] * D` and the JAX package on the conftest's CPU mesh: an overflow
grows every pool and resumes losslessly (N-Queens, whose counts do not
depend on the order of exploration, and PFSP with ub=inf, equal to the
JAX run worker by worker); a segmented run with a stacked checkpoint
resumes to the uninterrupted totals, also on fewer workers (elastic);
the two packages write the same stacked checkpoint file and each resumes
the other's; a checkpoint of one problem is refused by another; and the
`pfsp -D` command's segmented run prints per-worker heartbeat lines and
resumes. All exact (integer math)."""

import contextlib
import io

import numpy as np
import pytest

from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search_torch import cli, service as tsvc, tune as ttune
from tpu_tree_search_torch.engine import checkpoint as tckpt
from tpu_tree_search_torch.engine import distributed as tdist
from tpu_tree_search_torch.engine import incumbent as tinc
from tpu_tree_search_torch.engine import megabatch as tmb
from tpu_tree_search_torch.engine import sequential as tseq
from tpu_tree_search_torch.problems import nqueens as tnq
from tpu_tree_search_torch.problems.pfsp import PFSPInstance


import _torch_threads

_torch_threads.share_cores()


def _counting_grow(monkeypatch):
    calls = []
    orig = tckpt.grow

    def counting(state, new_capacity):
        calls.append(new_capacity)
        return orig(state, new_capacity)

    monkeypatch.setattr(tckpt, "grow", counting)
    return calls


def _same_result(got, want):
    assert (got.explored_tree, got.explored_sol, got.best, got.complete) \
        == (want.explored_tree, want.explored_sol, want.best, want.complete)
    for f, v in want.per_device.items():
        np.testing.assert_array_equal(got.per_device[f], np.asarray(v),
                                      err_msg=f)


def test_dist_overflow_grows_and_resumes_losslessly(monkeypatch):
    """Balancing off and a warm-up stripe near the limit: the pools must
    overflow mid-run, and growth loses and doubles no node (N-Queens
    counts do not depend on the order of exploration)."""
    kw = dict(chunk=8, min_seed=170, min_transfer=10**6)
    calls = _counting_grow(monkeypatch)
    small = tnq.search_distributed(9, capacity=1 << 8, devices=["cpu"] * 2,
                                   **kw)
    assert calls, "the small pool never overflowed"
    big = tnq.search_distributed(9, capacity=1 << 15, devices=["cpu"] * 2,
                                 **kw)
    assert (small.explored_tree, small.explored_sol) == \
        (big.explored_tree, big.explored_sol) == (8393, 352)


def test_dist_pfsp_overflow_grow_matches_jax(monkeypatch):
    """PFSP at ub=inf through the grow path: complete, optimal, and every
    worker's counters equal to the JAX run that grows the same way."""
    inst = PFSPInstance.synthetic(jobs=11, machines=4, seed=11)
    kw = dict(lb_kind=0, init_ub=None, chunk=8, transfer_cap=8, min_seed=8,
              capacity=1 << 8)
    want = jdist.search(inst.p_times, **kw)
    calls = _counting_grow(monkeypatch)
    got = tdist.search(inst.p_times, devices=["cpu"] * 8, **kw)
    assert calls, "the small pool never overflowed"
    assert got.complete
    _same_result(got, want)


def test_dist_segmented_checkpoint_resume(tmp_path):
    """A checkpointed truncated run, resumed to the end, gives the
    uninterrupted totals; the heartbeat carries per-worker fields."""
    inst = PFSPInstance.synthetic(jobs=9, machines=4, seed=7)
    kw = dict(lb_kind=1, init_ub=None, chunk=4, capacity=1 << 12,
              min_seed=8, devices=["cpu"] * 8)
    full = tdist.search(inst.p_times, **kw)
    ckpt = tmp_path / "dist.npz"
    part = tdist.search(inst.p_times, **kw, segment_iters=3,
                        checkpoint_path=str(ckpt), max_rounds=6)
    assert ckpt.exists() and not part.complete
    reports = []
    res = tdist.search(inst.p_times, **kw, segment_iters=64,
                       checkpoint_path=str(ckpt), heartbeat=reports.append)
    assert res.complete
    assert (res.explored_tree, res.explored_sol, res.best) == \
        (full.explored_tree, full.explored_sol, full.best)
    assert reports and reports[0].per_worker is not None
    assert len(reports[0].per_worker["size"]) == 8
    assert len(reports[0].per_worker["steals"]) == 8


def test_dist_checkpoint_elastic_resume_fewer_workers(tmp_path):
    """An 8-worker checkpoint resumes on 2 workers (the pools are
    concatenated and water-filled) and reaches the oracle's totals."""
    inst = PFSPInstance.synthetic(jobs=8, machines=4, seed=7)
    opt = inst.brute_force_optimum()
    want = tseq.pfsp_search(inst, lb=1, init_ub=opt)
    ckpt = tmp_path / "dist8.npz"
    kw = dict(lb_kind=1, init_ub=opt, chunk=4, capacity=1 << 12, min_seed=8)
    part = tdist.search(inst.p_times, devices=["cpu"] * 8, segment_iters=2,
                        checkpoint_path=str(ckpt), max_rounds=2, **kw)
    assert ckpt.exists() and not part.complete
    with pytest.warns(RuntimeWarning, match="resharding"):
        res = tdist.search(inst.p_times, devices=["cpu"] * 2,
                           checkpoint_path=str(ckpt), **kw)
    assert res.complete
    assert (res.explored_tree, res.explored_sol, res.best) == \
        (want.explored_tree, want.explored_sol, want.best)


# ------------------------------------------------- across the packages

CROSS = dict(lb_kind=2, init_ub=None, chunk=4, capacity=1 << 12,
             min_seed=4, segment_iters=2, max_rounds=4)


@pytest.fixture(scope="module")
def jax_partial(tmp_path_factory):
    """JAX's 8-worker checkpoint after 4 rounds, its file's arrays, and
    the JAX run to the end."""
    table = PFSPInstance.synthetic(jobs=8, machines=4, seed=9).p_times
    path = tmp_path_factory.mktemp("jax") / "j.npz"
    jdist.search(table, checkpoint_path=str(path), **CROSS)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    end = {**CROSS, "max_rounds": None}
    full = jdist.search(table, **{k: v for k, v in end.items()
                                  if k != "segment_iters"})
    return table, path, arrays, full


def test_stacked_checkpoint_file_equals_jax(jax_partial, tmp_path):
    table, _, want, _ = jax_partial
    path = tmp_path / "t.npz"
    tdist.search(table, devices=["cpu"] * 8, checkpoint_path=str(path),
                 **CROSS)
    with np.load(path) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert got[k].dtype == v.dtype, k


@pytest.mark.parametrize("workers", [8, 4])
def test_port_resumes_jax_stacked_checkpoint(jax_partial, tmp_path,
                                             workers):
    """The JAX 8-worker checkpoint resumed by the port on 8 workers gives
    the JAX uninterrupted run; on 4 (elastic) it gives what the JAX
    package gives resuming the same file on 4 devices (at ub=inf the
    totals depend on the schedule, so on the worker count)."""
    table, path, _, full = jax_partial
    end = {**CROSS, "max_rounds": None, "segment_iters": 64}
    if workers != 8:
        theirs = tmp_path / "jax_copy.npz"
        theirs.write_bytes(path.read_bytes())
        with pytest.warns(RuntimeWarning, match="resharding"):
            full = jdist.search(table, n_devices=workers,
                                checkpoint_path=str(theirs), **end)
    mine = tmp_path / "j.npz"
    mine.write_bytes(path.read_bytes())
    with (pytest.warns(RuntimeWarning, match="resharding") if workers != 8
          else contextlib.nullcontext()):
        res = tdist.search(table, devices=["cpu"] * workers,
                           checkpoint_path=str(mine), **end)
    assert res.complete
    _same_result(res, full)


def test_jax_resumes_port_stacked_checkpoint(jax_partial, tmp_path):
    table, _, _, full = jax_partial
    path = tmp_path / "t.npz"
    tdist.search(table, devices=["cpu"] * 8, checkpoint_path=str(path),
                 **CROSS)
    end = {**CROSS, "max_rounds": None, "segment_iters": 64}
    res = jdist.search(table, checkpoint_path=str(path), **end)
    assert (res.explored_tree, res.explored_sol, res.best, res.complete) \
        == (full.explored_tree, full.explored_sol, full.best, True)


def test_cross_problem_resume_refused(tmp_path):
    path = str(tmp_path / "ck.npz")
    tdist.search(tnq.table(6), problem="nqueens", devices=["cpu"] * 2,
                 lb_kind=0, chunk=8, capacity=1 << 14, min_seed=4,
                 segment_iters=4, checkpoint_path=path,
                 should_stop=lambda rep: True)
    with pytest.raises(ValueError, match="written by problem 'nqueens'"):
        tdist.search(PFSPInstance.synthetic(7, 3, 0).p_times,
                     devices=["cpu"] * 2, lb_kind=1, chunk=8,
                     capacity=1 << 14, min_seed=4, segment_iters=4,
                     checkpoint_path=path)


# the cases below were refused naming their ROADMAP item until it was
# ported, and now run: the ladder, the tuner, the incumbent board,
# chunk=None and balance_period=None (A6), the executor cache of search and
# of serve_batch (A9), overlap (A5b); a real `Autotuner` without a cache
# directory resolves the open chunk to the defaults, overlap without
# segments runs the one unsegmented loop, and a search or batch through the
# executor cache equals the run without it


@pytest.mark.parametrize("kw,item", [
    (dict(ladder=True, chunk=256, segment_iters=4), "A6"),
    (dict(tuner=ttune.Autotuner(device="cpu"), chunk=None), "A6"),
    (dict(incumbent_board=tinc.IncumbentBoard()), "A6"),
    (dict(chunk=None), "A6"), (dict(balance_period=None), "A6"),
    (dict(loop_cache=True), "A9"), (dict(overlap=True), "A5b"),
    (dict(serve_batch=True, loop_cache=True), "A9")])
def test_left_out_arguments_name_their_roadmap_item(kw, item):
    inst = PFSPInstance.synthetic(7, 3, 0)
    if kw.get("serve_batch"):
        specs = [tmb.MemberSpec(table=inst.p_times),
                 tmb.MemberSpec(table=PFSPInstance.synthetic(7, 3, 1)
                                .p_times)]
        cache = tsvc.ExecutorCache()
        got = tmb.serve_batch(specs, devices=["cpu"] * 2, loop_cache=cache)
        plain = tmb.serve_batch(specs, devices=["cpu"] * 2)
        assert [(r.explored_tree, r.explored_sol, r.best) for r in got] \
            == [(r.explored_tree, r.explored_sol, r.best) for r in plain]
        assert cache.snapshot()["misses"] >= 1
        return
    if "loop_cache" in kw:
        kw = dict(kw, loop_cache=tsvc.ExecutorCache())
        plain = tdist.search(inst.p_times, devices=["cpu"] * 2)
    res = tdist.search(inst.p_times, devices=["cpu"] * 2, **kw)
    assert res.complete and res.best == tseq.pfsp_search(inst, lb=1).best
    if "loop_cache" in kw:
        assert (res.explored_tree, res.explored_sol) == (
            plain.explored_tree, plain.explored_sol)


def test_host_fraction_runs_beside_the_workers():
    """`host_fraction=8` (once refused, naming A6) runs the -C host tier
    beside two workers and proves the optimum (ub=inf: the totals depend
    on the exchanges' timing, the optimum does not)."""
    inst = PFSPInstance.synthetic(9, 4, 3)
    got = tdist.search(inst.p_times, devices=["cpu"] * 2, lb_kind=1,
                       chunk=32, capacity=1 << 12, host_fraction=8,
                       host_threads=2)
    assert got.best == tseq.pfsp_search(inst, lb=1).best and got.complete
    assert got.per_device["host_expanded"][0] > 0
    assert got.per_device["exchanges"][0] >= 1


def test_pfsp_command_segmented_resume(tmp_path):
    ck = str(tmp_path / "c.npz")
    # ta002 LB1 ub=opt (tree 30) one parent a step from a 4-node warm-up,
    # in small pools: every CLI path at a few milliseconds a step
    argv = ["pfsp", "-i", "2", "-l", "1", "-u", "1", "--device", "cpu",
            "-D", "4", "-m", "1", "--chunk", "1", "--capacity", "4096",
            "--segment-iters", "4", "--checkpoint", ck]

    def run(extra):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv + extra)
        return rc, out.getvalue()

    rc, text = run(["--max-iters", "1"])        # one balance round
    assert rc == 0 and "[segment 1] iters=4 " in text
    assert "sizes=[" in text and "steals=[" in text
    assert "Best makespan found (truncated run)" in text
    rc, text = run([])
    assert rc == 0 and "[segment 1] iters=8 " in text
    assert "Size of the explored tree: 30" in text     # the golden
    assert "Optimal makespan: 1359" in text
