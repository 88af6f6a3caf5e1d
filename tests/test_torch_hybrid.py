"""The port's `-C` host tier (`engine/hybrid.py`) against the JAX package.

Compared on the same inputs, exactly (integer math): the share functions
(`split_host_share`, `pop_host_share`, `restore_host_share`) on one pool
and on four stacked pools; `hybrid.search` against JAX's `hybrid.search`,
`device.search` and the sequential oracle with ub=opt (the explored set
does not depend on the traversal order, so the totals and the device
side's counters are exact), and at ub=inf the optimum with a live
exchange; `run_segmented`'s `post_segment` hook on four workers with a
stub session that lowers the incumbent at segment 2; the CLI's segmented
driver with `-C` fresh, stopped and resumed with and without `-C`, and
across the packages both ways; `distributed.search(host_fraction > 0)`
on four CPU workers (PFSP, native session) and two (knapsack and TSP,
`PyHostSession`); and the `pfsp` command's `-C`, `--max-iters` refusal
and `--csv` rows. The JAX package runs on the conftest's CPU mesh."""

import argparse
import contextlib
import io
import shutil

import numpy as np
import pytest
import torch

from tpu_tree_search import cli as jcli, problems as jproblems
from tpu_tree_search.engine import checkpoint as jckpt
from tpu_tree_search.engine import device as jdevice
from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.engine import hybrid as jhybrid
from tpu_tree_search.parallel.mesh import worker_mesh
from tpu_tree_search.problems import knapsack as jks, tsp as jtsp
from tpu_tree_search_torch import cli, convert, problems as tproblems
from tpu_tree_search_torch.engine import checkpoint, device, hybrid
from tpu_tree_search_torch.engine import distributed as tdist
from tpu_tree_search_torch.engine import sequential as tseq
from tpu_tree_search_torch.problems import base as tbase, taillard
from tpu_tree_search_torch.problems import nqueens as tnq
from tpu_tree_search_torch.problems.pfsp import PFSPInstance

import _torch_threads

_torch_threads.share_cores()

P3 = taillard.processing_times(3)
OPT3 = taillard.optimal_makespan(3)
GOLDEN3 = (80062, 0, 1081)
DEVICE_FIELDS = ("tree", "sol", "evals", "iters", "steals", "recv")
HOST_FIELDS = ("host_tree", "host_sol", "host_expanded", "host_drained",
               "exchanges", "host_improved", "dev_improved")


@pytest.fixture(autouse=True, scope="module")
def _cores_for_the_host_tier():
    """The host tier's threads (2 in every test here) run beside torch's:
    leave them their cores, so torch's waiting threads do not spin on
    them."""
    before = _torch_threads.share_cores(reserve=2)
    yield
    torch.set_num_threads(before)


def _totals(res):
    return res.explored_tree, res.explored_sol, res.best


# ----------------------------------------------------------- the shares

def _pools(stacked: bool, seed: int = 0):
    """Seeded numpy pools of the state's fields: one (jobs, capacity) pool
    or four stacked ones, each with a few hundred live rows."""
    rng = np.random.default_rng(seed)
    D, J, M, cap = (4 if stacked else 1), 9, 4, 512
    lead = (D,) if stacked else ()
    size = rng.integers(100, 400, D).astype(np.int32)
    zeros = np.zeros(lead, np.int64)
    return dict(
        prmu=rng.integers(0, J, lead + (J, cap)).astype(np.int16),
        depth=rng.integers(0, J, lead + (cap,)).astype(np.int16),
        aux=rng.integers(0, 300, lead + (M, cap)).astype(np.int32),
        size=size if stacked else size[0], best=np.full(lead, 500, np.int32),
        tree=zeros, sol=zeros, iters=zeros, evals=zeros, sent=zeros,
        recv=zeros, steals=zeros, overflow=np.zeros(lead, bool),
        telemetry=np.zeros(lead + (0,), np.int64))


def _jax_state(arrays):
    return jdevice.SearchState(**{f: arrays[f]
                                  for f in jdevice.SearchState._fields})


def _same_pools(got, want):
    got = convert.state_to_numpy(got)
    for f in ("prmu", "depth", "aux", "size"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_split_host_share_matches_jax():
    fr = tdist.bfs_warmup(P3, 2, OPT3, target=64)
    for k in (0, 1, 3, 8, len(fr.depth) + 1):
        for got, want in zip(hybrid.split_host_share(fr.prmu, fr.depth, k),
                             jhybrid.split_host_share(fr.prmu, fr.depth, k)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stacked", [False, True], ids=["one", "stacked"])
@pytest.mark.parametrize("fraction", [3, 1000])
def test_pop_host_share_matches_jax(stacked, fraction):
    arrays = _pools(stacked)
    want, wp, wd = jhybrid.pop_host_share(_jax_state(arrays), fraction,
                                          cap=256)
    got, gp, gd = hybrid.pop_host_share(
        convert.state_from_numpy(arrays, "cpu"), fraction, cap=256)
    _same_pools(got, want)
    assert gp.shape == (len(gd), 9) and gp.dtype == np.int16
    if len(np.asarray(wd)):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gd, wd)
    else:
        assert fraction == 1000 and len(gd) == 0


@pytest.mark.parametrize("stacked", [False, True], ids=["one", "stacked"])
def test_restore_host_share_matches_jax(stacked):
    p = PFSPInstance.synthetic(jobs=9, machines=4, seed=3).p_times
    arrays = _pools(stacked)
    fr = tdist.bfs_warmup(p, 1, None, target=40)
    want = jhybrid.restore_host_share(_jax_state(arrays), fr.prmu, fr.depth,
                                      p, problem=jproblems.get("pfsp"))
    got = hybrid.restore_host_share(convert.state_from_numpy(arrays, "cpu"),
                                    fr.prmu, fr.depth, p)
    _same_pools(got, want)
    # no room: both refuse the same way
    full = dict(arrays, size=np.full_like(arrays["size"], 500))
    with pytest.raises(RuntimeError, match="no room to restore"):
        jhybrid.restore_host_share(_jax_state(full), fr.prmu, fr.depth, p)
    with pytest.raises(RuntimeError, match="no room to restore"):
        hybrid.restore_host_share(convert.state_from_numpy(full, "cpu"),
                                  fr.prmu, fr.depth, p)


def _prefix_front_remain_loop(p, prmu, depth):
    """`prefix_front_remain` node by node, with the scalar `add_forward`
    (the reference the vectorized version is held to)."""
    from tpu_tree_search_torch.ops import reference as ref

    p = np.asarray(p, np.int64)
    out = np.zeros((len(depth), 2 * p.shape[0]), np.int32)
    for b in range(len(depth)):
        front = np.zeros(p.shape[0], np.int64)
        for i in range(int(depth[b])):
            ref.add_forward(int(prmu[b, i]), p, front)
        out[b, :p.shape[0]] = front
        out[b, p.shape[0]:] = p.sum(axis=1) - p[:, prmu[b, :depth[b]]].sum(1)
    return out


def test_warmup_frontier_aux_rows_match_the_node_by_node_loop():
    """The aux rows of a host-built frontier (the -C tier seeds the pool
    with some 10^5 warm-up nodes) against the node-by-node loop, at every
    depth from the root to complete permutations."""
    from tpu_tree_search_torch.ops import reference as ref

    rng = np.random.default_rng(4)
    for jobs, machines in ((9, 4), (20, 10)):
        p = rng.integers(1, 99, (machines, jobs)).astype(np.int32)
        prmu = np.stack([rng.permutation(jobs) for _ in range(300)]
                        ).astype(np.int16)
        depth = rng.integers(0, jobs + 1, 300).astype(np.int16)
        np.testing.assert_array_equal(
            ref.prefix_front_remain(p, prmu, depth),
            _prefix_front_remain_loop(p, prmu, depth))
    fr = tdist.bfs_warmup(P3, 2, OPT3, target=4096)
    np.testing.assert_array_equal(
        ref.prefix_front_remain(P3, fr.prmu, fr.depth),
        _prefix_front_remain_loop(P3, fr.prmu, fr.depth))


# ------------------------------------------------------ hybrid.search

def _same_hybrid(got, want, fields=DEVICE_FIELDS + HOST_FIELDS):
    assert _totals(got) == _totals(want)
    for f in fields:
        assert list(got.per_device[f]) == list(want.per_device[f]), f


@pytest.mark.parametrize("lb", [0, 1, 2])
def test_hybrid_search_matches_jax_and_the_oracle(lb):
    inst = PFSPInstance.synthetic(jobs=9, machines=4, seed=3)
    opt = tseq.pfsp_search(inst, lb=2).best
    oracle = tseq.pfsp_search(inst, lb=lb, init_ub=opt)
    kw = dict(lb_kind=lb, init_ub=opt, chunk=32, capacity=1 << 12,
              drain_min=64, host_threads=2)
    got = hybrid.search(inst.p_times, device="cpu", **kw)
    assert _totals(got) == (oracle.explored_tree, oracle.explored_sol,
                            oracle.best)
    _same_hybrid(got, jhybrid.search(inst.p_times, **kw))


@pytest.mark.parametrize("kw,field", [
    (dict(drain_min=64, host_fraction=2, segment_iters=8), "host_expanded"),
    (dict(drain_min=400), "host_drained")])
def test_hybrid_ta003_equals_device_search_and_jax(kw, field):
    """ta003 LB2 ub=opt (`device.search` gives the golden at any chunk:
    the explored set does not depend on the order)."""
    kw = dict(lb_kind=2, init_ub=OPT3, chunk=256, capacity=1 << 16,
              host_threads=2, **kw)
    got = hybrid.search(P3, device="cpu", **kw)
    assert _totals(got) == GOLDEN3
    assert got.per_device[field][0] > 0
    _same_hybrid(got, jhybrid.search(P3, **kw))


def test_hybrid_live_incumbent_proves_the_optimum():
    """ub=inf: the session and the device loop exchange incumbents while
    both search; the optimum is proven and the tree is no smaller than
    the ub=opt tree (the exchanges depend on timing, the tree with
    them)."""
    transferred = False
    for seed in (9, 5, 17, 23):
        inst = PFSPInstance.synthetic(jobs=11, machines=4, seed=seed)
        res = hybrid.search(inst.p_times, lb_kind=1, init_ub=None, chunk=32,
                            capacity=1 << 14, drain_min=16, host_threads=2,
                            host_fraction=4, segment_iters=4, device="cpu")
        pd = res.per_device
        assert pd["exchanges"][0] > 0 and pd["host_tree"][0] > 0
        assert pd["tree"][0] > 0
        opt = tseq.pfsp_search(inst, lb=1).best
        at_opt = tseq.pfsp_search(inst, lb=1, init_ub=opt)
        assert res.best == opt
        assert res.explored_tree >= at_opt.explored_tree
        if pd["host_improved"][0] + pd["dev_improved"][0] >= 1:
            transferred = True
            break
    assert transferred


# ------------------------------------------------- the post_segment hook

class _StubSession:
    """No thread: `merge` returns a fixed bound at segment `at`, else the
    device's bound."""

    def __init__(self, bound: int, at: int = 2):
        self.bound, self.at, self.calls = bound, at, 0

    def merge(self, dev_best: int) -> int:
        self.calls += 1
        return min(dev_best, self.bound) if self.calls == self.at \
            else dev_best


class _JaxStub(_StubSession):
    post_segment = jhybrid.HostSession.post_segment


class _PortStub(_StubSession):
    post_segment = hybrid.HostSession.post_segment


def test_post_segment_bound_reaches_the_next_segment():
    inst = PFSPInstance.synthetic(jobs=8, machines=4, seed=5)
    table, opt = inst.p_times, tseq.pfsp_search(inst, lb=2).best
    kw = dict(chunk=4, balance_period=2, transfer_cap=16, min_transfer=4)
    seg = dict(segment_iters=4, heartbeat=None)
    jp, tp = jproblems.get("pfsp"), tproblems.get("pfsp")

    jdrv = jdist._problem_driver(
        jp, worker_mesh(4), jp.make_tables(table), table, 1, kw["chunk"],
        kw["balance_period"], kw["transfer_cap"], kw["min_transfer"],
        jp.aux_dtype(table), None)
    fr = jp.warmup(table, 1, None, target=16)
    fr.aux = jp.seed_aux(table, fr.prmu, fr.depth)
    js = _JaxStub(opt)
    want = jckpt.run_segmented(
        lambda s, t: jdrv.run(s, max_iters=t),
        jdrv.seed(fr, 1 << 10, 8, fr.best), post_segment=js.post_segment,
        **seg)

    tdrv = tdist._problem_driver(tp, ["cpu"] * 4, table, 1, kw["chunk"],
                                 kw["balance_period"], kw["transfer_cap"],
                                 kw["min_transfer"])
    fr = tp.warmup(table, 1, None, target=16)
    fr.aux = tp.seed_aux(table, fr.prmu, fr.depth)
    ts = _PortStub(opt)
    got = checkpoint.run_segmented(
        lambda s, t: tdrv.run(s, max_iters=t),
        tdrv.seed(fr, 1 << 10, 8, fr.best), post_segment=ts.post_segment,
        **seg)

    assert js.calls == ts.calls > 2
    want, got = jdist.fetch_state(want), tdist.fetch_state(got)
    for f in ("size", "best", "tree", "sol", "evals", "iters", "sent",
              "recv", "steals"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(np.asarray(got.best).max()) == opt
    # the lowered bound pruned: fewer nodes than the run without it
    free = tdist.search(table, lb_kind=1, devices=["cpu"] * 4,
                        capacity=1 << 10, min_seed=4, **kw)
    assert int(np.asarray(got.tree).sum()) < free.explored_tree - \
        free.warmup_tree


# ------------------------------------------- the CLI's segmented driver

def _args(**kw):
    base = dict(lb=2, chunk=256, capacity=1 << 16, checkpoint=None,
                grow_capacity=None, segment_iters=16, max_iters=None,
                checkpoint_every=1, retry_attempts=None,
                segment_timeout=None, search_telemetry=False)
    base.update(kw)
    return argparse.Namespace(**base)


def _port_segmented(fraction, **kw):
    out, extras = cli._run_pfsp_segmented(_args(**kw), P3, OPT3,
                                          device.resolve_device("cpu"),
                                          host_fraction=fraction,
                                          host_threads=2)
    c = device.counters(out)
    return (c.tree + extras["tree"], c.sol + extras["sol"]), extras


def _jax_segmented(fraction, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        out, extras = jcli._run_pfsp_segmented(_args(**kw), P3, OPT3,
                                               host_fraction=fraction,
                                               host_threads=2)
    return (int(out.tree) + extras["tree"], int(out.sol) + extras["sol"])


def test_segmented_host_tier_fresh_stop_and_resume(tmp_path):
    got, extras = _port_segmented(4)
    assert got == GOLDEN3[:2] and extras["host"]["host_expanded"][0] > 0
    ck = str(tmp_path / "c.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        out, ex1 = cli._run_pfsp_segmented(_args(checkpoint=ck, max_iters=48),
                                           P3, OPT3,
                                           device.resolve_device("cpu"),
                                           host_fraction=4, host_threads=2)
    assert device.counters(out).size > 0, "the stopped run drained"
    with np.load(ck) as z:
        assert len(z["meta_host_depth"]) > 0
    shutil.copy(ck, tmp_path / "copy.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        # the session re-seeded from the checkpoint's saved share
        assert _port_segmented(4, checkpoint=ck)[0] == GOLDEN3[:2]
        # without -C the saved share goes back into the pool
        assert _port_segmented(0, checkpoint=str(tmp_path / "copy.npz"))[0] \
            == GOLDEN3[:2]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_host_tier_checkpoint_resumes_across_packages(tmp_path, writer):
    """A -C checkpoint stopped at 48 steps by one package, resumed by the
    other with -C (the session from the saved share) and without (the
    share pushed back), each to the golden."""
    ck = str(tmp_path / "w.npz")
    stop = dict(checkpoint=ck, max_iters=48)
    if writer == "jax":
        _jax_segmented(4, **stop)
    else:
        with contextlib.redirect_stdout(io.StringIO()):
            _port_segmented(4, **stop)
    with np.load(ck) as z:
        assert len(z["meta_host_depth"]) > 0
    shutil.copy(ck, tmp_path / "copy.npz")
    resume = _jax_segmented if writer == "port" else (
        lambda fr, **kw: _port_segmented(fr, **kw)[0])
    with contextlib.redirect_stdout(io.StringIO()):
        assert resume(4, checkpoint=ck) == GOLDEN3[:2]
        assert resume(0, checkpoint=str(tmp_path / "copy.npz")) == \
            GOLDEN3[:2]


# ---------------------------------------------------------- distributed

DIST3 = dict(lb_kind=2, init_ub=OPT3, chunk=64, capacity=1 << 15,
             min_seed=32)


def test_distributed_host_tier_matches_jax_and_pure_workers():
    """Four workers beside the host tier, against JAX's on four mesh
    devices; at ub=opt both equal the workers' run alone, the golden."""
    kw = dict(DIST3, host_fraction=4, segment_iters=16, host_threads=2)
    got = tdist.search(P3, devices=["cpu"] * 4, **kw)
    want = jdist.search(P3, n_devices=4, **kw)
    assert _totals(got) == _totals(want) == GOLDEN3
    assert got.per_device["host_expanded"][0] > 0
    assert got.per_device["exchanges"][0] > 0
    for f in DEVICE_FIELDS + ("sent", "final_size") + HOST_FIELDS[:3] \
            + HOST_FIELDS[4:]:
        np.testing.assert_array_equal(np.asarray(got.per_device[f]),
                                      np.asarray(want.per_device[f]),
                                      err_msg=f)


@pytest.mark.parametrize("name", ["knapsack", "tsp"])
def test_python_host_session_through_distributed(name):
    """`PyHostSession` beside two workers, against JAX's. TSP 7 with ub =
    its optimum (from a run without the tier) keeps a warm-up frontier to
    share, so the trees do not depend on the exchanges' timing and are
    exact; knapsack's frontier empties at ub=opt, so it runs at ub=inf and
    only the optimum is compared."""
    kw = dict(lb_kind=2, chunk=8, capacity=1 << 13, min_seed=8,
              devices=["cpu"] * 2)
    if name == "knapsack":
        table = jks.KnapsackInstance.synthetic(14, seed=2).table
    else:
        table = jtsp.TSPInstance.synthetic(7, seed=1).d
        kw["init_ub"] = tdist.search(table, problem=name, **kw).best
    pure = tdist.search(table, problem=name, **kw)
    tier = dict(host_fraction=4, segment_iters=4)
    got = tdist.search(table, problem=name, **kw, **tier)
    jkw = {k: v for k, v in kw.items() if k != "devices"}
    want = jdist.search(table, problem=name, n_devices=2, **jkw, **tier)
    assert got.per_device["host_expanded"][0] > 0
    assert got.per_device["exchanges"][0] > 0
    if name == "knapsack":
        assert got.best == want.best == pure.best
        return
    assert _totals(got) == _totals(want) == _totals(pure)
    for f in DEVICE_FIELDS + HOST_FIELDS[:3] + HOST_FIELDS[4:]:
        np.testing.assert_array_equal(np.asarray(got.per_device[f]),
                                      np.asarray(want.per_device[f]),
                                      err_msg=f)


def test_nqueens_refuses_the_host_tier():
    with pytest.raises(tbase.HostTierUnsupported, match="nqueens"):
        tdist.search(tnq.table(6), problem="nqueens", devices=["cpu"] * 2,
                     lb_kind=0, host_fraction=4)


# ------------------------------------------------------------- the CLI

def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _result(text):
    return tuple(int(ln.rsplit(": ", 1)[1]) for ln in text.splitlines()
                 if ln.startswith(("Size of the explored tree",
                                   "Number of explored solutions",
                                   "Optimal makespan")))


C3 = ["pfsp", "-i", "3", "-l", "2", "-u", "1", "-C", "1", "--chunk", "256",
      "--host-threads", "2", "--capacity", "65536"]
# ta019 LB1 ub=opt (tree 178) on two workers from a 4-node-per-worker
# warm-up: a small -D run whose workers both search
D2 = ["pfsp", "-i", "19", "-l", "1", "-u", "1", "--chunk", "16",
      "--capacity", "16384", "-D", "2", "-m", "4"]
TIMING = {"total_time", "gpu_kernel_time", "gen_child_time",
          "gpu_gen_child_time", "pool_ops_time", "gpu_idle_time"}


def _csv_row(path):
    import csv
    with open(path) as f:
        rows = list(csv.reader(f))
    assert len(rows) == 2
    return rows[0], dict(zip(rows[0], rows[1]))


def _floats(cell):
    return [float(x) for x in cell.strip("[]").split(",")]


def _same_csv(port, jax):
    """The same header and non-timing columns; returns the port's row."""
    (ph, prow), (jh, jrow) = _csv_row(port), _csv_row(jax)
    assert ph == jh
    assert {k: v for k, v in prow.items() if k not in TIMING} == \
        {k: v for k, v in jrow.items() if k not in TIMING}
    return prow


def test_pfsp_command_host_tier_matches_jax_cli(tmp_path):
    """`pfsp -C 1` on one device prints the JAX CLI's numbers and writes
    its CSV row (the timing columns measured: the bound's share and the
    rest of the step); `--max-iters` is refused with -C on one device, as
    in JAX."""
    port, jax = str(tmp_path / "p.csv"), str(tmp_path / "j.csv")
    rc, out, err = _cli(cli.main, C3 + ["--device", "cpu", "--csv", port])
    assert rc == 0 and "phase profiling failed" not in err
    jrc, jout, _ = _cli(jcli.main, C3 + ["-D", "1", "--csv", jax])
    assert jrc == 0
    assert _result(out) == _result(jout) == GOLDEN3
    row = _same_csv(port, jax)
    assert float(row["gpu_kernel_time"]) > 0
    assert float(row["gen_child_time"]) >= 0
    rc, out, err = _cli(cli.main, C3 + ["--device", "cpu", "--max-iters",
                                        "5"])
    assert rc == 2 and "--max-iters is not supported with -C 1" in err
    assert "explored" not in out


def test_pfsp_csv_row_on_two_workers_matches_jax(tmp_path):
    """`pfsp -D 2 --csv`: the reference's multi-device schema, the JAX
    CLI's per-worker counters, and per worker the kernel, the rest of the
    step and the balance rounds measured, idle the rest of the elapsed
    time (all four summing to it unless the measured phases exceed it, as
    a loaded host can make them)."""
    port, jax = str(tmp_path / "p.csv"), str(tmp_path / "j.csv")
    rc, _, err = _cli(cli.main, D2 + ["--device", "cpu", "--csv", port])
    assert rc == 0 and "phase profiling failed" not in err
    rc, _, _ = _cli(jcli.main, D2 + ["--csv", jax])
    assert rc == 0
    row = _same_csv(port, jax)
    parts = [_floats(row[c]) for c in ("gpu_kernel_time",
                                       "gpu_gen_child_time",
                                       "pool_ops_time", "gpu_idle_time")]
    total = float(row["total_time"])
    for w in range(2):
        assert parts[0][w] > 0 and parts[1][w] >= 0 and parts[2][w] > 0
        assert parts[3][w] == pytest.approx(
            max(0.0, total - parts[0][w] - parts[1][w] - parts[2][w]),
            abs=2e-4)
