"""The port's multi-worker search against the JAX package's.

The port runs D workers on `[cpu] * D`; the JAX package runs its SPMD
loop on D devices of the conftest's 8-device CPU mesh (D = 4, and 8 where
a test says so). Compared, exactly (tolerance 0: integer math), on
`PFSPInstance.synthetic(8, 4, seed)` shapes: the
steal-half plan on seeded size vectors; every worker's live rows and
counters after each macro-iteration (`max_rounds`) at LB1_d, LB1 and
LB2 with ub=inf, where the schedule matters; `DistResult.per_device`
for PFSP, N-Queens 8, knapsack and TSP; the ub=opt counts at D = 1, 2
and 8 against the sequential oracle; the steal-flow telemetry; one
macro-iteration with every read of a tensor value to the host refused;
and `pfsp -D 4 --device cpu` through the command. Each JAX run happens
once (module-scoped fixtures)."""

import contextlib
import io

import numpy as np
import pytest
import torch

from tpu_tree_search import problems as jproblems
from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.parallel import balance as jbal
from tpu_tree_search.parallel.mesh import worker_mesh
from tpu_tree_search.problems import knapsack as jks, tsp as jtsp
from tpu_tree_search_torch import cli, problems as tproblems
from tpu_tree_search_torch.engine import distributed as tdist
from tpu_tree_search_torch.engine import sequential as tseq
from tpu_tree_search_torch.engine import telemetry as ttele
from tpu_tree_search_torch.obs import metrics as tmetrics
from tpu_tree_search_torch.parallel import balance as tbal, mesh as tmesh
from tpu_tree_search_torch.problems import nqueens as tnq
from tpu_tree_search_torch.problems.pfsp import PFSPInstance

import _torch_threads

_torch_threads.share_cores()

D = 4
CPUS = ["cpu"] * D
_COUNTERS = ("size", "best", "tree", "sol", "evals", "iters", "sent",
             "recv", "steals", "overflow")
_READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__index__",
          "__float__")


# ------------------------------------------------------------- the plan

@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_exchange_plan_matches_jax(n_dev):
    import jax.numpy as jnp

    rng = np.random.default_rng(n_dev)
    cases = [np.zeros(n_dev), np.eye(n_dev)[0] * 100]
    cases += [rng.integers(0, hi, n_dev) for hi in (4, 50, 5000)
              for _ in range(5)]
    for sizes in cases:
        sizes = np.asarray(sizes, np.int32)
        for cap, mt in ((64, 4), (8, 1), (1 << 20, 0), (16, 40)):
            want = np.asarray(jbal.exchange_plan(jnp.asarray(sizes), cap,
                                                 mt))
            got = tbal.exchange_plan(torch.as_tensor(sizes), cap, mt)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{sizes} {cap} {mt}")


def test_worker_devices_and_submeshes():
    assert tmesh.worker_devices(devices=["cpu"] * 3) == \
        [torch.device("cpu")] * 3
    eight = ["cpu"] * 8
    assert len(tmesh.worker_devices(2, devices=eight)) == 2
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        tmesh.worker_devices(9, devices=eight)
    subs = tmesh.partition_submeshes(4, devices=eight)
    assert [len(s) for s in subs] == [2] * 4
    with pytest.raises(ValueError, match="equal submeshes"):
        tmesh.partition_submeshes(3, devices=eight)


# ---------------------------------------- state after every macro-iteration

KW = dict(chunk=4, balance_period=2, transfer_cap=16, min_transfer=4,
          min_seed=4, capacity=1 << 10)


def _jax_states(table, lb, rounds):
    """JAX's stacked state (host numpy) after each of `rounds`
    macro-iterations, every run from the same seeded state."""
    jp = jproblems.get("pfsp")
    mesh = worker_mesh(D)
    drv = jdist._problem_driver(
        jp, mesh, jp.make_tables(table), table, lb, KW["chunk"],
        KW["balance_period"], KW["transfer_cap"], KW["min_transfer"],
        jp.aux_dtype(table), None)
    fr = jp.warmup(table, lb, None, target=KW["min_seed"] * D)
    fr.aux = jp.seed_aux(table, fr.prmu, fr.depth)
    s0 = drv.seed(fr, KW["capacity"], table.shape[1], fr.best)
    return [jdist.fetch_state(drv.run(s0, max_iters=k * KW["balance_period"]))
            for k in rounds]


def _port_states(table, lb, rounds):
    """The port's stacked state after each of `rounds` macro-iterations,
    one run continued round after round."""
    tp = tproblems.get("pfsp")
    drv = tdist._problem_driver(tp, CPUS, table, lb, KW["chunk"],
                                KW["balance_period"], KW["transfer_cap"],
                                KW["min_transfer"])
    fr = tp.warmup(table, lb, None, target=KW["min_seed"] * D)
    fr.aux = tp.seed_aux(table, fr.prmu, fr.depth)
    states = drv.seed(fr, KW["capacity"], table.shape[1], fr.best)
    out = []
    for k in rounds:
        states = drv.run(states, max_iters=k * KW["balance_period"])
        out.append(tdist.fetch_state(states))
    return out, drv


ROUNDS = list(range(1, 9)) + [10**6]


@pytest.fixture(scope="module", params=[0, 1, 2], ids=["lb1_d", "lb1", "lb2"])
def per_round(request):
    table = PFSPInstance.synthetic(jobs=8, machines=4, seed=3).p_times
    want = _jax_states(table, request.param, ROUNDS)
    got, drv = _port_states(table, request.param, ROUNDS)
    return want, got, drv


def _same_workers(got, want):
    for f in _COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for d, n in enumerate(np.asarray(want.size)):
        for f in ("prmu", "depth", "aux"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got, f))[d, ..., :n],
                np.asarray(getattr(want, f))[d, ..., :n],
                err_msg=f"worker {d} {f}")


@pytest.mark.parametrize("k", range(len(ROUNDS)))
def test_state_after_each_macro_iteration_matches_jax(per_round, k):
    want, got, _ = per_round
    _same_workers(got[k], want[k])


def test_balance_rounds_moved_nodes_and_the_runs_ended(per_round):
    want, got, drv = per_round
    last = got[-1]
    assert int(np.asarray(last.sent).sum()) > 0
    assert int(np.asarray(last.sent).sum()) == \
        int(np.asarray(last.recv).sum())
    assert int(np.asarray(last.size).sum()) == 0
    assert drv.host_reads == drv.macro_iters > 0


# ------------------------------------------------- results per problem

def _per_problem_case(name):
    if name == "pfsp":
        table = PFSPInstance.synthetic(jobs=8, machines=4, seed=1).p_times
        return table, dict(lb_kind=1, chunk=8, capacity=1 << 12,
                           min_seed=4)
    if name == "nqueens":
        return tnq.table(8), dict(lb_kind=0, chunk=8, capacity=1 << 14,
                                  min_seed=8, transfer_cap=32,
                                  min_transfer=16)
    if name == "knapsack":
        return jks.KnapsackInstance.synthetic(14, seed=2).table, dict(
            lb_kind=2, chunk=8, capacity=1 << 13, min_seed=4)
    return jtsp.TSPInstance.synthetic(7, seed=1).d, dict(
        lb_kind=2, chunk=8, capacity=1 << 13, min_seed=4)


@pytest.mark.parametrize("name", ["pfsp", "nqueens", "knapsack", "tsp"])
def test_dist_result_per_device_matches_jax(name):
    table, kw = _per_problem_case(name)
    want = jdist.search(table, problem=name, n_devices=D, **kw)
    got = tdist.search(table, problem=name, devices=CPUS, **kw)
    assert (got.explored_tree, got.explored_sol, got.best, got.complete,
            got.warmup_tree, got.warmup_sol, got.problem) == \
        (want.explored_tree, want.explored_sol, want.best, want.complete,
         want.warmup_tree, want.warmup_sol, want.problem)
    assert sorted(got.per_device) == sorted(want.per_device)
    for f, v in want.per_device.items():
        np.testing.assert_array_equal(got.per_device[f], np.asarray(v),
                                      err_msg=f)
        assert got.per_device[f].dtype == np.asarray(v).dtype, f
    if name == "nqueens":
        assert got.explored_sol == tnq.SOLUTION_COUNTS[8]


@pytest.mark.parametrize("n_dev", [1, 2, 8])
@pytest.mark.parametrize("lb", [0, 2])
def test_ub_opt_counts_do_not_depend_on_workers(n_dev, lb):
    inst = PFSPInstance.synthetic(jobs=8, machines=4, seed=2)
    opt = inst.brute_force_optimum()
    want = tseq.pfsp_search(inst, lb=lb, init_ub=opt)
    got = tdist.search(inst.p_times, lb_kind=lb, init_ub=opt,
                       devices=["cpu"] * n_dev, chunk=4, capacity=1 << 12,
                       min_seed=4)
    assert (got.explored_tree, got.explored_sol, got.best) == \
        (want.explored_tree, want.explored_sol, want.best)
    assert got.complete and len(got.per_device["tree"]) == n_dev


# ------------------------------------------------------------ telemetry

def test_steal_flow_telemetry_matches_jax(monkeypatch):
    inst = PFSPInstance.synthetic(jobs=8, machines=3, seed=5)
    kw = dict(lb_kind=1, init_ub=None, chunk=4, capacity=1 << 12,
              min_seed=4, balance_period=2, min_transfer=2)
    monkeypatch.setenv(ttele.ENV_FLAG, "1")
    want = jdist.search(inst.p_times, n_devices=4, **kw)
    on = tdist.search(inst.p_times, devices=["cpu"] * 4, **kw)
    monkeypatch.delenv(ttele.ENV_FLAG)
    off = tdist.search(inst.p_times, devices=["cpu"] * 4, **kw)
    assert (on.explored_tree, on.explored_sol, on.best) == \
        (off.explored_tree, off.explored_sol, off.best)
    assert on.telemetry == want.telemetry and off.telemetry is None
    t = on.telemetry
    assert t["steal_sent"] == int(on.per_device["sent"].sum()) > 0
    assert t["steal_recv"] == int(on.per_device["recv"].sum())
    assert sum(t["branched"]) == on.explored_tree - on.warmup_tree
    reg = tmetrics.Registry()
    ttele.publish(t, reg, request="r1")
    assert reg.gauge("tts_search_steal_sent").value(request="r1") == \
        t["steal_sent"]
    assert reg.gauge("tts_search_popped").value(request="r1", bucket=0) \
        == t["popped"][0]


# ----------------------------------------- one macro-iteration reads nothing

def test_macro_iteration_reads_nothing_back():
    table = PFSPInstance.synthetic(jobs=8, machines=4, seed=3).p_times
    tp = tproblems.get("pfsp")
    drv = tdist._problem_driver(tp, ["cpu"] * 4, table, 2, 4, 2, 16, 4)
    fr = tp.warmup(table, 2, None, target=16)
    fr.aux = tp.seed_aux(table, fr.prmu, fr.depth)
    states = drv.seed(fr, 1 << 10, 8, fr.best)
    body = drv.body(1 << 10)
    lim = torch.full((), 10**6, dtype=torch.int64)

    def refuse(self, *args, **kw):
        raise AssertionError("a tensor value was read back to the host")

    with pytest.MonkeyPatch.context() as mp:
        for name in _READS:
            mp.setattr(torch.Tensor, name, refuse)
        for _ in range(3):
            states = body(states, tdist._loop_cond(states, lim))
            status = tdist._status(states)
    assert status.tolist()[2] == 3 * 2


def test_stack_and_unstack_round_trip():
    table = PFSPInstance.synthetic(jobs=8, machines=4, seed=3).p_times
    got, _ = _port_states(table, 1, [2])
    tp = tproblems.get("pfsp")
    drv = tdist._problem_driver(tp, CPUS, table, 1, 4, 2, 16, 4)
    fr = tp.warmup(table, 1, None, target=KW["min_seed"] * D)
    fr.aux = tp.seed_aux(table, fr.prmu, fr.depth)
    states = drv.run(drv.seed(fr, 1 << 10, 8, fr.best), max_iters=4)
    again = drv.commit(tdist.stack_states(states))
    _same_workers(tdist.fetch_state(again), got[0])


# ------------------------------------------------------------- the command

def test_pfsp_command_on_four_cpu_workers():
    """`-m 1`: a warm-up frontier of 4 nodes, so the workers search."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["pfsp", "-i", "2", "-l", "1", "-u", "1", "--device",
                       "cpu", "-D", "4", "-m", "1", "--capacity", "4096"])
    text = out.getvalue()
    assert rc == 0
    assert "GPU B&B (4 device(s) - cpu - balancing [1])" in text
    assert "Size of the explored tree: 30" in text
    assert "Optimal makespan: 1359" in text
