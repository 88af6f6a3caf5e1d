"""The port's problem-plugin engine against the JAX package's.

For each plugin: the registry contract and static spec; `branch` and
`bound` on a random popped block at every bound kind; `generic_step`
step by step from one state (live pool, every counter and the telemetry
vector, with telemetry on and off; during the port's step every tensor
method that reads a value to the host raises); `run_problem` for several
ceilings and block lengths; `solve` at the JAX conformance suite's sizes
(`tests/test_problem_plugins.py`), with a pool that overflows and grows;
the goldens (TSP, knapsack, N-Queens against the oracle); PFSP through
the plugin on the same route as `device.search`; and the `solve` and
`nqueens` commands on the CPU. All exact (tolerance 0: integer math);
inputs from numpy seeds."""

import contextlib
import functools
import io

import jax
import numpy as np
import pytest
import torch

from tpu_tree_search import problems as jproblems
from tpu_tree_search.engine import device as jdevice
from tpu_tree_search_torch import cli, convert, problems as tproblems
from tpu_tree_search_torch.engine import device as tdevice
from tpu_tree_search_torch.engine import sequential as tseq
from tpu_tree_search_torch.problems import knapsack as tks, nqueens as tnq
from tpu_tree_search_torch.problems import pfsp as tpfsp, tsp as ttsp

import _torch_threads

_torch_threads.share_cores()

_FIELDS = ("prmu", "depth", "aux", "size", "best", "tree", "sol", "iters",
           "evals", "sent", "recv", "steals", "overflow", "telemetry")
_READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__index__",
          "__float__")
# the generic step's plugins, with each bound kind
GENERIC = [("nqueens", 0), ("tsp", 1), ("tsp", 2), ("knapsack", 1),
           ("knapsack", 2)]


def tiny_table(name: str) -> np.ndarray:
    """The JAX conformance suite's instance per problem."""
    if name == "pfsp":
        return tpfsp.PFSPInstance.synthetic(jobs=7, machines=3,
                                            seed=0).p_times
    if name == "nqueens":
        return tnq.table(6)
    if name == "tsp":
        return ttsp.TSPInstance.synthetic(7, seed=0).d
    return tks.KnapsackInstance.synthetic(10, seed=0).table


@contextlib.contextmanager
def no_read_back():
    """Every read of a tensor's value to the host raises."""
    def refuse(self, *args, **kw):
        raise AssertionError("a tensor value was read back to the host")

    with pytest.MonkeyPatch.context() as mp:
        for name in _READS:
            mp.setattr(torch.Tensor, name, refuse)
        yield


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jstate(name, table, capacity, telemetry, init_ub=None):
    """The JAX seeded state of `solve`, and the port's copy of it."""
    jp = jproblems.get(name)
    prmu0, depth0 = jp.root(table)
    js = jdevice.init_state(jp.slots(table), capacity, init_ub, prmu0=prmu0,
                            depth0=depth0,
                            aux0=jp.seed_aux(table, prmu0, depth0),
                            telemetry=telemetry)
    return js, convert.state_from_numpy(_arrays(js), device="cpu")


def _arrays(s) -> dict:
    return {f: _np(getattr(s, f)) for f in _FIELDS}


def _assert_same(want: dict, got: dict, where: str):
    for f in ("size", "best", "tree", "sol", "iters", "evals", "overflow"):
        assert int(got[f]) == int(want[f]), f"{where}: {f}"
    np.testing.assert_array_equal(got["telemetry"], want["telemetry"],
                                  err_msg=f"{where}: telemetry")
    n = int(want["size"])
    for f in ("prmu", "aux"):
        assert got[f].dtype == want[f].dtype, f"{where}: {f} dtype"
        np.testing.assert_array_equal(got[f][:, :n], want[f][:, :n],
                                      err_msg=f"{where}: {f}")
    np.testing.assert_array_equal(got["depth"][:n], want["depth"][:n],
                                  err_msg=f"{where}: depth")


# ------------------------------------------------------------- registry

def test_registry_names_and_contract():
    assert tproblems.names() == jproblems.names() == \
        ["knapsack", "nqueens", "pfsp", "tsp"]
    with pytest.raises(KeyError, match="unknown problem"):
        tproblems.get("sudoku")
    nq = tproblems.get("nqueens")
    assert tproblems.register(nq) is nq                  # idempotent
    other = type(nq)()
    with pytest.raises(ValueError, match="already registered"):
        tproblems.register(other)
    with pytest.raises(ValueError, match="non-empty"):
        tproblems.register(tproblems.Problem())
    assert tproblems.get("nqueens") is nq


@pytest.mark.parametrize("name", ["knapsack", "nqueens", "pfsp", "tsp"])
def test_plugin_spec_matches_jax(name):
    tp, jp = tproblems.get(name), jproblems.get(name)
    table = tiny_table(name)
    for attr in ("leaf_in_evals", "supports_host_tier", "supports_fused",
                 "lb_kinds", "default_lb", "branch_factor",
                 "telemetry_labels"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    assert tp.validate(table) is None
    assert tp.validate(np.zeros((1, 1), np.int32)) == \
        jp.validate(np.zeros((1, 1), np.int32))
    for fn in ("slots", "aux_rows", "branching", "default_capacity"):
        assert getattr(tp, fn)(table) == getattr(jp, fn)(table), fn
    J = tp.slots(table)
    for capacity, chunk in ((1 << 14, 8), (100, 64)):
        assert tp.usable_rows(capacity, chunk, J) == \
            jp.usable_rows(capacity, chunk, J)
    assert convert.np_dtype(tp.aux_dtype(table)) == \
        np.dtype(jp.aux_dtype(table)).name
    for a, b in zip(tp.root(table), jp.root(table)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    prmu0, depth0 = jp.root(table)
    ta, ja = tp.seed_aux(table, prmu0, depth0), jp.seed_aux(table, prmu0,
                                                             depth0)
    assert (ta is None) == (ja is None)
    if ja is not None:
        np.testing.assert_array_equal(ta, ja)
        assert ta.dtype == ja.dtype
    kids = [list(tp.host_children(table, prmu0[0].copy(), int(depth0[0]),
                                  2**31 - 1, lb_kind=lb))
            for lb in tp.lb_kinds]
    want = [list(jp.host_children(table, prmu0[0].copy(), int(depth0[0]),
                                  2**31 - 1, lb_kind=lb))
            for lb in jp.lb_kinds]
    for k, w in zip(kids, want):
        assert [(c.tolist(), d, b, leaf) for c, d, b, leaf in k] == \
            [(c.tolist(), d, b, leaf) for c, d, b, leaf in w]
    assert tp.display_objective(-7) == jp.display_objective(-7)
    assert tp.engine_objective(7) == jp.engine_objective(7)
    # the multi-worker seed: the same frontier and warm-up counters
    got = tp.warmup(table, tp.default_lb, None, target=8)
    ref = jp.warmup(table, jp.default_lb, None, target=8)
    assert (got.tree, got.sol, got.best) == (ref.tree, ref.sol, ref.best)
    np.testing.assert_array_equal(got.prmu, ref.prmu)
    np.testing.assert_array_equal(got.depth, ref.depth)


# ------------------------------------------------------- branch / bound

def _popped_block(name, table, B, rng):
    """A popped block of real nodes of the plugin (some invalid):
    (p_prmu (J, B) int16, p_depth (B,) int32 zero where invalid, p_aux
    (A, B) int32, valid (B,) bool)."""
    jp = jproblems.get(name)
    J = jp.slots(table)
    if name == "knapsack":
        prmu = rng.integers(0, 2, size=(B, J)).astype(np.int16)
        depth = rng.integers(0, J, size=B)
    elif name == "tsp":
        prmu = np.stack([np.concatenate([[0], 1 + rng.permutation(J - 1)])
                         for _ in range(B)]).astype(np.int16)
        depth = rng.integers(1, J, size=B)
    else:
        prmu = np.stack([rng.permutation(J) for _ in range(B)]) \
            .astype(np.int16)
        depth = rng.integers(0, J + 1, size=B)
    aux = jp.seed_aux(table, prmu, depth.astype(np.int16))
    aux = (np.zeros((B, 0), np.int32) if aux is None else aux) \
        .astype(np.int32)
    valid = rng.random(B) < 0.8
    depth = np.where(valid, depth, 0).astype(np.int32)
    return prmu.T.copy(), depth, aux.T.copy(), valid


@pytest.mark.parametrize("name,lb", GENERIC)
@pytest.mark.parametrize("seed", [0, 1])
def test_branch_and_bound_match_jax(name, lb, seed):
    rng = np.random.default_rng(seed)
    table = {"nqueens": tnq.table(9, 2),
             "tsp": ttsp.TSPInstance.synthetic(11, seed=seed).d,
             "knapsack": tks.KnapsackInstance.synthetic(23, seed).table}[name]
    tp, jp = tproblems.get(name), jproblems.get(name)
    jt, tt = jp.make_tables(table), tp.make_tables(table, device="cpu")
    block = _popped_block(name, table, 16, rng)
    jbr = jp.branch(jt, *(jax.numpy.asarray(x) for x in block))
    with no_read_back():
        tbr = tp.branch(tt, *(torch.as_tensor(x) for x in block))
    for f in ("children", "child_depth", "child_aux", "evaluated"):
        want, got = _np(getattr(jbr, f)), _np(getattr(tbr, f))
        assert got.dtype == want.dtype, f
        if f == "children":
            # a column that is not a real child is garbage by contract
            # (it is written above the pool cursor, never read)
            live = _np(jbr.evaluated)
            want, got = want[:, live], got[:, live]
        np.testing.assert_array_equal(got, want, err_msg=f)
    for best in (2**31 - 1, -40, 150):
        want = _np(jp.bound(jt, lb, jbr, jax.numpy.int32(best)))
        with no_read_back():
            got = tp.bound(tt, lb, tbr, torch.tensor(best, dtype=torch.int32))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), want)
        np.testing.assert_array_equal(
            _np(tp.is_leaf_cols(tt, tbr)), _np(jp.is_leaf_cols(jt, jbr)))


# -------------------------------------------------------- generic_step

_JSTEPS = {}


def _jstep(name, lb, chunk):
    key = (name, lb, chunk)
    if key not in _JSTEPS:
        _JSTEPS[key] = jax.jit(functools.partial(
            jdevice.generic_step, jproblems.get(name)),
            static_argnums=(1, 2), static_argnames=("limit",))
    return _JSTEPS[key]


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("name,lb", GENERIC)
def test_generic_step_matches_jax(name, lb, telemetry):
    """Step by step from the root; the pool is small enough that a later
    step overflows (its block goes to the scratch margin, nothing
    commits), and the overflowed state steps on as JAX's does."""
    table = {"nqueens": tnq.table(7),
             "tsp": ttsp.TSPInstance.synthetic(8, seed=3).d,
             "knapsack": tks.KnapsackInstance.synthetic(14, 3).table}[name]
    tp, jp = tproblems.get(name), jproblems.get(name)
    chunk = 6
    capacity = 30 + chunk * tp.branching(table)
    js, ts = _jstate(name, table, capacity, telemetry)
    jt, tt = jp.make_tables(table), tp.make_tables(table, device="cpu")
    jstep = _jstep(name, lb, chunk)
    overflowed = False
    for k in range(14):
        js = jstep(jt, lb, chunk, js)
        with no_read_back():
            ts = tdevice.generic_step(tp, tt, lb, chunk, ts)
        _assert_same(_arrays(js), convert.state_to_numpy(ts),
                     f"{name} lb{lb} step {k + 1}")
        overflowed |= bool(js.overflow)
    assert overflowed, "no step overflowed: shrink the pool"


@pytest.mark.parametrize("name,lb", GENERIC)
def test_inactive_step_is_a_no_op(name, lb):
    table = tiny_table(name)
    tp = tproblems.get(name)
    _, ts = _jstate(name, table, 1 << 12, True)
    tt = tp.make_tables(table, device="cpu")
    ts = tdevice.generic_step(tp, tt, lb, 8, ts)
    before = convert.state_to_numpy(ts)
    with no_read_back():
        out = tdevice.generic_step(tp, tt, lb, 8, ts,
                                   active=torch.tensor(False))
    after = convert.state_to_numpy(out)
    _assert_same(before, after, f"{name} inactive")


# ------------------------------------------------------ run / solve

@pytest.mark.parametrize("name", ["knapsack", "nqueens", "pfsp", "tsp"])
def test_run_problem_matches_jax(name):
    table = tiny_table(name)
    tp, jp = tproblems.get(name), jproblems.get(name)
    jt, tt = jp.make_tables(table), tp.make_tables(table, device="cpu")
    lb = jp.default_lb
    for max_iters, steps in ((5, 3), (11, 32), (None, 4)):
        js, ts = _jstate(name, table, 1 << 14, False)
        jo = jdevice.run_problem(jp, jt, js, lb, 8, max_iters=max_iters)
        to = tdevice.run_problem(tp, tt, ts, lb, 8, max_iters=max_iters,
                                 steps_per_check=steps)
        _assert_same(_arrays(jo), convert.state_to_numpy(to),
                     f"{name} max_iters={max_iters} K={steps}")
    # a pool already above its usable rows reports overflow untouched
    js, ts = _jstate(name, table, 8 * tp.branching(table), False)
    to = tdevice.run_problem(tp, tt, ts, lb, 8)
    assert bool(to.overflow) and int(to.iters) == 0


def _jsolve(name, table, **kw):
    r = jdevice.solve(name, table, **kw)
    return (r.explored_tree, r.explored_sol, r.best, r.iters, r.evals,
            r.complete)


def _tsolve(name, table, **kw):
    r = tdevice.solve(name, table, device="cpu", **kw)
    return (r.explored_tree, r.explored_sol, r.best, r.iters, r.evals,
            r.complete)


@pytest.mark.parametrize("name,lb", GENERIC + [("pfsp", 0), ("pfsp", 1),
                                               ("pfsp", 2)])
def test_solve_matches_jax(name, lb):
    table = tiny_table(name)
    kw = dict(lb_kind=lb, chunk=8, capacity=1 << 14)
    assert _tsolve(name, table, **kw) == _jsolve(name, table, **kw)


@pytest.mark.parametrize("name", ["knapsack", "nqueens", "tsp"])
def test_solve_grows_on_overflow(name, monkeypatch):
    """A pool of a few usable rows overflows and doubles until the solve
    fits; the result is JAX's, and a large pool's but for the overflowed
    steps' iterations."""
    table = tiny_table(name)
    tp = tproblems.get(name)
    small = 8 * tp.branching(table) + 4
    grows = []
    from tpu_tree_search_torch.engine import checkpoint
    real = checkpoint.grow
    monkeypatch.setattr(checkpoint, "grow",
                        lambda s, c: grows.append(c) or real(s, c))
    got = _tsolve(name, table, chunk=8, capacity=small)
    assert grows and grows[0] == 2 * small
    assert got == _jsolve(name, table, chunk=8, capacity=small)
    # each overflowed step counts its iteration and nothing else
    big = _tsolve(name, table, chunk=8, capacity=1 << 14)
    assert got[3] == big[3] + len(grows)
    assert got[:3] + got[4:] == big[:3] + big[4:]


def test_solve_with_telemetry_counts_as_without():
    table = tiny_table("tsp")
    on = tdevice.solve("tsp", table, chunk=8, capacity=1 << 12,
                       device="cpu", telemetry=True)
    off = tdevice.solve("tsp", table, chunk=8, capacity=1 << 12,
                        device="cpu", telemetry=False)
    assert on.telemetry is not None and off.telemetry is None
    assert on._replace(telemetry=None) == off


# ------------------------------------------------------------- goldens

@pytest.mark.parametrize("lb", [1, 2])
def test_tsp_goldens(lb):
    assert ttsp.TSPInstance(6, ttsp.GOLDEN_D).brute_force_optimum() == \
        ttsp.GOLDEN_OPTIMUM
    r = tdevice.solve("tsp", ttsp.GOLDEN_D, lb_kind=lb, chunk=8,
                      capacity=1 << 12, device="cpu")
    assert r.complete and r.best == ttsp.GOLDEN_OPTIMUM
    inst = ttsp.TSPInstance.synthetic(8, seed=5)
    r = tdevice.solve("tsp", inst.d, lb_kind=lb, chunk=16,
                      capacity=1 << 14, device="cpu")
    assert r.best == inst.brute_force_optimum()


@pytest.mark.parametrize("lb", [1, 2])
@pytest.mark.parametrize("key", ["p01", "p02"])
def test_knapsack_goldens(key, lb):
    inst, opt = tks.GOLDEN[key]
    assert inst.optimum() == opt
    r = tdevice.solve("knapsack", inst.table, lb_kind=lb, chunk=8,
                      capacity=1 << 12, device="cpu")
    assert r.complete
    assert tproblems.get("knapsack").display_objective(r.best) == opt
    # an objective seed at the optimum prunes everything below it: the
    # optimum is never improved on
    seeded = tdevice.solve("knapsack", inst.table, lb_kind=lb,
                           init_ub=-opt, chunk=8, capacity=1 << 12,
                           device="cpu")
    assert seeded.best == -opt


@pytest.mark.parametrize("n", [4, 5, 6, 7, 8])
def test_nqueens_matches_oracle(n):
    r = tnq.search(n, chunk=16, capacity=1 << 14, device="cpu")
    o = tseq.nqueens_search(n)
    assert (r.explored_tree, r.explored_sol) == \
        (o.explored_tree, o.explored_sol)
    assert r.explored_sol == tnq.SOLUTION_COUNTS[n]
    # g scales the work only
    assert tnq.search(n, g=3, chunk=16, capacity=1 << 14,
                      device="cpu")[:2] == r[:2]


def test_pfsp_plugin_takes_the_pfsp_step():
    """solve('pfsp') runs `device.step` (never `generic_step`) and gives
    `device.search`'s counts."""
    p = tpfsp.PFSPInstance.synthetic(jobs=8, machines=4, seed=2).p_times
    calls = {"step": 0, "generic": 0}
    real_step, real_generic = tdevice.step, tdevice.generic_step

    def counted(fn, key):
        def f(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return f

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdevice, "step", counted(real_step, "step"))
        mp.setattr(tdevice, "generic_step", counted(real_generic, "generic"))
        r = tdevice.solve("pfsp", p, lb_kind=2, init_ub=None, chunk=8,
                          capacity=1 << 12, device="cpu")
    s = tdevice.search(p, lb_kind=2, chunk=8, capacity=1 << 12,
                       device="cpu")
    assert calls["step"] > 0 and calls["generic"] == 0
    assert r == s
    assert r.best == tpfsp.PFSPInstance(0, 8, 4, p).brute_force_optimum()


# ------------------------------------------------------------ commands

def _cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv,name,table,kw", [
    (["--problem", "knapsack", "--size", "12", "--seed", "4", "-l", "2"],
     "knapsack", tks.KnapsackInstance.synthetic(12, 4).table,
     dict(lb_kind=2)),
    (["--problem", "tsp", "--size", "7", "--seed", "1"], "tsp",
     ttsp.TSPInstance.synthetic(7, 1).d, dict(lb_kind=1)),
    (["--problem", "pfsp", "-i", "2", "-l", "1", "-u", "1359"], "pfsp",
     None, dict(lb_kind=1, init_ub=1359)),
    (["--problem", "nqueens", "--size", "6"], "nqueens", tnq.table(6),
     dict(lb_kind=0)),
    (["--problem", "pfsp", "--size", "6", "--machines", "3", "--seed", "2",
      "-l", "2"], "pfsp",
     tpfsp.PFSPInstance.synthetic(6, 3, seed=2).p_times, dict(lb_kind=2)),
])
def test_solve_command_gives_jax_numbers(argv, name, table, kw):
    import json

    from tpu_tree_search.problems import taillard as jtaillard
    if table is None:
        table = jtaillard.processing_times(2)
    rc, out, _ = _cli(["solve", *argv, "--device", "cpu"])
    assert rc == 0
    assert f"GPU B&B problem={name} shape=" in out
    res = json.loads(out.strip().splitlines()[-1])
    want = jdevice.solve(name, table, chunk=64, **kw)
    jp = jproblems.get(name)
    assert res == {**res, "problem": name,
                   "explored_tree": want.explored_tree,
                   "explored_sol": want.explored_sol, "best": want.best,
                   "objective": jp.display_objective(want.best),
                   "complete": True}
    assert set(res) == {"problem", "explored_tree", "explored_sol", "best",
                        "objective", "complete", "elapsed_s"}


def test_solve_command_reads_an_instance_file(tmp_path):
    import json

    path = tmp_path / "tsp.json"
    path.write_text(json.dumps(ttsp.GOLDEN_D.tolist()))
    rc, out, _ = _cli(["solve", "--problem", "tsp", "--instance-json",
                       str(path), "-l", "2", "--device", "cpu"])
    assert rc == 0
    assert json.loads(out.strip().splitlines()[-1])["best"] == \
        ttsp.GOLDEN_OPTIMUM


def test_nqueens_command_gives_jax_numbers():
    from tpu_tree_search.problems import nqueens as jnq
    rc, out, _ = _cli(["nqueens", "-N", "7", "-g", "2", "--chunk", "32",
                       "--device", "cpu"])
    want = jnq.search(7, g=2, chunk=32, capacity=1 << 20)
    assert rc == 0
    assert "GPU N-Queens (1 device(s))" in out
    assert "Resolution of the 7-Queens instance" in out
    assert "  with 2 safety check(s) per evaluation" in out
    assert f"Size of the explored tree: {want.explored_tree}" in out
    assert f"Number of explored solutions: {want.explored_sol}" in out


@pytest.mark.parametrize("argv", [
    ["nqueens", "-N", "6", "-D", "4"],
    ["solve", "--problem", "tsp", "--size", "6", "-D", "2"]])
def test_more_than_one_device_is_refused(argv, monkeypatch):
    """On the card `-D n` needs n visible cards: a one-card machine
    refuses more, naming the count, before any search starts (`--device
    cpu` runs n workers on the CPU: tests/test_torch_distributed.py)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc, out, err = _cli(argv)
    n = argv[argv.index("-D") + 1]
    assert rc == 2 and f"need {n} devices, have 1" in err
    assert "explored" not in out


def test_solve_command_refusals():
    rc, _, err = _cli(["solve", "--problem", "sudoku", "--size", "4",
                       "--device", "cpu"])
    assert rc == 2 and "unknown problem" in err
    rc, _, err = _cli(["solve", "--problem", "tsp", "--size", "2",
                       "--device", "cpu"])
    assert rc == 2 and "invalid instance" in err
    with pytest.raises(SystemExit, match="PFSP-only"):
        _cli(["solve", "--problem", "tsp", "-i", "3", "--device", "cpu"])
