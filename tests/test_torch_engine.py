"""The port's engine against the JAX engine and the sequential oracle.

Step-by-step: the same JAX state goes through `device.step` of both
packages (crossing by `convert`), and after every step the counters and
the live pool region `[0, size)` must be equal. Whole solves: counts equal
to the sequential oracle and to the reference's goldens. All exact."""

import functools
import json
import pathlib

import jax
import numpy as np
import pytest

from tpu_tree_search.engine import device as jdevice, sequential as seq
from tpu_tree_search.ops import batched as jbatched
from tpu_tree_search.problems import taillard
from tpu_tree_search.problems.pfsp import PFSPInstance
from tpu_tree_search_torch import convert, profile_step
from tpu_tree_search_torch.engine import checkpoint as tcheckpoint
from tpu_tree_search_torch.engine import device as tdevice
from tpu_tree_search_torch.ops import batched as tbatched

import _torch_threads

_torch_threads.share_cores()

GOLDEN = pathlib.Path(__file__).parent / "golden"
_FIELDS = ("prmu", "depth", "aux", "size", "best", "tree", "sol", "iters",
           "evals", "sent", "recv", "steals", "overflow", "telemetry")
_jstep = jax.jit(jdevice.step, static_argnums=(1, 2),
                 static_argnames=("tile",))


def _jnp_state(s) -> dict:
    return {f: np.asarray(getattr(s, f)) for f in _FIELDS}


def _assert_same(want: dict, got: dict, where: str):
    for f in ("size", "best", "tree", "sol", "iters", "evals", "overflow"):
        assert int(got[f]) == int(want[f]), f"{where}: {f}"
    n = int(want["size"])
    for f in ("prmu", "aux"):
        assert got[f].dtype == want[f].dtype, f"{where}: {f} dtype"
        np.testing.assert_array_equal(got[f][:, :n], want[f][:, :n],
                                      err_msg=f"{where}: {f}")
    np.testing.assert_array_equal(got["depth"][:n], want["depth"][:n],
                                  err_msg=f"{where}: depth")


def _step_parity(p, lb_kind, chunk, tile, steps, init_ub=None, route=None,
                 capacity=1 << 14):
    jobs = p.shape[1]
    jt = jbatched.make_tables(p)
    tt = tbatched.make_tables(p, device="cpu")
    js = jdevice.init_state(jobs, capacity, init_ub, p_times=p,
                            telemetry=False)
    ts = convert.state_from_numpy(_jnp_state(js), device="cpu")
    seen_sizes = []
    for k in range(steps):
        js = _jstep(jt, lb_kind, chunk, js, tile=tile)
        ts = tdevice.step(tt, lb_kind, chunk, ts, tile=tile, route=route)
        want = _jnp_state(js)
        _assert_same(want, convert.state_to_numpy(ts), f"step {k + 1}")
        seen_sizes.append(int(want["size"]))
    return seen_sizes


def _instance(jobs, machines, seed):
    return PFSPInstance.synthetic(jobs=jobs, machines=machines,
                                  seed=seed).p_times


@pytest.mark.parametrize("lb_kind", [0, 1, 2])
def test_step_parity_multi_tile(lb_kind):
    # 8 machines: 28 pairs, so LB2 runs the head/tail prefilter split;
    # chunk 32 at tile 16 gives two tiles per step
    p = _instance(10, 8, 11)
    sizes = _step_parity(p, lb_kind, chunk=32, tile=16, steps=12)
    assert max(sizes) > 32          # the pool really grew past one chunk


def test_step_parity_lb2_three_frames():
    # N = 256*8 = 2048: the prefilter picks among the N/4, 3N/8 and N
    # frames (the lax.switch of the JAX step) by the LB1 survivor count
    p = _instance(8, 8, 5)
    _step_parity(p, 2, chunk=256, tile=128, steps=10)


def test_step_parity_calibrated_pairs():
    # 12 machines: 66 pairs > 48, so the pair order is the calibrated one
    p = _instance(9, 12, 2)
    _step_parity(p, 2, chunk=64, tile=32, steps=10)


def test_dense_route_matches_prefilter_state():
    """The dense LB2 route (the one CUDA takes on few-pair classes; only a
    forced route reaches it on the CPU) pushes the same children in the
    same order as JAX's prefilter route."""
    p = _instance(10, 5, 3)
    _step_parity(p, 2, chunk=64, tile=32, steps=10, route="dense")


@pytest.mark.parametrize("jobs,machines,seed,chunk,tile,steps", [
    (10, 6, 7, 64, 16, 10),     # four tiles
    (36, 4, 9, 16, 4, 6)])      # four tiles, two scheduled-set words
def test_dense_route_step_parity_several_tiles(jobs, machines, seed, chunk,
                                               tile, steps):
    """The dense step's bounds come from `expand_bounds(lb_kind=2)` (on the
    card the expand kernel's fronts-only launch, then the pair sweep): at a
    tile that gives several tiles its states equal JAX's step by step."""
    p = _instance(jobs, machines, seed)
    sizes = _step_parity(p, 2, chunk=chunk, tile=tile, steps=steps,
                         route="dense")
    assert max(sizes) > chunk


def test_convert_round_trip():
    """Pool, counters and the telemetry vector, off (width 0) and on
    (width 60, after a few JAX steps so that it holds counts)."""
    p = _instance(7, 4, 0)
    jt = jbatched.make_tables(p)
    for telemetry in (False, True):
        js = jdevice.init_state(7, 256, 500, p_times=p, telemetry=telemetry)
        for _ in range(3):
            js = _jstep(jt, 1, 8, js, tile=8)
        want = _jnp_state(js)
        assert want["telemetry"].shape == ((60,) if telemetry else (0,))
        assert want["telemetry"].any() == telemetry
        got = convert.state_to_numpy(convert.state_from_numpy(want, "cpu"))
        for f in _FIELDS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        for f in ("prmu", "depth", "aux", "telemetry"):
            assert got[f].dtype == want[f].dtype, f


@functools.lru_cache(maxsize=None)
def _oracle(jobs, machines, seed, lb_kind):
    inst = PFSPInstance.synthetic(jobs=jobs, machines=machines, seed=seed)
    opt = seq.pfsp_search(inst, lb=2, init_ub=None).best
    want = seq.pfsp_search(inst, lb=lb_kind, init_ub=opt)
    return inst.p_times, opt, (want.explored_tree, want.explored_sol,
                               want.best)


@pytest.mark.parametrize("jobs,machines,seed", [(7, 4, 0), (8, 5, 1),
                                                (9, 3, 2)])
@pytest.mark.parametrize("lb_kind", [0, 1, 2])
def test_search_matches_oracle_ub_opt(jobs, machines, seed, lb_kind):
    p, opt, want = _oracle(jobs, machines, seed, lb_kind)
    got = tdevice.search(p, lb_kind=lb_kind, init_ub=opt, chunk=8,
                         capacity=1 << 12, device="cpu")
    assert (got.explored_tree, got.explored_sol, got.best) == want


@pytest.mark.parametrize("lb_kind", [0, 1, 2])
def test_search_finds_optimum_ub_inf(lb_kind):
    p, opt, _ = _oracle(8, 4, 3, 1)
    got = tdevice.search(p, lb_kind=lb_kind, init_ub=None, chunk=8,
                         capacity=1 << 12, device="cpu")
    assert got.best == opt and got.complete


def _lb1_goldens():
    rows = []
    for name in ("pfsp_lb1_ub1.jsonl", "pfsp_lb1d_ub1.jsonl"):
        rows += [json.loads(l) for l in (GOLDEN / name).read_text()
                 .splitlines()]
    return [r for r in rows if r["complete"] and r["inst"] in (2, 19)]


@pytest.mark.parametrize("case", _lb1_goldens(),
                         ids=lambda c: f"ta{c['inst']:03d}_lb{c['lb']}")
def test_taillard_lb1_goldens(case):
    p = taillard.processing_times(case["inst"])
    out = tdevice.search(p, lb_kind=case["lb"],
                         init_ub=taillard.optimal_makespan(case["inst"]),
                         chunk=64, capacity=1 << 16, device="cpu")
    assert (out.explored_tree, out.explored_sol, out.best) == \
           (case["tree"], case["sol"], case["best"])


def test_overflow_recovery():
    """A deliberately tiny pool overflows; grow + resume keeps the counts
    of an ample pool."""
    p, opt, want = _oracle(8, 4, 5, 1)
    got = tdevice.search(p, lb_kind=1, init_ub=opt, chunk=8, capacity=16,
                         device="cpu")
    assert (got.explored_tree, got.explored_sol, got.best) == want


def test_overflow_step_commits_nothing():
    p = _instance(8, 4, 6)
    tt = tbatched.make_tables(p, device="cpu")
    state = tdevice.init_state(8, 128, None, p_times=p, device="cpu")
    state = tdevice.run(tt, state, 1, 8, max_iters=3)
    before = convert.state_to_numpy(state)
    c = tdevice.counters(state)
    # with ub=inf the next step pushes more than it pops, so a limit at
    # the cursor makes it overflow: only iters and the flag move
    after = tdevice.step(tt, 1, 8, state, limit=c.size)
    a = tdevice.counters(after)
    assert a.overflow and a.iters == c.iters + 1
    assert (a.size, a.tree, a.sol, a.evals, a.best) == \
        (c.size, c.tree, c.sol, c.evals, c.best)
    n = c.size
    np.testing.assert_array_equal(after.prmu[:, :n].numpy(),
                                  before["prmu"][:, :n])
    grown = tcheckpoint.grow(after, 512)
    assert not grown.overflow and grown.prmu.shape == (8, 512)
    np.testing.assert_array_equal(grown.aux[:, :n].numpy(),
                                  before["aux"][:, :n])


def test_max_iters_truncation():
    p = _instance(8, 4, 6)
    got = tdevice.search(p, lb_kind=1, init_ub=None, chunk=4,
                         capacity=1 << 12, max_iters=3, device="cpu")
    assert got.iters == 3 and not got.complete


@pytest.mark.parametrize("loop", ["graph", "eager"])
def test_profile_step_on_cpu(loop):
    """The profiling window runs the main path, through `run` or through
    `step`; with no device trace its device fields stay null rather than
    carry host numbers."""
    out = profile_step.profile(2, 1, 64, 1 << 12, warm=2, steps=3,
                               dev=tdevice.resolve_device("cpu"), loop=loop)
    assert out["steps"] == 3 and out["evals"] > 0 and out["loop"] == loop
    assert out["peak_memory_bytes"] is None
    assert out["device_busy_share"] is None and out["top_device_ops"] is None
    assert profile_step._busy_us([(0, 2), (1, 3), (5, 6), (5.5, 5.8)]) == 4
