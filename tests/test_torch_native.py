"""The port's copy of the native host runtime against the oracles.

Mirrors `tests/test_native.py`: the `g++` build (into the port's
`_build/`), the Taillard tables, the DFS oracle at every bound with
ub=opt and ub=inf, the breadth-first warm-up frontier against the port's
Python `bfs_warmup` and the JAX package's native result, N-Queens; plus
the seed-set DFS and the asynchronous session at ub=opt (where the
counts do not depend on the threads' schedule), and the warm-up's loud
fall-back when the runtime cannot load. Exact throughout."""

import numpy as np
import pytest

from tpu_tree_search import native as jnative
from tpu_tree_search_torch import native
from tpu_tree_search_torch.engine import distributed as tdist
from tpu_tree_search_torch.engine import sequential as tseq
from tpu_tree_search_torch.problems import taillard
from tpu_tree_search_torch.problems.pfsp import PFSPInstance


import _torch_threads

_torch_threads.share_cores()


def test_native_builds_into_the_port_build_dir():
    path = native.build()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.name == "_build"


def test_native_taillard_matches_python():
    for inst in (1, 14, 31, 56, 111):
        np.testing.assert_array_equal(native.processing_times(inst),
                                      taillard.processing_times(inst))
        assert native.optimal_makespan(inst) == \
            taillard.optimal_makespan(inst)


@pytest.mark.parametrize("lb_kind", [0, 1, 2])
@pytest.mark.parametrize("ub", ["opt", "inf"])
def test_native_search_matches_oracle(lb_kind, ub):
    inst = PFSPInstance.synthetic(jobs=7, machines=4, seed=11)
    init_ub = inst.brute_force_optimum() if ub == "opt" else None
    want = tseq.pfsp_search(inst, lb=lb_kind, init_ub=init_ub)
    tree, sol, best, _ = native.search(inst.p_times, lb_kind, init_ub)
    assert (tree, sol, best) == \
        (want.explored_tree, want.explored_sol, want.best)


@pytest.mark.parametrize("lb_kind", [0, 1, 2])
def test_native_bfs_frontier_matches_python_and_jax(lb_kind):
    inst = PFSPInstance.synthetic(jobs=8, machines=4, seed=12)
    fr = tdist.bfs_warmup(inst.p_times, lb_kind, None, target=20,
                          use_native=False)
    got = native.bfs_frontier(inst.p_times, lb_kind, None, target=20)
    want = jnative.bfs_frontier(inst.p_times, lb_kind, None, target=20)
    assert got[2:] == (fr.tree, fr.sol, fr.best) == tuple(want[2:])
    for a, b in ((got[0], fr.prmu), (got[1], fr.depth), (got[0], want[0]),
                 (got[1], want[1])):
        np.testing.assert_array_equal(a, b)
    via = tdist.bfs_warmup(inst.p_times, lb_kind, None, target=20)
    np.testing.assert_array_equal(via.prmu, fr.prmu)


def test_warmup_falls_back_loudly(monkeypatch):
    def broken(*args, **kw):
        raise OSError("no toolchain")

    inst = PFSPInstance.synthetic(jobs=8, machines=4, seed=12)
    monkeypatch.setattr(native, "bfs_frontier", broken)
    monkeypatch.setattr(tdist, "_native_warned", False)
    with pytest.warns(RuntimeWarning, match="native host runtime"):
        fr = tdist.bfs_warmup(inst.p_times, 1, None, target=20)
    want = jnative.bfs_frontier(inst.p_times, 1, None, target=20)
    np.testing.assert_array_equal(fr.prmu, want[0])
    assert (fr.tree, fr.sol, fr.best) == tuple(want[2:])


@pytest.mark.parametrize("n", [6, 8, 9])
def test_native_nqueens(n):
    want = tseq.nqueens_search(n)
    tree, sol, _ = native.nqueens(n)
    assert (tree, sol) == (want.explored_tree, want.explored_sol)


def test_seed_set_search_and_async_session_match_oracle():
    inst = PFSPInstance.synthetic(jobs=7, machines=4, seed=11)
    opt = inst.brute_force_optimum()
    want = tseq.pfsp_search(inst, lb=1, init_ub=opt)
    fr = tdist.bfs_warmup(inst.p_times, 1, opt, target=12)
    tree, sol, best, _ = native.search_from(inst.p_times, fr.prmu, fr.depth,
                                            1, opt, n_threads=3)
    assert (tree + fr.tree, sol + fr.sol, best) == \
        (want.explored_tree, want.explored_sol, want.best)
    h = native.async_start(inst.p_times, fr.prmu, fr.depth, 1, opt,
                           n_threads=2)
    native.async_offer(h, opt + 5)        # a worse bound changes nothing
    tree, sol, best, _ = native.async_join(h)
    assert (tree + fr.tree, sol + fr.sol, best) == \
        (want.explored_tree, want.explored_sol, want.best)
