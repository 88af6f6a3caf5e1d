"""The port's sequential oracles and `PFSPInstance` against the JAX
package's: `pfsp_search` at every bound kind with and without the
optimum as incumbent, truncated by `max_nodes`; `nqueens_search` at
N = 4..9, truncated too; the instance helpers. All exact; inputs from
numpy seeds."""

import numpy as np
import pytest

from tpu_tree_search.engine import sequential as jseq
from tpu_tree_search.problems import pfsp as jpfsp
from tpu_tree_search_torch.engine import sequential as tseq
from tpu_tree_search_torch.problems import nqueens as tnq, pfsp as tpfsp


import _torch_threads

_torch_threads.share_cores()


def _triple(r):
    return (r.explored_tree, r.explored_sol, r.best, r.complete)


@pytest.mark.parametrize("lb", [0, 1, 2])
@pytest.mark.parametrize("jobs,machines,seed", [(6, 3, 0), (7, 4, 1),
                                                (8, 3, 2)])
def test_pfsp_search_matches_jax(jobs, machines, seed, lb):
    t = tpfsp.PFSPInstance.synthetic(jobs, machines, seed)
    j = jpfsp.PFSPInstance.synthetic(jobs, machines, seed)
    np.testing.assert_array_equal(t.p_times, j.p_times)
    got = tseq.pfsp_search(t, lb)
    assert _triple(got) == _triple(jseq.pfsp_search(j, lb))
    opt = t.brute_force_optimum()
    assert got.best == opt == j.brute_force_optimum()
    # with the optimum as incumbent the tree is order-independent
    assert _triple(tseq.pfsp_search(t, lb, init_ub=opt)) == \
        _triple(jseq.pfsp_search(j, lb, init_ub=opt))
    cut = tseq.pfsp_search(t, lb, max_nodes=5)
    assert not cut.complete
    assert _triple(cut) == _triple(jseq.pfsp_search(j, lb, max_nodes=5))


def test_pfsp_search_taillard_golden():
    """ta002 LB1 with the optimum: the reference's golden tree (30)."""
    inst = tpfsp.PFSPInstance.from_taillard(2)
    r = tseq.pfsp_search(inst, tseq.LB1, init_ub=inst.optimum)
    assert (r.explored_tree, r.explored_sol, r.best) == (30, 0, 1359)


@pytest.mark.parametrize("n", [4, 5, 6, 7, 8, 9])
def test_nqueens_search_matches_jax(n):
    got = tseq.nqueens_search(n, g=2)
    assert _triple(got) == _triple(jseq.nqueens_search(n))
    assert got.explored_sol == tnq.SOLUTION_COUNTS[n]
    cut = tseq.nqueens_search(n, max_nodes=7)
    assert _triple(cut) == _triple(jseq.nqueens_search(n, max_nodes=7))


@pytest.mark.parametrize("inst", [1, 14, 31, 71])
def test_pfsp_instance_matches_jax(inst):
    t, j = tpfsp.PFSPInstance.from_taillard(inst), \
        jpfsp.PFSPInstance.from_taillard(inst)
    assert (t.inst_id, t.jobs, t.machines, t.optimum) == \
        (j.inst_id, j.jobs, j.machines, j.optimum)
    np.testing.assert_array_equal(t.p_times, j.p_times)
    assert t.p_times.dtype == j.p_times.dtype
    perm = np.random.default_rng(inst).permutation(t.jobs)
    assert t.makespan(perm) == j.makespan(perm)
    assert tpfsp.root_node(t.jobs)[0].tolist() == \
        jpfsp.root_node(j.jobs)[0].tolist()
    assert tpfsp.ROOT_DEPTH == jpfsp.ROOT_DEPTH
    assert tpfsp.PFSPInstance.synthetic(5, 2, 9).optimum is None
    with pytest.raises(ValueError, match="tiny"):
        t.brute_force_optimum()
