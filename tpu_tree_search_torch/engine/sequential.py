"""Sequential branch-and-bound oracles on the host, with the reference's
exact counting.

Reproduces `tpu_tree_search/engine/sequential.py` (`pfsp_search`,
`nqueens_search`, `SearchResult`), on the port's `ops/reference.py`. The
device engines are held to the `(explored_tree, explored_sol, best)`
these give (reference: pfsp/pfsp_c.c:26-73, nqueens/nqueens_c.c:99-148).
With `ub=opt` the PFSP tree does not depend on the exploration order
(the incumbent never improves), so the counts must match exactly; with
`ub=inf` only the optimum must.

Counting (PFSP_lib.c:7-129): `explored_tree` counts every pushed
non-leaf child (the root is pushed, not counted); `explored_sol` counts
every evaluated leaf child; a leaf child below the incumbent improves it
and is not pushed. N-Queens (nqueens_c.c:99-117) pushes every safe child,
complete boards included, and counts a popped depth-N node as a
solution.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..ops import reference as ref
from ..problems import nqueens as nq
from ..problems.pfsp import PFSPInstance

INT_MAX = 2**31 - 1

LB1_D = 0  # incremental all-children one-machine bound ("lb1_d")
LB1 = 1    # full one-machine bound
LB2 = 2    # two-machine Johnson bound


@dataclasses.dataclass
class SearchResult:
    explored_tree: int
    explored_sol: int
    best: int
    complete: bool = True   # False: truncated (max_nodes / deadline_s)


def pfsp_search(instance: PFSPInstance, lb: int = LB1,
                init_ub: int | None = None,
                max_nodes: int | None = None,
                deadline_s: float | None = None) -> SearchResult:
    """Depth-first branch-and-bound over one PFSP instance
    (pfsp_c.c:26-73). `init_ub=None` is an infinite incumbent (`-u 0`).
    `max_nodes` caps the popped nodes and `deadline_s` the wall clock;
    either gives a truncated result (`complete=False`)."""
    jobs = instance.jobs
    lb1 = ref.make_lb1_data(instance.p_times)
    lb2 = ref.make_lb2_data(lb1) if lb == LB2 else None

    best = INT_MAX if init_ub is None else int(init_ub)
    tree = 0
    sol = 0
    # stack of (prmu int16[jobs], depth); root = identity at depth 0
    stack: list[tuple[np.ndarray, int]] = [
        (np.arange(jobs, dtype=np.int16), 0)
    ]
    popped = 0
    deadline = (None if deadline_s is None
                else time.perf_counter() + deadline_s)

    while stack:
        if max_nodes is not None and popped >= max_nodes:
            break
        if (deadline is not None and popped % 256 == 0
                and time.perf_counter() > deadline):
            break
        prmu, depth = stack.pop()
        popped += 1
        limit1 = depth - 1  # forward branching invariant

        if lb == LB1_D:
            lb_begin = ref.lb1_children_bounds(lb1, prmu, limit1, jobs)

        for i in range(depth, jobs):
            child = prmu.copy()
            child[depth], child[i] = child[i], child[depth]
            if lb == LB1:
                bound = ref.lb1_bound(lb1, child, limit1 + 1, jobs)
            elif lb == LB1_D:
                bound = int(lb_begin[int(prmu[i])])
            else:
                bound = ref.lb2_bound(lb1, lb2, child, limit1 + 1, jobs, best)

            if depth + 1 == jobs:           # leaf: complete schedule
                sol += 1
                if bound < best:
                    best = bound
            elif bound < best:              # feasible internal node
                stack.append((child, depth + 1))
                tree += 1

    return SearchResult(explored_tree=tree, explored_sol=sol, best=best,
                        complete=not stack)


def nqueens_search(n: int, g: int = 1,
                   max_nodes: int | None = None) -> SearchResult:
    """Depth-first N-Queens backtracking (nqueens_c.c:119-148). `g` only
    scales the reference's safety-check work; the counts do not depend on
    it, so the oracle ignores it."""
    del g
    tree = 0
    sol = 0
    stack: list[tuple[np.ndarray, int]] = [(np.arange(n, dtype=np.int16), 0)]
    popped = 0

    while stack:
        if max_nodes is not None and popped >= max_nodes:
            break
        board, depth = stack.pop()
        popped += 1
        if depth == n:
            sol += 1
        for j in range(depth, n):
            if nq.is_safe(board, depth, int(board[j])):
                child = board.copy()
                child[depth], child[j] = child[j], child[depth]
                stack.append((child, depth + 1))
                tree += 1

    return SearchResult(explored_tree=tree, explored_sol=sol, best=sol,
                        complete=not stack)
