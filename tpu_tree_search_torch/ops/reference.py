"""Scalar numpy reference implementations of the PFSP lower bounds.

The port's own copy of `tpu_tree_search/ops/reference.py` (`make_lb1_data`,
`make_lb2_data`, `prefix_front_remain` and the scalar oracles): numpy only,
kept here so the port never imports the JAX package.

These are the ground-truth semantics for LB1 / LB1_d / LB2, written for
clarity and used (a) by the sequential oracle engine and (b) as the golden
values the batched bound code and its kernels are tested against. The math follows
the reference exactly:

- LB1  one-machine bound         (reference: pfsp/lib/c_bound_simple.c:143-158)
- LB1_d incremental all-children (reference: c_bound_simple.c:160-244)
- LB2  two-machine Johnson bound (reference: pfsp/lib/c_bound_johnson.c:211-254)

Conventions: `p_times` is (machines, jobs); a partial permutation `perm`
has its scheduled prefix at positions `0..limit1` and suffix at
`limit2..jobs-1` (all engines here branch forward only, so `limit2 == jobs`
and the suffix is empty — kept general to match the reference signatures).
"""

from __future__ import annotations

import dataclasses

import numpy as np


# ---------------------------------------------------------------------------
# LB1: one-machine bound


@dataclasses.dataclass
class LB1Data:
    """Precomputed tables for LB1 (reference: c_bound_simple.h:51-53)."""

    p_times: np.ndarray    # (machines, jobs) int
    min_heads: np.ndarray  # (machines,) earliest possible arrival at machine k
    min_tails: np.ndarray  # (machines,) minimal run-out after machine k


def make_lb1_data(p_times: np.ndarray) -> LB1Data:
    """Precompute min_heads/min_tails (reference: c_bound_simple.c:277-322).

    min_heads[k] = min over jobs of the completion time of the job on
    machine k-1 when it runs first (the earliest any job can reach machine
    k); min_tails[k] = min over jobs of the tail below machine k when the
    job runs last.
    """
    p = np.asarray(p_times, dtype=np.int64)
    m, n = p.shape

    heads = np.cumsum(p, axis=0)              # (m, n): head of job j through mach k
    min_heads = np.empty(m, dtype=np.int64)
    min_heads[0] = 0
    if m > 1:
        min_heads[1:] = heads[:-1].min(axis=1)

    tails = np.cumsum(p[::-1], axis=0)[::-1]  # (m, n): tail of job j from mach k down
    min_tails = np.empty(m, dtype=np.int64)
    min_tails[m - 1] = 0
    if m > 1:
        min_tails[:-1] = tails[1:].min(axis=1)

    return LB1Data(p_times=p, min_heads=min_heads, min_tails=min_tails)


def add_forward(job: int, p: np.ndarray, front: np.ndarray) -> None:
    """Append `job` to the prefix schedule (reference: c_bound_simple.c:31-38)."""
    front[0] += p[0, job]
    for k in range(1, p.shape[0]):
        front[k] = max(front[k - 1], front[k]) + p[k, job]


def add_backward(job: int, p: np.ndarray, back: np.ndarray) -> None:
    """Prepend `job` to the suffix schedule (reference: c_bound_simple.c:40-49)."""
    m = p.shape[0]
    back[m - 1] += p[m - 1, job]
    for k in range(m - 2, -1, -1):
        back[k] = max(back[k], back[k + 1]) + p[k, job]


def schedule_front(data: LB1Data, perm, limit1: int) -> np.ndarray:
    """Machine completion times of the prefix (reference: c_bound_simple.c:51-69)."""
    m = data.p_times.shape[0]
    if limit1 == -1:
        return data.min_heads.copy()
    front = np.zeros(m, dtype=np.int64)
    for i in range(limit1 + 1):
        add_forward(int(perm[i]), data.p_times, front)
    return front


def schedule_back(data: LB1Data, perm, limit2: int) -> np.ndarray:
    """Machine tail times of the suffix (reference: c_bound_simple.c:71-90)."""
    m, n = data.p_times.shape
    if limit2 == n:
        return data.min_tails.copy()
    back = np.zeros(m, dtype=np.int64)
    for i in range(n - 1, limit2 - 1, -1):
        add_backward(int(perm[i]), data.p_times, back)
    return back


def sum_unscheduled(data: LB1Data, perm, limit1: int, limit2: int) -> np.ndarray:
    """Total unscheduled work per machine (reference: c_bound_simple.c:108-124)."""
    jobs = [int(perm[k]) for k in range(limit1 + 1, limit2)]
    if not jobs:
        return np.zeros(data.p_times.shape[0], dtype=np.int64)
    return data.p_times[:, jobs].sum(axis=1).astype(np.int64)


def machine_bound_from_parts(front, back, remain) -> int:
    """Chained per-machine bound (reference: c_bound_simple.c:126-141).

    On machine i the earliest completion of all remaining work is
    max_{j<=i}(chain) + remain contributions carried through a running max —
    note this is *not* simply max_i(front+remain+back); the running value
    `tmp0` threads machine-to-machine precedence.
    """
    m = len(front)
    tmp0 = int(front[0]) + int(remain[0])
    lb = tmp0 + int(back[0])
    for i in range(1, m):
        tmp1 = max(tmp0, int(front[i]) + int(remain[i]))
        lb = max(lb, tmp1 + int(back[i]))
        tmp0 = tmp1
    return lb


def lb1_bound(data: LB1Data, perm, limit1: int, limit2: int) -> int:
    """Full LB1 of one partial permutation (reference: c_bound_simple.c:143-158)."""
    front = schedule_front(data, perm, limit1)
    back = schedule_back(data, perm, limit2)
    remain = sum_unscheduled(data, perm, limit1, limit2)
    return machine_bound_from_parts(front, back, remain)


def add_front_and_bound(data: LB1Data, job: int, front, back, remain) -> int:
    """Bound of the child obtained by appending `job` to the prefix, computed
    incrementally from the parent's front/back/remain in O(machines)
    (reference: c_bound_simple.c:218-244). This is the LB1_d bound; its value
    differs from LB1's chained `machine_bound_from_parts` in general.
    """
    p = data.p_times
    m = p.shape[0]
    lb = int(front[0]) + int(remain[0]) + int(back[0])
    tmp0 = int(front[0]) + int(p[0, job])
    for i in range(1, m):
        tmp1 = max(tmp0, int(front[i]))
        lb = max(lb, tmp1 + int(remain[i]) + int(back[i]))
        tmp0 = tmp1 + int(p[i, job])
    return lb


def lb1_children_bounds(data: LB1Data, perm, limit1: int, limit2: int) -> np.ndarray:
    """LB1_d bounds of all children at once, indexed by job id
    (reference: c_bound_simple.c:160-211)."""
    n = data.p_times.shape[1]
    front = schedule_front(data, perm, limit1)
    back = schedule_back(data, perm, limit2)
    remain = sum_unscheduled(data, perm, limit1, limit2)
    lb_begin = np.zeros(n, dtype=np.int64)
    for i in range(limit1 + 1, limit2):
        job = int(perm[i])
        lb_begin[job] = add_front_and_bound(data, job, front, back, remain)
    return lb_begin


def prefix_front_remain(p_times: np.ndarray, prmu: np.ndarray,
                        depth: np.ndarray) -> np.ndarray:
    """Per-node pool auxiliary data `[front | remain]` (n, 2*machines) int32.

    `front` is the actual machine-completion vector of the scheduled prefix
    (zeros for an empty prefix — children chain from the parent's true
    front, not from min_heads) and `remain` the per-machine unscheduled
    work. This is what the device engines carry in the pool so bounds never
    rescan the prefix (the reference recomputes it per bound,
    c_bound_simple.c:51-69).
    """
    p = np.asarray(p_times, dtype=np.int64)
    m = p.shape[0]
    prmu = np.asarray(prmu).reshape(-1, p.shape[1])
    depth = np.asarray(depth).reshape(-1).astype(np.int64)
    front = np.zeros((prmu.shape[0], m), dtype=np.int64)
    sched = np.zeros((prmu.shape[0], m), dtype=np.int64)
    # add_forward of the i-th scheduled job, over every node at once (a
    # warm-up frontier holds some 10^5 of them)
    for i in range(int(depth.max(initial=0))):
        on = depth > i
        pj = p[:, prmu[on, i].astype(np.int64)].T          # (nodes, m)
        f = front[on]
        f[:, 0] += pj[:, 0]
        for k in range(1, m):
            f[:, k] = np.maximum(f[:, k - 1], f[:, k]) + pj[:, k]
        front[on] = f
        sched[on] += pj
    out = np.zeros((prmu.shape[0], 2 * m), dtype=np.int32)
    out[:, :m] = front
    out[:, m:] = p.sum(axis=1) - sched
    return out


def eval_solution(data: LB1Data, perm) -> int:
    """Makespan of a complete permutation (reference: c_bound_simple.c:92-106)."""
    front = np.zeros(data.p_times.shape[0], dtype=np.int64)
    for job in perm:
        add_forward(int(job), data.p_times, front)
    return int(front[-1])


# ---------------------------------------------------------------------------
# LB2: two-machine Johnson bound (LB2_FULL variant: all machine pairs)


@dataclasses.dataclass
class LB2Data:
    """Precomputed tables for LB2 (reference: c_bound_johnson.h:32-49).

    For each ordered machine pair (m1 < m2): `lags[p, j]` is the total
    processing of job j on the machines strictly between m1 and m2
    (term q_iuv of [Lageweg'78]); `johnson_schedules[p]` is the optimal
    2-machine order of all jobs for the pair under Johnson's rule.
    """

    pairs_m1: np.ndarray            # (P,) first machine of each pair
    pairs_m2: np.ndarray            # (P,) second machine
    lags: np.ndarray                # (P, jobs)
    johnson_schedules: np.ndarray   # (P, jobs) job ids in Johnson order


def make_lb2_data(lb1: LB1Data) -> LB2Data:
    """Build all-pairs Johnson tables (reference: c_bound_johnson.c:48-178).

    Ties under Johnson's comparator are broken stably by job id (the
    reference uses qsort, whose tie order is unspecified); any
    tie-consistent order is Johnson-optimal so the bound values — and hence
    search trees — are unaffected.
    """
    p = lb1.p_times
    m, n = p.shape
    m1s, m2s = [], []
    for i in range(m - 1):
        for j in range(i + 1, m):
            m1s.append(i)
            m2s.append(j)
    pairs_m1 = np.array(m1s, dtype=np.int64)
    pairs_m2 = np.array(m2s, dtype=np.int64)
    npairs = len(m1s)

    # cumulative sums make lag(m1, m2) = sum of rows m1+1..m2-1 an O(1) lookup
    csum = np.concatenate([np.zeros((1, n), dtype=np.int64),
                           np.cumsum(p, axis=0)])
    lags = csum[pairs_m2] - csum[pairs_m1 + 1]          # (P, n)

    ptm1 = p[pairs_m1] + lags                           # (P, n)
    ptm2 = p[pairs_m2] + lags
    partition = (ptm1 >= ptm2).astype(np.int64)         # 0: ptm1 < ptm2
    # partition 0 first by ascending ptm1; partition 1 by descending ptm2
    within = np.where(partition == 0, ptm1, -ptm2)
    order = np.lexsort((within, partition), axis=-1)    # stable; last key primary
    johnson = order.astype(np.int64)                    # (P, n) job ids

    return LB2Data(pairs_m1=pairs_m1, pairs_m2=pairs_m2, lags=lags,
                   johnson_schedules=johnson)


def set_flags(perm, limit1: int, limit2: int, n: int) -> np.ndarray:
    """1 for scheduled job ids, 0 for unscheduled (reference: c_bound_johnson.c:180-188)."""
    flags = np.zeros(n, dtype=np.int64)
    for j in range(limit1 + 1):
        flags[int(perm[j])] = 1
    for j in range(limit2, n):
        flags[int(perm[j])] = 1
    return flags


def compute_cmax_johnson(lb1: LB1Data, lb2: LB2Data, flags, tmp0: int, tmp1: int,
                         ma0: int, ma1: int, pair: int) -> tuple[int, int]:
    """Simulate the 2-machine schedule of the unscheduled jobs in Johnson
    order with lags as transfer delays (reference: c_bound_johnson.c:190-209)."""
    p = lb1.p_times
    n = p.shape[1]
    for j in range(n):
        job = int(lb2.johnson_schedules[pair, j])
        if flags[job] == 0:
            lag = int(lb2.lags[pair, job])
            tmp0 += int(p[ma0, job])
            tmp1 = max(tmp1, tmp0 + lag)
            tmp1 += int(p[ma1, job])
    return tmp0, tmp1


def lb_makespan(lb1: LB1Data, lb2: LB2Data, flags, front, back,
                min_cmax: int) -> int:
    """Max of the two-machine bounds over all machine pairs, with the
    reference's early exit once the bound exceeds `min_cmax`
    (reference: c_bound_johnson.c:211-237). The early exit never changes
    pruning decisions (any early-exited value already exceeds the best)."""
    lb = 0
    for pair in range(len(lb2.pairs_m1)):
        ma0 = int(lb2.pairs_m1[pair])
        ma1 = int(lb2.pairs_m2[pair])
        tmp0, tmp1 = int(front[ma0]), int(front[ma1])
        tmp0, tmp1 = compute_cmax_johnson(lb1, lb2, flags, tmp0, tmp1, ma0, ma1, pair)
        tmp1 = max(tmp1 + int(back[ma1]), tmp0 + int(back[ma0]))
        lb = max(lb, tmp1)
        if lb > min_cmax:
            break
    return lb


def lb2_bound(lb1: LB1Data, lb2: LB2Data, perm, limit1: int, limit2: int,
              best_cmax: int) -> int:
    """Full LB2 of one partial permutation (reference: c_bound_johnson.c:239-254)."""
    front = schedule_front(lb1, perm, limit1)
    back = schedule_back(lb1, perm, limit2)
    flags = set_flags(perm, limit1, limit2, lb1.p_times.shape[1])
    return lb_makespan(lb1, lb2, flags, front, back, best_cmax)
