"""Bound tables and the row-major bound chains, as torch tensors.

Reproduces `tpu_tree_search/ops/batched.py`: `BoundTables`, `make_tables`
(with `_calibrate_pair_order` and the 2^24 ceiling check), `pair_split`,
`PAIR_PREFILTER`, `parent_tables`, `_child_fronts`, `child_mask`, the
`*_from_parts` chains, `lb1_children`, `lb1d_children`, `lb2_children`,
`children_bounds` and `bounds_from_parts`. The tables hold the same values
in the same order (pairs strongest-first), so a bound computed here equals
the JAX one exactly: all of it is int32 arithmetic.

The `*_children` functions recompute each parent's prefix tables and
bound its dense (B, J) child grid in row-major torch operations, the
reference's per-child semantics; the engine's routes carry the fronts in
the pool and call the kernels' dispatchers (`ops/expand.py`) instead, so
these stay off the main path (the tests hold them to the JAX ones and to
the scalar oracle).

Dtypes: permutations int16, bound arithmetic int32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import reference as ref

I32_MAX = 2**31 - 1


class BoundTables(NamedTuple):
    """Precomputed tables for all three bounds, on one device.

    The JAX `BoundTables`' fields, shapes and values (`TABLE_FIELDS`),
    plus the pair-sweep kernel's packed copy of the LB2 part. The LB2 part
    holds one row per machine pair (P = M*(M-1)/2), strongest pair first.
    """

    p: torch.Tensor          # (M, J) int32 processing times
    p_t: torch.Tensor        # (J, M) int32 transpose
    min_tails: torch.Tensor  # (M,) int32
    total_work: torch.Tensor  # (M,) int32 = p.sum(axis=1)
    ma0: torch.Tensor        # (P,) int32 first machine of pair
    ma1: torch.Tensor        # (P,) int32 second machine
    js: torch.Tensor         # (P, J) int32 job ids in Johnson order
    ptm0_js: torch.Tensor    # (P, J) int32 p[ma0, js] in Johnson order
    ptm1_js: torch.Tensor    # (P, J) int32 p[ma1, js]
    lag_js: torch.Tensor     # (P, J) int32 lags[pair, js]
    # the pair-sweep kernel's packed copies of the LB2 part (sweep_tables)
    sweep_steps: torch.Tensor  # (P, J, 4) int32 {js, ptm0_js, ptm1_js, lag_js}
    sweep_pairs: torch.Tensor  # (P, 4) int32 {ma0, ma1, tail[ma0], tail[ma1]}


# the fields the JAX BoundTables shares (the rest are derived from them)
TABLE_FIELDS = BoundTables._fields[:10]

# pair count of the strong-pair prefilter tier (engine/device.step); the
# same constant as the JAX package, because the head/tail split is part
# of the per-step parity contract
PAIR_PREFILTER = 24


def _calibrate_pair_order(p, ma0, ma1, js, pt0, pt1, lag, min_tails,
                          n_samples: int = 2048, seed: int = 0):
    """Order machine pairs by how often each one attains the LB2 max on a
    deterministic synthetic sample of partial schedules of this instance
    (numpy, same seed and stable sort as the JAX package, so the order is
    identical). Reordering pairs never changes the bound itself."""
    M, J = p.shape
    P = len(ma0)
    rng = np.random.default_rng(seed)
    prmu = np.argsort(rng.random((n_samples, J)), axis=1)
    lo = max(1, J // 4)
    depth = rng.integers(lo, max(lo + 1, J - 1), n_samples)

    front = np.zeros((n_samples, M), np.int64)
    for q in range(J - 1):
        act = q < depth
        pj = p[:, prmu[:, q]].T                       # (n, M)
        c = np.empty_like(front)
        c[:, 0] = front[:, 0] + pj[:, 0]
        for k in range(1, M):
            c[:, k] = np.maximum(c[:, k - 1], front[:, k]) + pj[:, k]
        front = np.where(act[:, None], c, front)
    sched = np.argsort(prmu, axis=1) < depth[:, None]   # (n, J)

    t0 = front[:, ma0].T.astype(np.int64).copy()      # (P, n)
    t1 = front[:, ma1].T.astype(np.int64).copy()
    for j in range(J):
        active = ~sched[:, js[:, j]].T                # (P, n)
        n0 = t0 + pt0[:, j][:, None]
        n1 = np.maximum(t1, n0 + lag[:, j][:, None]) + pt1[:, j][:, None]
        t0 = np.where(active, n0, t0)
        t1 = np.where(active, n1, t1)
    per_pair = np.maximum(t1 + min_tails[ma1][:, None],
                          t0 + min_tails[ma0][:, None])
    freq = np.bincount(per_pair.argmax(axis=0), minlength=P)
    return np.argsort(-freq, kind="stable")


def pair_split(t: BoundTables, k: int):
    """(head, tail) BoundTables whose pair arrays are the first k /
    remaining P-k rows. max(head sweep, tail sweep) == the full LB2."""
    def cut(sl):
        return t._replace(ma0=t.ma0[sl], ma1=t.ma1[sl], js=t.js[sl],
                          ptm0_js=t.ptm0_js[sl], ptm1_js=t.ptm1_js[sl],
                          lag_js=t.lag_js[sl], sweep_steps=t.sweep_steps[sl],
                          sweep_pairs=t.sweep_pairs[sl])
    return cut(slice(None, k)), cut(slice(k, None))


def sweep_tables(t: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The pair-sweep kernel's tables, packed once per instance from the
    LB2 fields of `t` (name -> int32 tensor): steps (P, J, 4) and pairs
    (P, 4), contiguous, so a row slice of them is too."""
    steps = torch.stack([t["js"], t["ptm0_js"], t["ptm1_js"], t["lag_js"]],
                        dim=-1).contiguous()
    tails = t["min_tails"]
    pairs = torch.stack([t["ma0"], t["ma1"], tails[t["ma0"].long()],
                         tails[t["ma1"].long()]], dim=-1).contiguous()
    return steps, pairs


def table_arrays(p_times: np.ndarray) -> dict:
    """The tables as a dict of numpy int32 arrays (field name -> array)."""
    lb1 = ref.make_lb1_data(p_times)
    lb2 = ref.make_lb2_data(lb1)
    p = np.asarray(p_times, dtype=np.int32)
    # The ceiling the JAX package enforces for its f32 pair-sweep kernel,
    # kept so both packages accept exactly the same instances (the int32
    # kernels here would be exact far past it).
    ceiling = 2 * int(p.sum()) + int(np.asarray(lb1.min_tails).max())
    if ceiling >= 1 << 24:
        raise ValueError(
            f"instance magnitudes too large for the f32-exact LB2 kernel "
            f"(bound ceiling {ceiling} >= 2^24); rescale processing times")
    ma0 = np.asarray(lb2.pairs_m1)
    ma1 = np.asarray(lb2.pairs_m2)
    js = np.asarray(lb2.johnson_schedules)
    pt0 = p[ma0[:, None], js]
    pt1 = p[ma1[:, None], js]
    lag = np.take_along_axis(lb2.lags, lb2.johnson_schedules, axis=1)
    if len(ma0) > 2 * PAIR_PREFILTER and p.shape[1] >= 3:
        order = _calibrate_pair_order(p, ma0, ma1, js, pt0, pt1, lag,
                                      np.asarray(lb1.min_tails))
    else:
        order = np.arange(len(ma0))
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
    return dict(p=i32(p), p_t=i32(p.T), min_tails=i32(lb1.min_tails),
                total_work=i32(p.sum(axis=1)), ma0=i32(ma0[order]),
                ma1=i32(ma1[order]), js=i32(js[order]),
                ptm0_js=i32(pt0[order]), ptm1_js=i32(pt1[order]),
                lag_js=i32(lag[order]))


def make_tables(p_times: np.ndarray, device="cuda") -> BoundTables:
    """Host-side precompute, then one copy of every table to `device`."""
    from ..convert import tables_from_numpy
    return tables_from_numpy(table_arrays(p_times), device=device)


def _child_fronts(t: BoundTables, prmu: torch.Tensor, front: torch.Tensor):
    """Front of every dense child: append job prmu[b, i] to parent b's
    prefix (one add_forward chain, c_bound_simple.c:31-38).

    prmu (B, J) integer, front (B, M) int32. Returns (child_front
    (B, J, M) int32, child_p (B, J, M) int32 processing times of the
    appended job)."""
    M = t.p.shape[0]
    child_p = t.p_t[prmu.long()]                           # (B, J, M)
    chain = front[:, None, 0] + child_p[..., 0]
    cols = [chain]
    for k in range(1, M):
        chain = torch.maximum(chain, front[:, None, k]) + child_p[..., k]
        cols.append(chain)
    return torch.stack(cols, dim=-1), child_p


def lb1_from_parts(t: BoundTables, child_front, child_remain):
    """LB1 combine chain given each child's front/remain
    (machine_bound_from_parts, c_bound_simple.c:126-141). (B, J) int32."""
    M = t.p.shape[0]
    back = t.min_tails
    tmp0 = child_front[..., 0] + child_remain[..., 0]
    lb = tmp0 + back[0]
    for k in range(1, M):
        tmp1 = torch.maximum(tmp0, child_front[..., k] + child_remain[..., k])
        lb = torch.maximum(lb, tmp1 + back[k])
        tmp0 = tmp1
    return lb


def lb1d_from_parts(t: BoundTables, front, remain, child_p):
    """LB1_d chain from the parents' front/remain and each child's
    processing times (add_front_and_bound, c_bound_simple.c:218-244).
    (B, J) int32."""
    back = t.min_tails
    M = t.p.shape[0]
    lb = (front[:, None, 0] + remain[:, None, 0] + back[0]) \
        * torch.ones_like(child_p[..., 0])
    tmp0 = front[:, None, 0] + child_p[..., 0]
    for k in range(1, M):
        tmp1 = torch.maximum(tmp0, front[:, None, k])
        lb = torch.maximum(lb, tmp1 + remain[:, None, k] + back[k])
        tmp0 = tmp1 + child_p[..., k]
    return lb


def parent_tables(t: BoundTables, prmu: torch.Tensor, depth: torch.Tensor):
    """front and remain (B, M) int32 of each parent's prefix: positions
    j < depth(b) scheduled (schedule_front + sum_unscheduled,
    c_bound_simple.c:51-69, 108-124)."""
    B, J = prmu.shape
    M = t.p.shape[0]
    depth = depth.reshape(B)
    front = torch.zeros((B, M), dtype=torch.int32, device=prmu.device)
    sched_sum = torch.zeros_like(front)
    for j in range(J):
        pj = t.p_t[prmu[:, j].long()]                      # (B, M)
        active = (j < depth)[:, None]
        chain = front[:, 0] + pj[:, 0]
        cols = [chain]
        for k in range(1, M):
            chain = torch.maximum(chain, front[:, k]) + pj[:, k]
            cols.append(chain)
        front = torch.where(active, torch.stack(cols, dim=1), front)
        sched_sum = sched_sum + torch.where(active, pj, 0)
    return front, t.total_work[None, :] - sched_sum


def child_mask(prmu: torch.Tensor, depth: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """(B, J) mask of real children: slot i exists iff depth <= i < J."""
    B, J = prmu.shape
    slots = torch.arange(J, device=prmu.device)
    return (slots[None, :] >= depth.reshape(B, 1)) & valid.reshape(B, 1)


def lb2_from_parts(t: BoundTables, prmu: torch.Tensor, depth: torch.Tensor,
                   child_front: torch.Tensor) -> torch.Tensor:
    """LB2 Johnson bound of every dense child from its front (lb2_bound,
    c_bound_johnson.c:239-254), a full max over the pairs (the
    reference's early exit fires only on a pruned child). (B, J) int32."""
    B, J = prmu.shape
    ar = torch.arange(J, dtype=torch.int32, device=prmu.device)
    # slot_of_job[b, job] = the job's position in prmu[b]
    slot_of_job = torch.zeros((B, J), dtype=torch.int32,
                              device=prmu.device).scatter_(
        1, prmu.long(), ar.expand(B, J).contiguous())
    tmp0 = child_front[..., t.ma0.long()]                  # (B, J, P)
    tmp1 = child_front[..., t.ma1.long()]
    depth_b = depth.reshape(B, 1, 1)
    for j in range(J):
        slot = slot_of_job[:, t.js[:, j].long()][:, None, :]   # (B, 1, P)
        # the job is unscheduled in the child unless it is the appended
        # one (at slot i of the dense grid)
        active = (slot >= depth_b) & (slot != ar[None, :, None])
        new0 = tmp0 + t.ptm0_js[:, j]
        new1 = torch.maximum(tmp1, new0 + t.lag_js[:, j]) + t.ptm1_js[:, j]
        tmp0 = torch.where(active, new0, tmp0)
        tmp1 = torch.where(active, new1, tmp1)
    back0 = t.min_tails[t.ma0.long()]
    back1 = t.min_tails[t.ma1.long()]
    return torch.maximum(tmp1 + back1, tmp0 + back0).amax(dim=-1)


def lb1_children(t: BoundTables, prmu, depth, valid) -> torch.Tensor:
    """LB1 bound of every child (lb1_bound of the child permutation,
    c_bound_simple.c:143-158, per child as evaluate_gpu_lb1,
    PFSP_gpu_lib.cu:43-65). (B, J) int32; masked slots hold I32_MAX."""
    front, remain = parent_tables(t, prmu, depth)
    child_front, child_p = _child_fronts(t, prmu, front)
    lb = lb1_from_parts(t, child_front, remain[:, None, :] - child_p)
    return torch.where(child_mask(prmu, depth, valid), lb, I32_MAX)


def lb1d_children(t: BoundTables, prmu, depth, valid) -> torch.Tensor:
    """LB1_d bound of every child (per parent as evaluate_gpu_lb1_d,
    PFSP_gpu_lib.cu:73-102). (B, J) int32; masked slots hold I32_MAX."""
    front, remain = parent_tables(t, prmu, depth)
    _, child_p = _child_fronts(t, prmu, front)
    lb = lb1d_from_parts(t, front, remain, child_p)
    return torch.where(child_mask(prmu, depth, valid), lb, I32_MAX)


def lb2_children(t: BoundTables, prmu, depth, valid) -> torch.Tensor:
    """LB2 bound of every child (per child as evaluate_gpu_lb2,
    PFSP_gpu_lib.cu:105-127). (B, J) int32; masked slots hold I32_MAX."""
    front, _ = parent_tables(t, prmu, depth)
    child_front, _ = _child_fronts(t, prmu, front)
    lb = lb2_from_parts(t, prmu, depth, child_front)
    return torch.where(child_mask(prmu, depth, valid), lb, I32_MAX)


def children_bounds(lb_kind: int):
    """0 = LB1_d, 1 = LB1, 2 = LB2, as the reference's `decompose`
    dispatches (PFSP_lib.h:30-48, PFSP_gpu_lib.cu:129-152)."""
    return {0: lb1d_children, 1: lb1_children, 2: lb2_children}[lb_kind]


def bounds_from_parts(lb_kind: int, t: BoundTables, prmu, depth, valid,
                      front, remain, child_front, child_p,
                      mask) -> torch.Tensor:
    """The bound dispatch for callers that carry front and remain (no
    prefix rescan); `valid` is folded into `mask` by the caller, as in
    the JAX package. (B, J) int32; masked slots hold I32_MAX."""
    if lb_kind == 0:
        lb = lb1d_from_parts(t, front, remain, child_p)
    elif lb_kind == 1:
        lb = lb1_from_parts(t, child_front, remain[:, None, :] - child_p)
    elif lb_kind == 2:
        lb = lb2_from_parts(t, prmu, depth, child_front)
    else:
        raise ValueError(f"unknown lb_kind {lb_kind}")
    return torch.where(mask, lb, I32_MAX)
