"""Single-device PFSP branch-and-bound engine: a device-resident pool.

Reproduces `tpu_tree_search/engine/device.py` for one device: the pool
layout, `aux_dtype`, `row_limit`, `SearchState`, `init_state`, the
compaction (`_compact_tiers`, `_partition_prefix`, `_tiered_compact`,
`_compact_from_parents`, over the column helpers of `ops/columns.py`
that the fused kernel's plain version shares), `lb2_route`, `pop_chunk`, `_write_block`,
`_commit` (the no-commit overflow contract and its scratch margin),
`_sweep_tiers`, `_lb2_tail`, `_leaf_scan`, all three routes of `step`
(LB1/LB1_d, LB2 `dense`, LB2 `prefilter`) and the fused route
(`_fused_step`, `ops/fused.py`), the search-telemetry updates of every
route (`engine/telemetry.py`), `run`, `search` and `default_capacity`.

Where the JAX engine branches on device values inside one compiled
`while_loop` (`lax.cond`, `lax.switch`), this engine reads the few counts
it branches on back to the host (`.item()`/`.tolist()`, one to three per
step) and branches in Python; the state's scalar counters are therefore
Python ints. The telemetry vector stays on the device and adds no sync.
A tier choice only changes garbage columns above the pool cursor, never
the live pool region `[0, size)` nor any counter, so a step here and a
JAX step from the same state give the same live pool and counters.

Pool layout (feature-major, the node axis last):
    prmu  int16[jobs, capacity]     permutations
    depth int16[capacity]           scheduled-prefix length
    aux   int16|int32[M, capacity]  machine-completion front of the prefix

Entry points run on `cuda` unless the caller passes `device="cpu"`; asking
for `cuda` where there is none raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import (batched, columns as cols, expand as ex, fused as fz,
                   reference as ref)
from ..ops.batched import BoundTables
from . import telemetry as tele

I32_MAX = 2**31 - 1
_I64_MAX = 2**63 - 1


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises for CUDA where none exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch finds no CUDA "
                           "device; pass device='cpu' to run the plain "
                           "versions on the CPU")
    return dev


def aux_dtype(p_times: np.ndarray | None) -> torch.dtype:
    """Narrowest safe dtype for the pool's front vectors: every value is a
    completion time bounded by (J + M - 1) * max(p), so int16 when that
    fits (every Taillard class through 200x20), else int32."""
    if p_times is None:
        return torch.int32
    m, j = p_times.shape
    bound = (j + m - 1) * int(np.max(p_times))
    return torch.int16 if bound <= 2**15 - 1 else torch.int32


def row_limit(capacity: int, chunk: int, jobs: int) -> int:
    """Usable pool rows. The top `chunk*jobs` rows are a scratch margin:
    an overflowing step writes its block there, so the live region stays
    untouched."""
    return max(capacity - chunk * jobs, 0)


class SearchState(NamedTuple):
    """Pool tensors and the telemetry vector on the device, the counters
    on the host."""

    prmu: torch.Tensor   # (jobs, capacity) int16
    depth: torch.Tensor  # (capacity,) int16
    aux: torch.Tensor    # (machines, capacity) aux_dtype front vectors
    size: int            # live-row cursor
    best: int            # incumbent makespan
    tree: int            # explored (= pushed) internal nodes
    sol: int             # evaluated leaf children
    iters: int           # loop iterations
    evals: int           # child bound evaluations
    sent: int = 0        # multi-device balance counters (0 on one device)
    recv: int = 0
    steals: int = 0
    overflow: bool = False
    telemetry: torch.Tensor | None = None
                         # (WIDTH,) int64 on the pool's device, or (0,)
                         # when telemetry is off (engine/telemetry.py)


def init_state(jobs: int, capacity: int, init_ub: int | None,
               prmu0: np.ndarray | None = None,
               depth0: np.ndarray | None = None,
               p_times: np.ndarray | None = None,
               telemetry: bool | None = None,
               device="cuda") -> SearchState:
    """Pool with the given seed nodes (default: the root at depth 0);
    `p_times` sizes and fills the front vectors. `telemetry` gives the
    state the search-telemetry vector (None: the TTS_SEARCH_TELEMETRY
    flag)."""
    dev = resolve_device(device)
    if prmu0 is None:
        prmu0 = np.arange(jobs, dtype=np.int16)[None, :]
        depth0 = np.zeros(1, dtype=np.int16)
    prmu0 = np.asarray(prmu0, dtype=np.int16).reshape(-1, jobs)
    depth0 = np.asarray(depth0, dtype=np.int16).reshape(-1)
    n = prmu0.shape[0]
    if n > capacity:
        raise ValueError(f"{n} seed nodes exceed capacity {capacity}")
    prmu = torch.zeros((jobs, capacity), dtype=torch.int16, device=dev)
    prmu[:, :n] = torch.as_tensor(prmu0.T.copy(), device=dev)
    depth = torch.zeros(capacity, dtype=torch.int16, device=dev)
    depth[:n] = torch.as_tensor(depth0, device=dev)
    if p_times is not None:
        m = p_times.shape[0]
        aux = torch.zeros((m, capacity), dtype=aux_dtype(p_times),
                          device=dev)
        fr = ref.prefix_front_remain(p_times, prmu0, depth0)[:, :m].T
        aux[:, :n] = torch.as_tensor(fr.copy(), device=dev).to(aux.dtype)
    else:
        aux = torch.zeros((0, capacity), dtype=torch.int32, device=dev)
    on = tele.enabled() if telemetry is None else telemetry
    return SearchState(prmu=prmu, depth=depth, aux=aux, size=n,
                       best=I32_MAX if init_ub is None else int(init_ub),
                       tree=0, sol=0, iters=0, evals=0,
                       telemetry=torch.zeros(tele.WIDTH if on else 0,
                                             dtype=torch.int64, device=dev))


def _tele_on(state: SearchState) -> bool:
    return state.telemetry is not None and state.telemetry.shape[-1] > 0


def _compact_tiers(N: int, two_phase: bool = False,
                   cap: int | None = None) -> list[int]:
    """Compaction tier widths, as the JAX engine's (`_compact_tiers`)."""
    steps = ((N // 16, 3 * N // 32, N // 4) if two_phase
             else (N // 16, N // 4))
    cap = N if cap is None else cap
    return [t for t in steps if 128 <= t < cap] + [cap]


def _tier_for(tiers: list[int], count: int) -> int:
    """The tier the JAX engine's `_tier_switch` selects for `count`: the
    smallest covering it (the last covers every count)."""
    return tiers[sum(count > t for t in tiers[:-1])]


def _partition_prefix(push: torch.Tensor, live: int, N: int,
                      two_phase: bool = False,
                      cap: int | None = None) -> torch.Tensor:
    """_partition when every True column sits below `live`: sort only the
    smallest tier covering `live`; the rest is filled with its own
    index."""
    t = _tier_for(_compact_tiers(N, two_phase, cap), live)
    frame = push.shape[0]
    srt = cols.partition(push[:t])
    if t < frame:
        srt = torch.cat([srt, torch.arange(t, frame, device=push.device)])
    return srt


def _tiered_compact(gather, perm: torch.Tensor, n_keep: int, N: int,
                    two_phase: bool = False, cap: int | None = None):
    """Frame-wide compacted blocks: gather the smallest tier's prefix of
    `perm` that covers the `n_keep` survivors and zero-pad to the frame
    (the padding lands above the pool cursor and is never read)."""
    tiers = _compact_tiers(N, two_phase, cap)
    frame = tiers[-1]
    t = _tier_for(tiers, n_keep)
    out = gather(perm[:t])
    if t < frame:
        out = tuple(torch.cat([o, o.new_zeros(o.shape[:-1] + (frame - t,))],
                              dim=-1) for o in out)
    return out


def _compact_from_parents(tables: BoundTables, p_prmu, p_depth2, p_aux,
                          perm, n_keep: int, TB: int, N: int,
                          with_sched: bool = False, two_phase: bool = False,
                          cap: int | None = None):
    """Compacted child block rebuilt from the popped parents."""
    def gather(idx):
        return cols.regather(tables, p_prmu, p_depth2, p_aux, idx, TB,
                             with_sched)
    return _tiered_compact(gather, perm, n_keep, N, two_phase, cap)


def lb2_route(jobs: int, machines: int, pairs: int, chunk: int,
              tile: int = 1024, on_cuda: bool = True):
    """(route, TB, pair_kernel_ok): the JAX engine's LB2 routing rule,
    with "the tensors are on CUDA" where it asks "the backend is TPU" and
    the shape rule unchanged. On CUDA, 20x5 and 20x10 take 'dense' and
    20x20 and 50x20 'prefilter'; on the CPU every class takes
    'prefilter', as the JAX package does there."""
    TB = ex.effective_tile(jobs, chunk, tile, 2, machines=machines)
    pair_ok = (on_cuda
               and ex.kernel_shape_ok(jobs, TB, 2, machines=machines)
               and ex.lb2_kernel_fits(jobs, pairs))
    if not pair_ok:
        TB1 = ex.effective_tile(jobs, chunk, tile, 1, machines=machines)
        if on_cuda and ex.kernel_shape_ok(jobs, TB1, 1, machines=machines):
            TB = TB1
    if pair_ok and pairs <= 2 * batched.PAIR_PREFILTER:
        return "dense", TB, pair_ok
    return "prefilter", TB, pair_ok


def pop_chunk(state: SearchState, B: int, M: int):
    """Pop window of up to B parents off the stack top (no commit):
    (p_prmu (J, B) int16, p_depth (1, B) int32, p_aux (M, B) in the pool's
    aux dtype, n, start, valid)."""
    J, capacity = state.prmu.shape
    n = min(state.size, B)
    start = state.size - n
    valid = torch.arange(B, device=state.prmu.device) < n
    p_prmu = state.prmu[:, start:start + B].contiguous()
    p_depth = state.depth[start:start + B].to(torch.int32)
    p_depth = torch.where(valid, p_depth, 0)[None, :]
    p_aux = state.aux[:M, start:start + B]
    return p_prmu, p_depth, p_aux, n, start, valid


def _write_block(state: SearchState, children, child_depth, child_aux,
                 start: int, n_push: int, limit: int) -> None:
    """Write the compacted block at the cursor, or into the scratch margin
    at `limit` when the step overflows. Updates the pool in place."""
    M = child_aux.shape[0] - 1
    at = limit if start + n_push > limit else start
    w = children.shape[1]
    state.prmu[:, at:at + w] = children
    state.depth[at:at + w] = child_depth
    state.aux[:, at:at + w] = child_aux[:M].to(state.aux.dtype)


def _commit(state: SearchState, n_push: int, best: int, sol: int,
            evals: int, limit: int, start: int,
            tele_delta: torch.Tensor | None = None) -> SearchState:
    """The no-commit overflow contract: an overflowing step leaves every
    counter and the telemetry vector as they were and only sets the flag
    (its block went to the scratch margin), so grow + resume continues
    losslessly. `tele_delta` (telemetry.step_delta, None when telemetry
    is off) is folded in with the slots `telemetry.commit` owns."""
    new_size = start + n_push
    if new_size > limit:
        return state._replace(iters=state.iters + 1, overflow=True)
    telem = state.telemetry
    if tele_delta is not None:
        telem = tele.commit(telem, tele_delta, new_size, best, state.best,
                            state.iters)
    return state._replace(size=new_size, best=best,
                          tree=state.tree + n_push, sol=sol,
                          iters=state.iters + 1,
                          evals=state.evals + evals, telemetry=telem)


def _sweep_tiers(tbl: BoundTables, cf_cols, sched_cols, count: int, N: int):
    """Pair sweep over the smallest prefix tier covering `count` live
    columns; columns past the tier read I32_MAX. The ladder is the JAX
    engine's with every rung admitted (the Hopper sweep has no tile
    rule)."""
    frame = cf_cols.shape[1]
    tiers = [t for t in (k * N // 64 for k in
                         (1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 20, 24, 32))
             if 0 < t < frame] + [frame]
    width = _tier_for(tiers, count)
    b = ex.lb2_bounds(tbl, cf_cols[:, :width], sched_cols[:, :width])
    if width < frame:
        b = torch.cat([b, b.new_full((1, frame - width), I32_MAX)], dim=1)
    return b


def _take_block(*rows_arrays):
    """prefix-gather closure over the given (rows, frame) arrays."""
    def take(idx):
        return tuple(a[:, idx] for a in rows_arrays)
    return take


def _lb2_tail(tables: BoundTables, state: SearchState, children, caux,
              sched, ncand: int, W_: int, N: int, best: int, start: int,
              limit: int, TELE: bool = False):
    """Everything after the LB1 prune of the two-phase LB2 route, in
    W_-wide frames: the strong-pair head sweep, the mid prune+compact, the
    tail sweep, the final prune+compact and the pool block write. The
    unfused prefilter route and the fused route both end here. Returns
    (n_push, tele_tail): with `TELE`, the (DB + 2*BB,) branched buckets,
    pruned-bound and surviving-bound histograms of this part, else
    None."""
    J = children.shape[0]
    M = tables.p.shape[0]
    P = int(tables.ma0.shape[0])
    KH = batched.PAIR_PREFILTER
    dev = children.device
    live_cols = torch.arange(W_, device=dev)
    caux = caux.to(torch.int32)

    if P <= KH:
        lb2b = _sweep_tiers(tables, caux[:M], sched, ncand, N)
        live = ncand
        head_hp = 0
    else:
        SW = ex.sched_words(J)
        head_t, tail_t = batched.pair_split(tables, KH)
        lb2h = _sweep_tiers(head_t, caux[:M], sched, ncand, N)
        keep = (live_cols < ncand) & (lb2h.reshape(-1) < best)
        if TELE:
            # pruned by the head sweep: binned at the partial bound that
            # pruned them (partial max <= LB2)
            head_hp = tele.bound_hist(lb2h, (live_cols < ncand) & ~keep,
                                      best)
        nkeep = int(keep.sum().item())
        permh = _partition_prefix(keep, ncand, N, two_phase=True, cap=W_)
        aux_plus = torch.cat([caux, sched, lb2h], dim=0)
        children, aux_plus = _tiered_compact(
            _take_block(children, aux_plus), permh, nkeep, N,
            two_phase=True, cap=W_)
        caux = aux_plus[:M + 1]
        sched = aux_plus[M + 1:M + 1 + SW]
        lb2h_c = aux_plus[M + 1 + SW:M + 2 + SW]
        lb2t = _sweep_tiers(tail_t, caux[:M], sched, nkeep, N)
        lb2b = torch.maximum(lb2h_c, lb2t)
        live = nkeep

    push = (live_cols < live) & (lb2b.reshape(-1) < best)
    n_push = int(push.sum().item())
    tele_tail = None
    if TELE:
        # computed while caux still aligns column for column with push
        # (the final compaction reorders)
        pb = tele.depth_bucket(caux[M].reshape(-1) - 1, J)
        live_m = live_cols < live
        tele_tail = torch.cat([
            tele.bucket_counts(pb, push),
            head_hp + tele.bound_hist(lb2b, live_m & ~push, best),
            tele.bound_hist(lb2b, push, best)])
    perm2 = _partition_prefix(push, live, N, two_phase=True, cap=W_)
    children, child_aux = _tiered_compact(
        _take_block(children, caux), perm2, n_push, N, two_phase=True,
        cap=W_)
    _write_block(state, children, child_aux[M].to(torch.int16), child_aux,
                 start, n_push, limit)
    return n_push, tele_tail


def _leaf_scan(tables: BoundTables, p_prmu, p_depth, p_aux, valid):
    """Parent-level leaf and eval statistics of a popped chunk, without the
    dense child grid (the fused route never builds it): a parent at depth
    J-1 has one child, a leaf, whose LB1 is the chain
    max_k(tmp_k + min_tails[k]) with every child-remain term zero, term
    for term the dense route's value; a parent below J-1 has J - depth
    evaluated children. Returns device scalars (leaf_best int32, n_leaf
    int64, evals int64)."""
    J, B = p_prmu.shape
    M = p_aux.shape[0]
    d = p_depth.reshape(-1)
    leafp = (d == J - 1) & valid
    # the one unscheduled job of a depth-(J-1) parent sits at J-1
    a = p_prmu[J - 1].long().clamp(0, J - 1)
    cp = tables.p[:, a]                                       # (M, B)
    cf = p_aux[0] + cp[0]
    cfs = [cf]
    for k in range(1, M):
        cf = torch.maximum(cf, p_aux[k]) + cp[k]
        cfs.append(cf)
    # the chain's tmp_k = max(tmp_{k-1}, cf_k) is the running max of the
    # fronts; lb = max_k(tmp_k + min_tails[k]), in four operations
    # instead of 3*M
    tmp = torch.stack(cfs).cummax(dim=0).values
    lb = (tmp + tables.min_tails[:, None]).amax(dim=0)
    leaf_best = torch.where(leafp, lb, I32_MAX).min()
    evals = torch.where(valid, J - d.long(), 0).sum()
    return leaf_best, leafp.sum(), evals


def _fused_step(tables: BoundTables, lb_kind: int, route, B: int, TB: int,
                state: SearchState, p_prmu, p_depth, p_aux, n: int,
                start: int, valid, limit: int) -> SearchState | None:
    """The fused bound+prune+compact route (`ops/fused.py`): the dense
    child grid, its bound row, the prune mask and the partition never
    exist. The kernel returns the compacted survivors and their count;
    leaves and evals come from the parent-level `_leaf_scan`. The pruning
    incumbent `min(best, leaf_best)` stays on the device, so one read
    brings back leaf best, leaf count, evals and survivor count.

    LB1 runs uncapped (frame N). LB2 `prefilter` caps the frame at
    W = max(N/4, 128) and runs `_lb2_tail` on it. A step whose LB1
    survivors outgrow W (the JAX engine's `spill_tail`) returns None
    before it has written anything, and `step` redoes it on the unfused
    `prefilter` route, whose bound math is the same, so the explored set
    does not depend on the branch. Telemetry: popped and evaluated
    buckets are parent-level, branched buckets and the surviving-bound
    histogram come off the compacted block, and the pruned-bound
    histogram is the kernel's."""
    J = state.prmu.shape[0]
    M = tables.p.shape[0]
    N = B * J
    TELE = _tele_on(state)

    leaf_best, n_leaf, evals = _leaf_scan(tables, p_prmu, p_depth, p_aux,
                                          valid)
    cap = leaf_best.clamp(max=state.best)      # int32 scalar on the device
    if TELE:
        d = p_depth.reshape(-1)
        wb = tele.depth_bucket(d, J)
        popped_b = tele.bucket_counts(wb, valid)
        # J - d evaluated non-leaf children per valid parent below J-1
        evalnl_b = tele.bucket_counts(wb, valid & (d < J - 1), J - d)
    W = N if lb_kind != 2 else min(max(N // 4, 128), N)
    kch, kaux, kbnd, ksched, k_surv, khist = fz.fused_expand(
        tables, p_prmu, p_depth, p_aux, n, cap, lb_kind=1, tile=TB,
        cap_width=W, with_sched=(route == "prefilter"),
        tele_bins=tele.BOUND_BINS if TELE else 0,
        with_bounds=(lb_kind != 2 and TELE),
        aux_i16=(lb_kind != 2 and state.aux.dtype == torch.int16))
    best, n_leaf, n_eval, n_surv = (int(v) for v in torch.stack(
        [cap.long(), n_leaf, evals, k_surv.long()]).tolist())
    sol = state.sol + n_leaf
    DB, BB = tele.DEPTH_BUCKETS, tele.BOUND_BINS

    if lb_kind != 2:
        caux = kaux[:, :n_surv]
        _write_block(state, kch[:, :n_surv], caux[M].to(torch.int16), caux,
                     start, n_surv, limit)
        delta = None
        if TELE:
            surv = torch.ones(n_surv, dtype=torch.bool, device=caux.device)
            branched_b = tele.bucket_counts(
                tele.depth_bucket(caux[M] - 1, J), surv)
            delta = tele.step_delta(
                popped_b, branched_b, evalnl_b - branched_b, khist,
                tele.bound_hist(kbnd[:, :n_surv], surv, best))
        return _commit(state, n_surv, best, sol, n_eval, limit, start,
                       tele_delta=delta)

    if n_surv > W:
        return None
    n_push, tail = _lb2_tail(tables, state, kch, kaux, ksched, n_surv, W, N,
                             best, start, limit, TELE)
    delta = None
    if TELE:
        delta = tele.step_delta(popped_b, tail[:DB], evalnl_b - tail[:DB],
                                khist + tail[DB:DB + BB], tail[DB + BB:])
    return _commit(state, n_push, best, sol, n_eval, limit, start,
                   tele_delta=delta)


def _leaves_and_push(bounds, mask, depth_c, J: int, best_in: int):
    """Leaf count, incumbent and push mask of a dense bound row, read back
    in one sync: (n_leaf, best, push, n_push, n_eval)."""
    is_leaf = ((depth_c + 1) == J) & mask
    leaf_best = torch.where(is_leaf, bounds, I32_MAX).min()
    best = torch.clamp(leaf_best, max=best_in)
    push = (mask & ~is_leaf & (bounds < best)).reshape(-1)
    counts = torch.stack([is_leaf.sum(), best.long(), push.sum(),
                          mask.sum()]).tolist()
    n_leaf, best, n_push, n_eval = (int(v) for v in counts)
    return n_leaf, best, push, n_push, n_eval


def step(tables: BoundTables, lb_kind: int, chunk: int,
         state: SearchState, tile: int = 1024, limit: int | None = None,
         route: str | None = None,
         fused: str | None = None) -> SearchState:
    """One pop -> bound -> prune -> branch cycle. The pool tensors are
    updated in place; the returned state carries the new counters.

    `route` overrides `lb2_route`'s LB2 choice ('dense' or 'prefilter');
    both push the same children in the same column order. `fused` is a
    mode of `ops/fused.py` ("off", "hw", "interpret"; None: "hw" on CUDA
    tensors, "off" on the CPU, `fused.resolve_mode`); where `fused_ok`
    admits the shape, LB1 and LB2 `prefilter` take the fused route, with
    the same result (an LB2 step whose survivors outgrow the fused frame
    falls through to the unfused `prefilter` route)."""
    J, capacity = state.prmu.shape
    B = chunk
    if capacity < B:
        raise ValueError(f"pool capacity {capacity} < chunk {B}")
    M = tables.p.shape[0]
    if state.aux.shape[0] != M:
        raise ValueError(f"pool aux width {state.aux.shape[0]} != machines "
                         f"{M}: seed the state with p_times")
    if lb_kind == 2:
        auto, TB, _ = lb2_route(J, M, int(tables.ma0.shape[0]), B, tile,
                                on_cuda=state.prmu.is_cuda)
        route = route or auto
    else:
        route = None
        TB = ex.effective_tile(J, B, tile, lb_kind, machines=M)
    G = B // TB
    N = B * J
    if limit is None:
        limit = row_limit(capacity, B, J)

    fused = fz.resolve_mode(fused, on_cuda=state.prmu.is_cuda)
    p_prmu, p_depth, p_aux, n, start, valid = pop_chunk(state, B, M)
    p_aux = p_aux.to(torch.int32)
    if (fz.fused_ok(fused, J, TB, lb_kind, M, device=state.prmu.device)
            and (lb_kind == 1 or route == "prefilter")):
        out = _fused_step(tables, lb_kind, route, B, TB, state, p_prmu,
                          p_depth, p_aux, n, start, valid, limit)
        if out is not None:
            return out
    depth_c, mask = cols.child_masks(p_depth, valid, G, J, TB)

    # search telemetry, common to the unfused routes: popped parents and
    # evaluated non-leaf children by relative-depth bucket; each route
    # adds its branched buckets and bound histograms (pruned = evaluated
    # - branched)
    TELE = _tele_on(state)
    DB, BB = tele.DEPTH_BUCKETS, tele.BOUND_BINS
    if TELE:
        nonleaf = (mask & ((depth_c + 1) != J)).reshape(-1)
        child_b = tele.depth_bucket(depth_c.reshape(-1), J)
        popped_b = tele.bucket_counts(
            tele.depth_bucket(p_depth.reshape(-1), J), valid)
        evalnl_b = tele.bucket_counts(child_b, nonleaf)

    if route == "prefilter":
        # two-phase LB2: LB1 pre-prune (LB1 <= LB2, so sound), then the
        # pair sweeps over the survivors only
        lb1b = ex.expand_bounds(tables, p_prmu, p_depth, p_aux, lb_kind=1,
                                tile=TB)
        n_leaf, best, cand, ncand, n_eval = _leaves_and_push(
            lb1b, mask, depth_c, J, state.best)
        perm1 = cols.partition(cand)
        W = max(N // 4, 128)
        W2 = 3 * N // 8
        if W >= N:
            W_ = N
        elif W2 <= W or W2 >= N or W2 % 128 != 0:
            W_ = W if ncand <= W else N
        else:
            W_ = W if ncand <= W else (W2 if ncand <= W2 else N)
        children, caux, sched = _compact_from_parents(
            tables, p_prmu, p_depth, p_aux, perm1, ncand, TB, N,
            with_sched=True, two_phase=True, cap=W_)
        n_push, tail = _lb2_tail(tables, state, children, caux, sched,
                                 ncand, W_, N, best, start, limit, TELE)
        delta = None
        if TELE:
            # the LB1 prefilter's prunes bin at the bound that pruned them
            hist_lb1 = tele.bound_hist(lb1b, nonleaf & ~cand, best)
            delta = tele.step_delta(popped_b, tail[:DB],
                                    evalnl_b - tail[:DB],
                                    hist_lb1 + tail[DB:DB + BB],
                                    tail[DB + BB:])
        return _commit(state, n_push, best, state.sol + n_leaf, n_eval,
                       limit, start, tele_delta=delta)

    # LB1/LB1_d, or the one-shot dense LB2 of the few-pair classes (on
    # the card the expand kernel writes only the fronts and words the
    # pair sweep reads)
    bounds = ex.expand_bounds(tables, p_prmu, p_depth, p_aux,
                              lb_kind=2 if route == "dense" else lb_kind,
                              tile=TB)
    n_leaf, best, push, n_push, n_eval = _leaves_and_push(
        bounds, mask, depth_c, J, state.best)
    delta = None
    if TELE:
        branched_b = tele.bucket_counts(child_b, push)
        delta = tele.step_delta(popped_b, branched_b, evalnl_b - branched_b,
                                tele.bound_hist(bounds, nonleaf & ~push,
                                                best),
                                tele.bound_hist(bounds, push, best))
    perm = cols.partition(push)
    children, child_aux = _compact_from_parents(
        tables, p_prmu, p_depth, p_aux, perm, n_push, TB, N,
        two_phase=(route == "dense"))
    _write_block(state, children, child_aux[M].to(torch.int16), child_aux,
                 start, n_push, limit)
    return _commit(state, n_push, best, state.sol + n_leaf, n_eval, limit,
                   start, tele_delta=delta)


def run(tables: BoundTables, state: SearchState, lb_kind: int, chunk: int,
        max_iters: int | None = None, tile: int = 1024,
        fused=None) -> SearchState:
    """Step until the pool is empty, a step overflows, or the cumulative
    iteration count reaches `max_iters`. `fused` (None: "hw" on CUDA
    tensors, "off" on the CPU) is resolved here, once, on the host
    (`fused.resolve_mode`)."""
    jobs, capacity = state.prmu.shape
    if state.size > row_limit(capacity, chunk, jobs):
        return state._replace(overflow=True)
    mode = fz.resolve_mode(fused, on_cuda=state.prmu.is_cuda)
    ceiling = _I64_MAX if max_iters is None else max_iters
    while state.size > 0 and not state.overflow and state.iters < ceiling:
        state = step(tables, lb_kind, chunk, state, tile=tile, fused=mode)
    return state


def run_growing(tables: BoundTables, state: SearchState, lb_kind: int,
                chunk: int, max_iters: int | None = None,
                fused=None) -> SearchState:
    """`run`, but on overflow the pool is re-homed into double the
    capacity (checkpoint.grow, lossless) and the run resumes where it
    stopped."""
    from . import checkpoint

    while True:
        state = run(tables, state, lb_kind, chunk, max_iters, fused=fused)
        if not state.overflow:
            return state
        state = checkpoint.grow(state, 2 * state.prmu.shape[1])


def default_capacity(jobs: int, machines: int, floor: int = 1 << 18) -> int:
    """Pool-capacity pre-sizing by instance class (the JAX engine's
    rule)."""
    if jobs >= 40 and machines <= 8:
        return max(1 << 24, floor)
    if jobs >= 40 or machines <= 8:
        return max(1 << 20, floor)
    return floor


class SearchResult(NamedTuple):
    explored_tree: int
    explored_sol: int
    best: int
    iters: int
    evals: int
    overflow: bool
    complete: bool = True  # pool drained (False: max_iters truncation)
    telemetry: dict | None = None  # telemetry.summarize, when it was on


def search(p_times: np.ndarray, lb_kind: int = 1, init_ub: int | None = None,
           chunk: int = 64, capacity: int = 1 << 18,
           max_iters: int | None = None, device="cuda",
           fused=None, telemetry: bool | None = None) -> SearchResult:
    """Host entry point: build tables, run, report the counters. On
    overflow the pool is re-homed into double the capacity and the search
    resumes where it stopped (`run_growing`). `fused`: see `run`;
    `telemetry`: see `init_state`."""
    dev = resolve_device(device)
    tables = batched.make_tables(p_times, device=dev)
    jobs = p_times.shape[1]
    state = init_state(jobs, capacity, init_ub, p_times=p_times,
                       telemetry=telemetry, device=dev)
    out = run_growing(tables, state, lb_kind, chunk, max_iters, fused=fused)
    return SearchResult(
        explored_tree=out.tree, explored_sol=out.sol, best=out.best,
        iters=out.iters, evals=out.evals, overflow=False,
        complete=out.size == 0, telemetry=tele.summarize(out.telemetry))
