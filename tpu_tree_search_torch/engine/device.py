"""Single-device PFSP branch-and-bound engine: a device-resident pool.

Reproduces `tpu_tree_search/engine/device.py` for one device: the pool
layout, `aux_dtype`, `row_limit`, `SearchState`, `init_state`, the
compaction (`_col_major`, `_child_masks`, `_partition`, `_regather`,
`_compact_tiers`, `_partition_prefix`, `_tiered_compact`,
`_compact_from_parents`), `lb2_route`, `pop_chunk`, `_write_block`,
`_commit` (the no-commit overflow contract and its scratch margin),
`_sweep_tiers`, `_lb2_tail`, all three routes of `step` (LB1/LB1_d, LB2
`dense`, LB2 `prefilter`), `run`, `search` and `default_capacity`.

Where the JAX engine branches on device values inside one compiled
`while_loop` (`lax.cond`, `lax.switch`), this engine reads the few counts
it branches on back to the host (`.item()`, one to three per step) and
branches in Python; the state's scalar counters are therefore Python ints.
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

from ..ops import batched, expand as ex, reference as ref
from ..ops.batched import BoundTables

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
    """Pool tensors on the device and the counters on the host."""

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


def init_state(jobs: int, capacity: int, init_ub: int | None,
               prmu0: np.ndarray | None = None,
               depth0: np.ndarray | None = None,
               p_times: np.ndarray | None = None,
               device="cuda") -> SearchState:
    """Pool with the given seed nodes (default: the root at depth 0);
    `p_times` sizes and fills the front vectors."""
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
    return SearchState(prmu=prmu, depth=depth, aux=aux, size=n,
                       best=I32_MAX if init_ub is None else int(init_ub),
                       tree=0, sol=0, iters=0, evals=0)


def _col_major(x: torch.Tensor, G: int, J: int, TB: int) -> torch.Tensor:
    """(1, B) per-parent row -> (1, N) per-child-slot row in the expand
    column order (c = (g*J + i)*TB + b)."""
    return x.reshape(G, 1, TB).expand(G, J, TB).reshape(1, -1)


def _child_masks(p_depth, valid, G: int, J: int, TB: int):
    """(depth_c, mask): each child column's parent depth and whether it is
    a real child (slot >= depth of a valid parent), in column order."""
    depth_c = _col_major(p_depth, G, J, TB)
    valid_c = _col_major(valid[None, :], G, J, TB)
    slot_c = torch.arange(J, device=p_depth.device)[None, :, None] \
        .expand(G, J, TB).reshape(1, G * J * TB)
    return depth_c, (slot_c >= depth_c) & valid_c


def _partition(push: torch.Tensor) -> torch.Tensor:
    """Stable-partition permutation: indices of the True columns first, in
    order, then the False ones (the same permutation as the JAX packed-key
    sort)."""
    return torch.argsort((~push).to(torch.uint8), stable=True)


def _regather(tables: BoundTables, p_prmu, p_depth2, p_aux, idx,
              TB: int, with_sched: bool = False):
    """Rebuild the children at child columns `idx` (t,) from the popped
    parents: (child (J, t) int16, caux (M+1, t) = [child front | depth+1]
    in the pool's aux dtype[, sched (W, t) int32 scheduled-set words])."""
    J, B = p_prmu.shape
    M = p_aux.shape[0]
    adt = p_aux.dtype
    t = idx.shape[0]
    JTB = J * TB
    g = idx // JTB
    r = idx - g * JTB
    slot = r // TB
    b = r - slot * TB
    pcol = g * TB + b
    pp = p_prmu[:, pcol]                                      # (J, t)
    pf = p_aux[:, pcol].to(torch.int32)                       # (M, t)
    pd = p_depth2.reshape(-1)[pcol][None, :].to(torch.int32)  # (1, t)

    ppi = pp.long()
    rows = torch.arange(J, device=pp.device)[:, None]
    ar = torch.arange(t, device=pp.device)
    appended = ppi[slot, ar][None, :]                         # prmu[slot]
    at_depth = ppi[pd.reshape(-1).clamp(0, J - 1).long(), ar][None, :]
    child = torch.where(rows == pd, appended,
                        torch.where(rows == slot[None, :], at_depth, ppi)) \
        .to(torch.int16)

    cp = tables.p[:, appended.reshape(-1)]                    # (M, t)
    cf = pf[0:1] + cp[0:1]
    cf_rows = [cf]
    for k in range(1, M):
        cf = torch.maximum(cf, pf[k:k + 1]) + cp[k:k + 1]
        cf_rows.append(cf)
    caux = torch.cat(cf_rows + [pd + 1], dim=0).to(adt)       # (M+1, t)
    if not with_sched:
        return child, caux
    sched = ex._as_i32(ex.sched_bits(ppi, rows < pd, appended,
                                     ex.sched_words(J)))
    return child, caux, sched


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
    srt = _partition(push[:t])
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
        return _regather(tables, p_prmu, p_depth2, p_aux, idx, TB,
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
            evals: int, limit: int, start: int) -> SearchState:
    """The no-commit overflow contract: an overflowing step leaves every
    counter as it was and only sets the flag (its block went to the
    scratch margin), so grow + resume continues losslessly."""
    new_size = start + n_push
    if new_size > limit:
        return state._replace(iters=state.iters + 1, overflow=True)
    return state._replace(size=new_size, best=best,
                          tree=state.tree + n_push, sol=sol,
                          iters=state.iters + 1,
                          evals=state.evals + evals)


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
              limit: int) -> int:
    """Everything after the LB1 prune of the two-phase LB2 route, in
    W_-wide frames: the strong-pair head sweep, the mid prune+compact, the
    tail sweep, the final prune+compact and the pool block write. Returns
    n_push."""
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
    else:
        SW = ex.sched_words(J)
        head_t, tail_t = batched.pair_split(tables, KH)
        lb2h = _sweep_tiers(head_t, caux[:M], sched, ncand, N)
        keep = (live_cols < ncand) & (lb2h.reshape(-1) < best)
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
    perm2 = _partition_prefix(push, live, N, two_phase=True, cap=W_)
    children, child_aux = _tiered_compact(
        _take_block(children, caux), perm2, n_push, N, two_phase=True,
        cap=W_)
    _write_block(state, children, child_aux[M].to(torch.int16), child_aux,
                 start, n_push, limit)
    return n_push


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
         route: str | None = None) -> SearchState:
    """One pop -> bound -> prune -> branch cycle. The pool tensors are
    updated in place; the returned state carries the new counters.

    `route` overrides `lb2_route`'s LB2 choice ('dense' or 'prefilter');
    both push the same children in the same column order."""
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

    p_prmu, p_depth, p_aux, n, start, valid = pop_chunk(state, B, M)
    p_aux = p_aux.to(torch.int32)
    depth_c, mask = _child_masks(p_depth, valid, G, J, TB)

    if route == "prefilter":
        # two-phase LB2: LB1 pre-prune (LB1 <= LB2, so sound), then the
        # pair sweeps over the survivors only
        lb1b = ex.expand_bounds(tables, p_prmu, p_depth, p_aux, lb_kind=1,
                                tile=TB)
        n_leaf, best, cand, ncand, n_eval = _leaves_and_push(
            lb1b, mask, depth_c, J, state.best)
        perm1 = _partition(cand)
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
        n_push = _lb2_tail(tables, state, children, caux, sched, ncand, W_,
                           N, best, start, limit)
        return _commit(state, n_push, best, state.sol + n_leaf, n_eval,
                       limit, start)

    if route == "dense":
        # one-shot dense LB2 for the few-pair classes
        bounds = ex.expand(tables, p_prmu, p_depth, p_aux, lb_kind=2,
                           tile=TB)[2]
    else:
        bounds = ex.expand_bounds(tables, p_prmu, p_depth, p_aux,
                                  lb_kind=lb_kind, tile=TB)
    n_leaf, best, push, n_push, n_eval = _leaves_and_push(
        bounds, mask, depth_c, J, state.best)
    perm = _partition(push)
    children, child_aux = _compact_from_parents(
        tables, p_prmu, p_depth, p_aux, perm, n_push, TB, N,
        two_phase=(route == "dense"))
    _write_block(state, children, child_aux[M].to(torch.int16), child_aux,
                 start, n_push, limit)
    return _commit(state, n_push, best, state.sol + n_leaf, n_eval, limit,
                   start)


def run(tables: BoundTables, state: SearchState, lb_kind: int, chunk: int,
        max_iters: int | None = None, tile: int = 1024) -> SearchState:
    """Step until the pool is empty, a step overflows, or the cumulative
    iteration count reaches `max_iters`."""
    jobs, capacity = state.prmu.shape
    if state.size > row_limit(capacity, chunk, jobs):
        return state._replace(overflow=True)
    ceiling = _I64_MAX if max_iters is None else max_iters
    while state.size > 0 and not state.overflow and state.iters < ceiling:
        state = step(tables, lb_kind, chunk, state, tile=tile)
    return state


def run_growing(tables: BoundTables, state: SearchState, lb_kind: int,
                chunk: int, max_iters: int | None = None) -> SearchState:
    """`run`, but on overflow the pool is re-homed into double the
    capacity (checkpoint.grow, lossless) and the run resumes where it
    stopped."""
    from . import checkpoint

    while True:
        state = run(tables, state, lb_kind, chunk, max_iters)
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


def search(p_times: np.ndarray, lb_kind: int = 1, init_ub: int | None = None,
           chunk: int = 64, capacity: int = 1 << 18,
           max_iters: int | None = None, device="cuda") -> SearchResult:
    """Host entry point: build tables, run, report the counters. On
    overflow the pool is re-homed into double the capacity and the search
    resumes where it stopped (`run_growing`)."""
    dev = resolve_device(device)
    tables = batched.make_tables(p_times, device=dev)
    jobs = p_times.shape[1]
    state = init_state(jobs, capacity, init_ub, p_times=p_times, device=dev)
    out = run_growing(tables, state, lb_kind, chunk, max_iters)
    return SearchResult(
        explored_tree=out.tree, explored_sol=out.sol, best=out.best,
        iters=out.iters, evals=out.evals, overflow=False,
        complete=out.size == 0)
