"""Single-device PFSP branch-and-bound engine: a device-resident pool and
a device-resident run loop.

Reproduces `tpu_tree_search/engine/device.py` for one device: the pool
layout, `aux_dtype`, `row_limit`, `SearchState` (every counter a device
scalar with the JAX dtype), `init_state`, `lb2_route`, `pop_chunk`,
`_write_block` and `_commit` (the no-commit overflow contract and its
scratch margin, at a device offset under selects), `_lb2_tail` (with the
TTS_DEBUG_STEP tap), `_leaf_scan`, all three routes of `step` (LB1/LB1_d,
LB2 `dense`, LB2 `prefilter`) and the fused route (`_fused_step`,
`ops/fused.py`), the search-telemetry updates of every route
(`engine/telemetry.py`), `run` (with `drain_min` and a `max_iters` ceiling
that needs no new capture), `run_growing`, `search` and
`default_capacity`; and the problem-plugin engine (`problems/base.py`):
`make_children`, `generic_step` (pop, the plugin's `branch` and `bound`,
incumbent and solution accounting, the stable partition, the block write
under the overflow contract, telemetry), `run_problem` (the plugin's step
on the same graph loop as `run`) and `solve` (with grow-on-overflow).

`step` reads nothing back to the host, on any route: the counts it
branches on stay on the device. Where the JAX step picks a frame or a
compaction tier with `lax.switch` on a device count, this step runs
every compaction over its whole frame (`columns.partition` is an O(N)
scan, and the pair sweep takes the live count as a device scalar and
sweeps only those columns); where the JAX fused LB2 step takes its
spill branch, this one runs the fused kernel at frame N, so nothing can
spill. A frame choice changes only the garbage columns above the pool
cursor, never the live pool region `[0, size)` nor a counter, so a step
here and a JAX step from the same state give the same live pool and
counters.

`run` on a CUDA pool replays a CUDA graph of `GRAPH_STEPS` captured
steps (cached by shape, route, mode and pool storage) and reads `size`,
`overflow` and `iters` once per replay; on the CPU it runs the same
steps eagerly with the same check every `GRAPH_STEPS` steps. A step
whose loop condition `(size >= drain_min) & ~overflow & (iters <
max_iters)` fails on the device is a no-op (nothing popped, committed
or counted), so a block of K steps ends exactly where JAX's
`while_loop` ends.

Pool layout (feature-major, the node axis last):
    prmu  int16[jobs, capacity]     permutations (a plugin's node rows)
    depth int16[capacity]           scheduled-prefix length
    aux   int16|int32[M, capacity]  machine-completion front of the prefix
                                    (a plugin's A aux rows, A may be 0)

Entry points run on `cuda` unless the caller passes `device="cpu"`; asking
for `cuda` where there is none raises.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..ops import (batched, columns as cols, expand as ex, fused as fz,
                   kernels, reference as ref)
from ..ops.batched import BoundTables
from ..utils import config as _cfg
from . import telemetry as tele

I32_MAX = 2**31 - 1
_I64_MAX = 2**63 - 1
# steps in one captured CUDA graph, and between two reads of the counters
# of a run on the CPU
GRAPH_STEPS = 32
# captured graphs kept (each holds its steps' device memory)
_GRAPH_CACHE = 4
# the LB2 debug tap (`_lb2_tail`), read once at import as in the JAX
# package: a graph captured with the tap keeps it
_DEBUG_STEP = _cfg.env_flag("TTS_DEBUG_STEP")

# the state's counters and their dtypes (the JAX package's)
COUNTER_DTYPES = {"size": torch.int32, "best": torch.int32,
                  "tree": torch.int64, "sol": torch.int64,
                  "iters": torch.int64, "evals": torch.int64,
                  "sent": torch.int64, "recv": torch.int64,
                  "steals": torch.int64, "overflow": torch.bool}


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


_front_dtype = aux_dtype     # `init_state`'s parameter shadows the name


def row_limit(capacity: int, chunk: int, jobs: int) -> int:
    """Usable pool rows. The top `chunk*jobs` rows are a scratch margin:
    an overflowing step writes its block there, so the live region stays
    untouched."""
    return max(capacity - chunk * jobs, 0)


class SearchState(NamedTuple):
    """Pool tensors, counters and the telemetry vector, all on the
    pool's device; `counters` reads the counters back."""

    prmu: torch.Tensor       # (jobs, capacity) int16
    depth: torch.Tensor      # (capacity,) int16
    aux: torch.Tensor        # (machines, capacity) aux_dtype front vectors
    size: torch.Tensor       # () int32 live-row cursor
    best: torch.Tensor       # () int32 incumbent makespan
    tree: torch.Tensor       # () int64 explored (= pushed) internal nodes
    sol: torch.Tensor        # () int64 evaluated leaf children
    iters: torch.Tensor      # () int64 loop iterations
    evals: torch.Tensor      # () int64 child bound evaluations
    sent: torch.Tensor       # () int64 multi-device balance counters (0 on
    recv: torch.Tensor       # () int64 one device)
    steals: torch.Tensor     # () int64
    overflow: torch.Tensor   # () bool
    telemetry: torch.Tensor  # (WIDTH,) int64, or (0,) when telemetry is
                             # off (engine/telemetry.py)


class Counters(NamedTuple):
    """A state's counters on the host."""

    size: int
    best: int
    tree: int
    sol: int
    iters: int
    evals: int
    sent: int
    recv: int
    steals: int
    overflow: bool


def counters(state: SearchState) -> Counters:
    """Every counter of `state`, read back in one transfer."""
    vals = torch.stack([getattr(state, f).long()
                        for f in Counters._fields]).tolist()
    return Counters(*vals[:-1], overflow=bool(vals[-1]))


def counter_tensors(device, size: int, best: int, tree: int = 0,
                    sol: int = 0, iters: int = 0, evals: int = 0,
                    sent: int = 0, recv: int = 0, steals: int = 0,
                    overflow: bool = False) -> dict:
    """The counter fields of a SearchState, as device scalars."""
    vals = dict(size=size, best=best, tree=tree, sol=sol, iters=iters,
                evals=evals, sent=sent, recv=recv, steals=steals,
                overflow=overflow)
    return {f: torch.full((), v, dtype=COUNTER_DTYPES[f], device=device)
            for f, v in vals.items()}


def init_state(jobs: int, capacity: int, init_ub: int | None,
               prmu0: np.ndarray | None = None,
               depth0: np.ndarray | None = None,
               p_times: np.ndarray | None = None,
               telemetry: bool | None = None,
               device="cuda", aux0: np.ndarray | None = None,
               aux_dtype: torch.dtype | None = None) -> SearchState:
    """Pool with the given seed nodes (default: the root at depth 0);
    `p_times` (PFSP) sizes and fills the front vectors; `aux0` ((n, A)
    host rows, any plugin: `Problem.seed_aux`) fills A aux rows of
    `aux_dtype` (None: aux0's dtype). Without either the aux width is 0.
    `telemetry` gives the state the search-telemetry vector (None: the
    TTS_SEARCH_TELEMETRY flag)."""
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
        aux = torch.zeros((m, capacity), dtype=_front_dtype(p_times),
                          device=dev)
        fr = ref.prefix_front_remain(p_times, prmu0, depth0)[:, :m].T
        aux[:, :n] = torch.as_tensor(fr.copy(), device=dev).to(aux.dtype)
    elif aux0 is not None and np.asarray(aux0).shape[-1] > 0:
        rows = torch.as_tensor(np.asarray(aux0).reshape(n, -1).T.copy())
        aux = torch.zeros((rows.shape[0], capacity),
                          dtype=aux_dtype or rows.dtype, device=dev)
        aux[:, :n] = rows.to(device=dev, dtype=aux.dtype)
    else:
        aux = torch.zeros((0, capacity), dtype=torch.int32, device=dev)
    on = tele.enabled() if telemetry is None else telemetry
    return SearchState(
        prmu=prmu, depth=depth, aux=aux,
        **counter_tensors(dev, size=n,
                          best=I32_MAX if init_ub is None else int(init_ub)),
        telemetry=torch.zeros(tele.WIDTH if on else 0, dtype=torch.int64,
                              device=dev))


def _tele_on(state: SearchState) -> bool:
    return state.telemetry.shape[-1] > 0


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


def pop_chunk(state: SearchState, B: int, M: int,
              active: torch.Tensor | None = None):
    """Pop window of up to B parents off the stack top (no commit):
    (p_prmu (J, B) int16, p_depth (1, B) int32, p_aux (M, B) in the pool's
    aux dtype, n, start, valid), with n and start int32 device scalars.
    `active` (a device bool, None: True) False pops nothing."""
    dev = state.prmu.device
    n = state.size.clamp(max=B)
    if active is not None:
        n = torch.where(active, n, 0)
    start = state.size - n
    lanes = torch.arange(B, device=dev)
    valid = lanes < n
    at = start.long() + lanes
    p_prmu = state.prmu.index_select(1, at)
    p_depth = state.depth.index_select(0, at).to(torch.int32)
    p_depth = torch.where(valid, p_depth, 0)[None, :]
    p_aux = state.aux[:M].index_select(1, at)
    return p_prmu, p_depth, p_aux, n, start, valid


def _write_block(state: SearchState, children, child_depth, child_aux,
                 start, n_push, limit: int) -> None:
    """Write the compacted block at the cursor, or into the scratch margin
    at `limit` when the step overflows (the `start + n_push > limit` of
    `_commit`). Updates the pool in place, at a device offset."""
    M = child_aux.shape[0] - 1
    at = torch.where(start + n_push > limit, limit, start)
    cols_at = at.long() + torch.arange(children.shape[1],
                                       device=children.device)
    state.prmu.index_copy_(1, cols_at, children)
    state.depth.index_copy_(0, cols_at, child_depth)
    state.aux.index_copy_(1, cols_at, child_aux[:M].to(state.aux.dtype))


def _commit(state: SearchState, n_push, best, sol, evals, limit: int,
            start, tele_delta: torch.Tensor | None = None,
            active: torch.Tensor | None = None) -> SearchState:
    """The no-commit overflow contract: an overflowing step leaves every
    counter and the telemetry vector as they were, counts its iteration
    and sets the flag (its block went to the scratch margin), so grow +
    resume continues losslessly. Every counter is guarded with a select.
    `tele_delta` (telemetry.step_delta, None when telemetry is off) is
    folded in with the slots `telemetry.commit` owns. A step that is not
    `active` commits and counts nothing."""
    new_size = start + n_push
    over = new_size > limit
    if active is not None:
        over = over & active
    keep = ~over if active is None else active & ~over

    def sel(new, old):
        return torch.where(keep, new, old)

    telem = state.telemetry
    if tele_delta is not None:
        telem = sel(tele.commit(telem, tele_delta, new_size, best,
                                state.best, state.iters), telem)
    return state._replace(
        size=sel(new_size, state.size), best=sel(best, state.best),
        tree=sel(state.tree + n_push, state.tree), sol=sel(sol, state.sol),
        iters=state.iters + (1 if active is None else active.long()),
        evals=sel(state.evals + evals, state.evals),
        overflow=state.overflow | over, telemetry=telem)


def _take_block(*rows_arrays):
    """column-gather closure over the given (rows, frame) arrays."""
    def take(idx):
        return tuple(a[:, idx] for a in rows_arrays)
    return take


def _debug_tap(tables: BoundTables) -> bool:
    """JAX's debug-tap condition: TTS_DEBUG_STEP at import, assertions on,
    and a pair table split into head and tail sweeps."""
    return bool(__debug__ and _DEBUG_STEP
                and int(tables.ma0.shape[0]) > batched.PAIR_PREFILTER)


def _lb2_tail(tables: BoundTables, state: SearchState, children, caux,
              sched, ncand, best, start, limit: int, TELE: bool = False,
              debug_tap: bool = False, active=None):
    """Everything after the LB1 prune of the two-phase LB2 route, over the
    frame of `children` (its first `ncand` columns live): the strong-pair
    head sweep, the mid prune+compact, the tail sweep, the final
    prune+compact and the pool block write. The unfused prefilter route
    and the fused route both end here. Each sweep takes its live count as
    a device scalar and sweeps only those columns. Returns (state, n_push,
    tele_tail): with `TELE`, the (DB + 2*BB,) branched buckets,
    pruned-bound and surviving-bound histograms of this part, else None.

    `debug_tap` (`_debug_tap`) writes the sums of the head and tail bounds
    over the live columns and `n_push` into the returned state's `sent`,
    `recv` and `steals` (JAX's tap), on the device; a step that is not
    `active` leaves them."""
    J, W_ = children.shape
    M = tables.p.shape[0]
    P = int(tables.ma0.shape[0])
    KH = batched.PAIR_PREFILTER
    live_cols = torch.arange(W_, device=children.device)
    caux = caux.to(torch.int32)

    if P <= KH:
        lb2b = ex.lb2_bounds(tables, caux[:M], sched, live=ncand)
        live = ncand
        head_hp = 0
    else:
        SW = ex.sched_words(J)
        head_t, tail_t = batched.pair_split(tables, KH)
        lb2h = ex.lb2_bounds(head_t, caux[:M], sched, live=ncand)
        keep = (live_cols < ncand) & (lb2h.reshape(-1) < best)
        if TELE:
            # pruned by the head sweep: binned at the partial bound that
            # pruned them (partial max <= LB2)
            head_hp = tele.bound_hist(lb2h, (live_cols < ncand) & ~keep,
                                      best)
        nkeep = keep.sum(dtype=torch.int32)
        aux_plus = torch.cat([caux, sched, lb2h], dim=0)
        children, aux_plus = _take_block(children, aux_plus)(
            cols.partition(keep))
        caux = aux_plus[:M + 1]
        sched = aux_plus[M + 1:M + 1 + SW]
        lb2h_c = aux_plus[M + 1 + SW:M + 2 + SW]
        lb2t = ex.lb2_bounds(tail_t, caux[:M], sched, live=nkeep)
        lb2b = torch.maximum(lb2h_c, lb2t)
        live = nkeep

    push = (live_cols < live) & (lb2b.reshape(-1) < best)
    n_push = push.sum(dtype=torch.int32)
    if debug_tap:
        lv = live_cols < live
        tap = {"sent": torch.where(lv, lb2h_c.reshape(-1), 0).sum(
                   dtype=torch.int64),
               "recv": torch.where(lv, lb2t.reshape(-1), 0).sum(
                   dtype=torch.int64),
               "steals": n_push.long()}
        if active is not None:
            tap = {f: torch.where(active, v, getattr(state, f))
                   for f, v in tap.items()}
        state = state._replace(**tap)
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
    children, child_aux = _take_block(children, caux)(cols.partition(push))
    _write_block(state, children, child_aux[M].to(torch.int16), child_aux,
                 start, n_push, limit)
    return state, n_push, tele_tail


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
                state: SearchState, p_prmu, p_depth, p_aux, n, start,
                valid, limit: int, active=None) -> SearchState:
    """The fused bound+prune+compact route (`ops/fused.py`): the dense
    child grid, its bound row, the prune mask and the partition never
    exist. The kernel returns the compacted survivors and their count;
    leaves and evals come from the parent-level `_leaf_scan`. The pruning
    incumbent `min(best, leaf_best)` and every count stay on the device.

    The kernel's frame is N on both bounds: LB1 writes it as the block;
    LB2 `prefilter` runs `_lb2_tail` on it. So no survivor count can
    outgrow the frame, and the step never needs the unfused spill route
    (the JAX engine's `spill_tail`, whose explored set is the same).
    Telemetry: popped and evaluated buckets are parent-level, branched
    buckets and the surviving-bound histogram come off the compacted
    block, and the pruned-bound histogram is the kernel's."""
    J = state.prmu.shape[0]
    M = tables.p.shape[0]
    N = B * J
    TELE = _tele_on(state)

    leaf_best, n_leaf, evals = _leaf_scan(tables, p_prmu, p_depth, p_aux,
                                          valid)
    best = torch.minimum(leaf_best, state.best)     # int32 device scalar
    if TELE:
        d = p_depth.reshape(-1)
        wb = tele.depth_bucket(d, J)
        popped_b = tele.bucket_counts(wb, valid)
        # J - d evaluated non-leaf children per valid parent below J-1
        evalnl_b = tele.bucket_counts(wb, valid & (d < J - 1), J - d)
    kch, kaux, kbnd, ksched, n_surv, khist = fz.fused_expand(
        tables, p_prmu, p_depth, p_aux, n, best, lb_kind=1, tile=TB,
        cap_width=N, with_sched=(route == "prefilter"),
        tele_bins=tele.BOUND_BINS if TELE else 0,
        with_bounds=(lb_kind != 2 and TELE),
        aux_i16=(lb_kind != 2 and state.aux.dtype == torch.int16))
    sol = state.sol + n_leaf
    DB, BB = tele.DEPTH_BUCKETS, tele.BOUND_BINS

    if lb_kind != 2:
        _write_block(state, kch, kaux[M].to(torch.int16), kaux, start,
                     n_surv, limit)
        delta = None
        if TELE:
            surv = torch.arange(N, device=kch.device) < n_surv
            branched_b = tele.bucket_counts(
                tele.depth_bucket(kaux[M] - 1, J), surv)
            delta = tele.step_delta(
                popped_b, branched_b, evalnl_b - branched_b, khist,
                tele.bound_hist(kbnd, surv, best))
        return _commit(state, n_surv, best, sol, evals, limit, start,
                       tele_delta=delta, active=active)

    state, n_push, tail = _lb2_tail(tables, state, kch, kaux, ksched,
                                    n_surv, best, start, limit, TELE,
                                    _debug_tap(tables), active)
    delta = None
    if TELE:
        delta = tele.step_delta(popped_b, tail[:DB], evalnl_b - tail[:DB],
                                khist + tail[DB:DB + BB], tail[DB + BB:])
    return _commit(state, n_push, best, sol, evals, limit, start,
                   tele_delta=delta, active=active)


def _leaves_and_push(bounds, mask, depth_c, J: int, best_in):
    """Leaf count, incumbent and push mask of a dense bound row, as device
    values: (n_leaf, best, push, n_push, n_eval)."""
    is_leaf = ((depth_c + 1) == J) & mask
    leaf_best = torch.where(is_leaf, bounds, I32_MAX).min()
    best = torch.minimum(leaf_best, best_in)
    push = (mask & ~is_leaf & (bounds < best)).reshape(-1)
    return (is_leaf.sum(), best, push, push.sum(dtype=torch.int32),
            mask.sum())


def step(tables: BoundTables, lb_kind: int, chunk: int,
         state: SearchState, tile: int = 1024, limit: int | None = None,
         route: str | None = None, fused: str | None = None,
         active: torch.Tensor | None = None) -> SearchState:
    """One pop -> bound -> prune -> branch cycle, all on the device: it
    reads nothing back. The pool tensors are updated in place; the
    returned state carries the new counters.

    `route` overrides `lb2_route`'s LB2 choice ('dense' or 'prefilter');
    both push the same children in the same column order. `fused` is a
    mode of `ops/fused.py` ("off", "hw", "interpret"; None: "hw" on CUDA
    tensors, "off" on the CPU, `fused.resolve_mode`); where `fused_ok`
    admits the shape, LB1 and LB2 `prefilter` take the fused route, with
    the same result. `active`, a device bool (None: True), makes the
    step a no-op when False: it pops, commits and counts nothing (`run`'s
    loop condition)."""
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
    if limit is None:
        limit = row_limit(capacity, B, J)

    fused = fz.resolve_mode(fused, on_cuda=state.prmu.is_cuda)
    p_prmu, p_depth, p_aux, n, start, valid = pop_chunk(state, B, M, active)
    p_aux = p_aux.to(torch.int32)
    if (fz.fused_ok(fused, J, TB, lb_kind, M, device=state.prmu.device)
            and (lb_kind == 1 or route == "prefilter")):
        return _fused_step(tables, lb_kind, route, B, TB, state, p_prmu,
                           p_depth, p_aux, n, start, valid, limit, active)
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
        children, caux, sched = cols.regather(
            tables, p_prmu, p_depth, p_aux, cols.partition(cand), TB,
            with_sched=True)
        state, n_push, tail = _lb2_tail(tables, state, children, caux,
                                        sched, ncand, best, start, limit,
                                        TELE, _debug_tap(tables), active)
        delta = None
        if TELE:
            # the LB1 prefilter's prunes bin at the bound that pruned them
            hist_lb1 = tele.bound_hist(lb1b, nonleaf & ~cand, best)
            delta = tele.step_delta(popped_b, tail[:DB],
                                    evalnl_b - tail[:DB],
                                    hist_lb1 + tail[DB:DB + BB],
                                    tail[DB + BB:])
        return _commit(state, n_push, best, state.sol + n_leaf, n_eval,
                       limit, start, tele_delta=delta, active=active)

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
    children, child_aux = cols.regather(tables, p_prmu, p_depth, p_aux,
                                        cols.partition(push), TB)
    _write_block(state, children, child_aux[M].to(torch.int16), child_aux,
                 start, n_push, limit)
    return _commit(state, n_push, best, state.sol + n_leaf, n_eval, limit,
                   start, tele_delta=delta, active=active)


# the dense (B, J, J) prefix-swap child grid of a popped block (JAX
# `device.make_children`), which the permutation plugins branch with; a
# slot that is no real child (below the depth, or of a complete node) is
# garbage, written above the pool cursor and never read
make_children = ex.make_children


def generic_step(problem, tables, lb_kind: int, chunk: int,
                 state: SearchState, tile: int = 1024,
                 limit: int | None = None,
                 active: torch.Tensor | None = None) -> SearchState:
    """One problem-generic pop -> branch -> bound -> prune -> compact
    cycle (JAX `generic_step`), all on the device: it reads nothing back.
    The plugin (`problems/base.Problem`) gives the dense child grid
    (`branch`) and the child bounds (`bound`); the pop, the incumbent and
    solution accounting, the stable partition (`columns.partition`, the
    permutation of JAX's stable argsort of `~push`), the block write at
    the cursor or into the scratch margin, the no-commit overflow
    contract and the telemetry block are shared. The pool is updated in
    place; the returned state carries the new counters. `limit` (None:
    `problem.usable_rows`) is the overflow line. `active` (a device bool,
    None: True) False makes the step a no-op, as `step`'s. `tile` is
    taken for the fast-path hook's signature and ignored."""
    del tile
    J, capacity = state.prmu.shape
    A = state.aux.shape[0]
    B = chunk
    if limit is None:
        limit = problem.usable_rows(capacity, B, J)
    p_prmu, p_depth, p_aux, n, start, valid = pop_chunk(state, B, A, active)
    depth = p_depth.reshape(-1)
    p_aux = p_aux.to(torch.int32)

    sol = state.sol
    if not problem.leaf_in_evals:
        # N-Queens style: a popped complete node is a solution
        # (nqueens_c.c:104-106); complete children are pushed like any
        sol = sol + ((depth == J) & valid).sum()

    br = problem.branch(tables, p_prmu, depth, p_aux, valid)
    C = br.children.shape[1]
    if C > B * (problem.branch_factor or J):
        raise ValueError(
            f"branch grid {C} wider than the chunk*branching scratch "
            f"margin {B * (problem.branch_factor or J)}")
    bounds = problem.bound(tables, lb_kind, br, state.best).reshape(-1)
    evaluated = br.evaluated.reshape(-1)
    if problem.leaf_in_evals:
        # PFSP style: every evaluated leaf counts, the incumbent tightens
        # from leaf bounds (bound == objective there), leaves never push
        is_leaf = evaluated & problem.is_leaf_cols(tables, br).reshape(-1)
        sol = sol + is_leaf.sum()
        leaf_best = torch.where(is_leaf, bounds, I32_MAX).min()
        best = torch.minimum(state.best, leaf_best)
        push = evaluated & ~is_leaf & (bounds < best)
    else:
        is_leaf = torch.zeros_like(evaluated)
        best = state.best
        push = evaluated & (bounds < best)
    n_push = push.sum(dtype=torch.int32)

    order = cols.partition(push)
    at = torch.where(start + n_push > limit, limit, start)
    cols_at = at.long() + torch.arange(C, device=state.prmu.device)
    state.prmu.index_copy_(1, cols_at, br.children[:, order])
    state.depth.index_copy_(0, cols_at, br.child_depth[order])
    if A:
        state.aux.index_copy_(1, cols_at,
                              br.child_aux[:, order].to(state.aux.dtype))

    delta = None
    if _tele_on(state):
        # child buckets bin by parent depth (child_depth - 1), as `step`;
        # the histograms bin every pruned and surviving child, unbounded
        # problems' 0 / I32_MAX bounds in fixed bins
        cb = tele.depth_bucket(br.child_depth.long() - 1, J)
        pruned_m = evaluated & ~is_leaf & ~push
        delta = tele.step_delta(
            tele.bucket_counts(tele.depth_bucket(depth, J), valid),
            tele.bucket_counts(cb, push), tele.bucket_counts(cb, pruned_m),
            tele.bound_hist(bounds, pruned_m, best),
            tele.bound_hist(bounds, push, best))
    return _commit(state, n_push, best, sol, evaluated.sum(), limit, start,
                   tele_delta=delta, active=active)


def _loop_cond(state: SearchState, drain_min, max_iters) -> torch.Tensor:
    """JAX `_run`'s `while_loop` condition, as a device bool."""
    return ((state.size >= drain_min) & ~state.overflow
            & (state.iters < max_iters))


class _Graph(NamedTuple):
    """K captured steps on one pool: the graph, the counters and
    telemetry vector it reads and writes (its own tensors; the pool is
    the caller's, held by address only, so a dropped pool is freed), its
    loop-condition inputs, the (size, overflow, iters) it leaves, and the
    kernel launches of one replay."""

    graph: torch.cuda.CUDAGraph
    counters: dict
    telemetry: torch.Tensor
    max_iters: torch.Tensor
    drain_min: torch.Tensor
    status: torch.Tensor
    launches: dict


_GRAPHS: OrderedDict = OrderedDict()


def clear_graphs() -> None:
    """Drop every captured graph (and the device memory it holds)."""
    _GRAPHS.clear()


def _graph_key(tables, state, lb_kind, chunk, tile, mode, steps,
               name: str = "pfsp"):
    """A graph's cache key: the problem, its step's static arguments and
    the storage of every tensor the graph reads (the plugin's tables, a
    NamedTuple of tensors or one tensor, and the pool)."""
    tensors = ((tables,) if isinstance(tables, torch.Tensor)
               else tuple(t for t in tables if isinstance(t, torch.Tensor)))
    storage = tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                    for t in (*tensors, state.prmu, state.depth, state.aux))
    return (name, lb_kind, chunk, tile, mode, state.telemetry.shape[0],
            steps, state.prmu.device, storage)


def _capture(step_fn, state, steps) -> _Graph:
    """Capture `steps` calls of `step_fn(state, active=...)` on `state`'s
    pool (updated in place, at the addresses the graph holds;
    `_graph_key` replays it only on a pool at those addresses). A failed
    capture raises. One no-op step runs first on a side stream, so that
    every kernel's first launch (its attributes) and the allocator's
    first blocks happen outside the capture."""
    dev = state.prmu.device
    static = state._replace(
        **{f: getattr(state, f).clone() for f in COUNTER_DTYPES},
        telemetry=state.telemetry.clone())
    max_iters = torch.zeros((), dtype=torch.int64, device=dev)
    drain_min = torch.ones((), dtype=torch.int32, device=dev)
    status = torch.zeros(3, dtype=torch.int64, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step_fn(static, active=torch.zeros((), dtype=torch.bool, device=dev))
    torch.cuda.current_stream(dev).wait_stream(side)
    kernels.take_captured()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        s = static
        for _ in range(steps):
            s = step_fn(s, active=_loop_cond(s, drain_min, max_iters))
        for f in COUNTER_DTYPES:
            getattr(static, f).copy_(getattr(s, f))
        static.telemetry.copy_(s.telemetry)
        status.copy_(torch.stack([s.size.long(), s.overflow.long(),
                                  s.iters]))
    return _Graph(graph, {f: getattr(static, f) for f in COUNTER_DTYPES},
                  static.telemetry, max_iters, drain_min, status,
                  kernels.take_captured())


def _status(state: SearchState) -> list:
    """(size, overflow, iters) on the host, in one transfer."""
    return torch.stack([state.size.long(), state.overflow.long(),
                        state.iters]).tolist()


def _run_graph(step_fn, key, state, ceiling, drain, steps,
               going) -> SearchState:
    g = _GRAPHS.pop(key, None)
    if g is None:
        g = _capture(step_fn, state, steps)
    _GRAPHS[key] = g
    while len(_GRAPHS) > _GRAPH_CACHE:
        _GRAPHS.popitem(last=False)
    for f, t in g.counters.items():
        t.copy_(getattr(state, f))
    g.telemetry.copy_(state.telemetry)
    g.max_iters.fill_(ceiling)
    g.drain_min.fill_(drain)
    kernels.replay(g.graph, g.launches)
    while going(g.status.tolist()):
        kernels.replay(g.graph, g.launches)
    return state._replace(**{f: t.clone() for f, t in g.counters.items()},
                          telemetry=g.telemetry.clone())


def _drive(step_fn, key, state: SearchState, usable: int,
           max_iters: int | None, drain_min: int,
           steps: int) -> SearchState:
    """The loop `run` and `run_problem` share: step while `size >=
    drain_min`, no step overflowed and `iters < max_iters`, reading
    (size, overflow, iters) once every `steps` steps; a pool already
    above `usable` rows reports overflow untouched. On a CUDA pool the
    steps are replays of a graph cached under `key`; on the CPU they run
    eagerly."""
    ceiling = _I64_MAX if max_iters is None else int(max_iters)
    drain = max(int(drain_min), 1)

    def going(status) -> bool:
        size, overflow, iters = status
        return size >= drain and not overflow and iters < ceiling

    status = _status(state)
    if status[0] > usable:
        return state._replace(overflow=torch.ones_like(state.overflow))
    if not going(status):
        return state
    if state.prmu.is_cuda:
        return _run_graph(step_fn, key, state, ceiling, drain, steps, going)
    dev = state.prmu.device
    lim = torch.full((), ceiling, dtype=torch.int64, device=dev)
    dmin = torch.full((), drain, dtype=torch.int32, device=dev)
    while True:
        # no step past the ceiling: such a step is a no-op that still
        # bounds a whole frame on the CPU (the graph's block stays whole)
        for _ in range(min(steps, ceiling - status[2])):
            state = step_fn(state, active=_loop_cond(state, dmin, lim))
        status = _status(state)
        if not going(status):
            return state


def run(tables: BoundTables, state: SearchState, lb_kind: int, chunk: int,
        max_iters: int | None = None, tile: int = 1024, drain_min: int = 1,
        fused=None, steps_per_check: int = GRAPH_STEPS) -> SearchState:
    """Step while `size >= drain_min`, no step overflowed and the
    cumulative iteration count is below `max_iters` (JAX `run`). On a
    CUDA pool: replays of a captured graph of `steps_per_check` steps,
    reading `size`, `overflow` and `iters` once a replay (a new ceiling
    or drain reuses the graph; a capture that fails raises). On the CPU:
    the same steps, eagerly, with the same check. Each step past the
    condition is a device no-op, so the result is JAX's. `fused` (None:
    "hw" on CUDA tensors, "off" on the CPU) is resolved here, once, on
    the host (`fused.resolve_mode`). `steps_per_check` is for tests."""
    jobs, capacity = state.prmu.shape
    mode = fz.resolve_mode(fused, on_cuda=state.prmu.is_cuda)
    step_fn = functools.partial(step, tables, lb_kind, chunk, tile=tile,
                                fused=mode)
    key = _graph_key(tables, state, lb_kind, chunk, tile, mode,
                     steps_per_check)
    return _drive(step_fn, key, state, row_limit(capacity, chunk, jobs),
                  max_iters, drain_min, steps_per_check)


def run_problem(problem, tables, state: SearchState, lb_kind: int,
                chunk: int, max_iters: int | None = None, tile: int = 1024,
                drain_min: int = 1, fused=None,
                steps_per_check: int = GRAPH_STEPS) -> SearchState:
    """`run` for any plugin (JAX `run_problem`): the plugin's step
    (`make_step`: PFSP's `step`, else `generic_step`) on the same loop,
    with the plugin's overflow line `usable_rows` (its branching, not the
    node width, sizes the scratch margin). The graph key carries the
    problem's name; PFSP's is `run`'s, so the two share graphs. `fused`
    is resolved as `run` does for a plugin that uses it
    (`supports_fused`), else the mode is "off"."""
    jobs, capacity = state.prmu.shape
    mode = (fz.resolve_mode(fused, on_cuda=state.prmu.is_cuda)
            if problem.supports_fused else "off")
    step_fn = problem.make_step(tables, lb_kind, chunk, tile, None,
                                fused=mode)
    key = _graph_key(tables, state, lb_kind, chunk, tile, mode,
                     steps_per_check, problem.name)
    return _drive(step_fn, key, state,
                  problem.usable_rows(capacity, chunk, jobs), max_iters,
                  drain_min, steps_per_check)


def run_growing(tables: BoundTables, state: SearchState, lb_kind: int,
                chunk: int, max_iters: int | None = None,
                fused=None) -> SearchState:
    """`run`, but on overflow the pool is re-homed into double the
    capacity (checkpoint.grow, lossless) and the run resumes where it
    stopped."""
    from . import checkpoint

    while True:
        state = run(tables, state, lb_kind, chunk, max_iters, fused=fused)
        if not bool(state.overflow):
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
    c = counters(out)
    return SearchResult(
        explored_tree=c.tree, explored_sol=c.sol, best=c.best,
        iters=c.iters, evals=c.evals, overflow=False,
        complete=c.size == 0, telemetry=tele.summarize(out.telemetry))


def solve(problem, table: np.ndarray, lb_kind: int | None = None,
          init_ub: int | None = None, chunk: int = 64,
          capacity: int | None = None, max_iters: int | None = None,
          device="cuda", telemetry: bool | None = None) -> SearchResult:
    """Host entry point for any registered problem (JAX `solve`): the
    plugin's tables on `device`, the pool seeded from its root, then
    `run_problem` to exhaustion; on overflow the pool is re-homed into
    double the capacity (`checkpoint.grow`, lossless) and the run resumes
    where it stopped. `problem` is a plugin or a registry name; `init_ub`
    is in the engine's minimized domain (`Problem.engine_objective`);
    `telemetry`: see `init_state`."""
    from . import checkpoint

    if isinstance(problem, str):
        from .. import problems as problems_pkg
        problem = problems_pkg.get(problem)
    dev = resolve_device(device)
    table = np.asarray(table)
    if lb_kind is None:
        lb_kind = problem.default_lb
    tables = problem.make_tables(table, device=dev)
    jobs = problem.slots(table)
    if capacity is None:
        capacity = problem.default_capacity(table)
    prmu0, depth0 = problem.root(table)
    state = init_state(jobs, capacity, init_ub, prmu0=prmu0, depth0=depth0,
                       aux0=problem.seed_aux(table, prmu0, depth0),
                       aux_dtype=problem.aux_dtype(table),
                       telemetry=telemetry, device=dev)
    while True:
        out = run_problem(problem, tables, state, lb_kind, chunk, max_iters)
        c = counters(out)
        if not c.overflow:
            return SearchResult(
                explored_tree=c.tree, explored_sol=c.sol, best=c.best,
                iters=c.iters, evals=c.evals, overflow=False,
                complete=c.size == 0, telemetry=tele.summarize(out.telemetry))
        capacity *= 2
        state = checkpoint.grow(out, capacity)
