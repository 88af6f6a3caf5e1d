"""The `-C` host tier: a host search running beside the device search,
sharing the incumbent with it.

Reproduces `tpu_tree_search/engine/hybrid.py`. The reference's `-C 1`
runs CPU worker threads beside the GPU managers, all sharing the
incumbent (pfsp_multigpu_cuda.c:61-69, 159-263), and ends with a serial
CPU drain (:487-495). Here:

1. the native runtime grows a warm-up frontier;
2. the frontier is split by stride (`split_host_share`): the host share
   seeds a native multi-threaded search session (`HostSession`, over
   `native.async_start`) that runs in the background, the rest seeds the
   device pool;
3. the device loop (`device.run`, a CUDA graph on the card) explores its
   share in segments; at every segment boundary `post_segment` merges the
   incumbents both ways (`native.async_best`/`async_offer`);
4. the device residue (a pool below `drain_min`, the reference's `-m`)
   drains on host threads with the freshest bound, then the session is
   joined.

With a fixed ub the explored set does not depend on the traversal order,
so the combined counters equal the device-only run's.

`HostSession` and `PyHostSession` (a Python DFS thread over a plugin's
`host_children`, for TSP and knapsack) plug into every driver: `search`
below, the single-device segmented run of the CLI and
`distributed.search`, through `checkpoint.run_segmented(...,
post_segment=session.post_segment)`. `split_host_share`,
`pop_host_share` and `restore_host_share` carve the host share off a
frontier or a checkpointed pool (single-device `(jobs, capacity)` or
stacked `(D, jobs, capacity)`) and push it back.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import native
from ..obs import tracelog
from ..ops import batched
from . import device as engine, distributed, telemetry as tele


class HybridResult(distributed.DistResult):
    pass


def _lower_best(state, merged: int):
    """`state` with each `best` lowered to `merged` on the device: one
    state, or a worker list."""
    def lower(s):
        return s._replace(best=torch.minimum(
            s.best, torch.full_like(s.best, merged)))
    if isinstance(state, list):
        return [lower(s) for s in state]
    return lower(state)


def _device_best(state) -> int:
    """The least incumbent of one state or a worker list, in one read."""
    if isinstance(state, list):
        dev0 = state[0].best.device
        return int(torch.stack([s.best.to(dev0) for s in state]).min())
    return int(state.best.min())


class HostSession:
    """The native host tier of `-C`: owns the async session, the two-way
    incumbent merge at exchange points and the final join. Any driver
    plugs it in through `post_segment`."""

    def __init__(self, p_times, prmu, depth, lb_kind: int, init_ub: int,
                 n_threads: int = 0):
        self.handle = native.async_start(
            np.asarray(p_times), np.asarray(prmu), np.asarray(depth),
            lb_kind=lb_kind, init_ub=int(init_ub), n_threads=n_threads)
        self.seeded = int(len(depth))
        self.exchanges = self.host_improved = self.dev_improved = 0
        self.joined = None

    def merge(self, dev_best: int) -> int:
        """Two-way exchange: min(device, host) incumbent; the device's
        bound goes to the session when it is the tighter one."""
        host_best = native.async_best(self.handle)
        merged = min(int(dev_best), host_best)
        self.exchanges += 1
        if host_best < dev_best:
            self.host_improved += 1
        elif dev_best < host_best:
            self.dev_improved += 1
            native.async_offer(self.handle, merged)
        return merged

    def offer(self, best: int) -> None:
        native.async_offer(self.handle, int(best))

    def join(self):
        """(tree, sol, best, expanded) of the session; idempotent."""
        if self.joined is None:
            self.joined = native.async_join(self.handle)
        return self.joined

    def post_segment(self, state):
        """`checkpoint.run_segmented`'s hook: merge the incumbents of the
        device state (one state, or a worker list) and the session; a
        tighter host bound lowers every `best` on the device."""
        dev_best = _device_best(state)
        merged = self.merge(dev_best)
        return _lower_best(state, merged) if merged < dev_best else state


class PyHostSession:
    """The same session API over a Python DFS thread on the plugin's
    `host_children` (any plugin with `supports_host_tier`: TSP, knapsack).
    `n_threads` is accepted and ignored: a DFS under the interpreter lock
    gains nothing from more threads, and one keeps the counts exact."""

    def __init__(self, problem, table, prmu, depth, lb_kind: int,
                 init_ub: int, n_threads: int = 0):
        del n_threads
        self._prob = problem
        self._table = np.asarray(table)
        self._lb_kind = int(lb_kind)
        self._lock = threading.Lock()
        self._best = int(init_ub)
        self._stack = [(np.asarray(p, np.int16), int(d))
                       for p, d in zip(np.asarray(prmu), np.asarray(depth))]
        self.seeded = int(len(depth))
        self.exchanges = self.host_improved = self.dev_improved = 0
        self.joined = None
        self._tree = self._sol = self._expanded = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        prob, table, lb = self._prob, self._table, self._lb_kind
        slots = prob.slots(table)
        stack, leaf_in_evals = self._stack, prob.leaf_in_evals
        while stack:
            node, depth = stack.pop()
            self._expanded += 1
            if not leaf_in_evals and depth == slots:
                self._sol += 1
                continue
            best = self._best      # one snapshot per expansion
            for child, cdepth, bound, is_leaf in prob.host_children(
                    table, node, depth, best, lb_kind=lb):
                if leaf_in_evals and is_leaf:
                    self._sol += 1
                    if bound < best:
                        with self._lock:
                            if bound < self._best:
                                self._best = bound
                        best = min(best, bound)
                elif bound < best:
                    stack.append((child, cdepth))
                    self._tree += 1

    def merge(self, dev_best: int) -> int:
        """Two-way exchange, the native session's contract."""
        with self._lock:
            host_best = self._best
            merged = min(int(dev_best), host_best)
            self._best = merged
        self.exchanges += 1
        if host_best < dev_best:
            self.host_improved += 1
        elif dev_best < host_best:
            self.dev_improved += 1
        return merged

    def offer(self, best: int) -> None:
        with self._lock:
            self._best = min(self._best, int(best))

    def join(self):
        """(tree, sol, best, expanded); idempotent, waits for the DFS
        thread to drain its share."""
        if self.joined is None:
            self._thread.join()
            self.joined = (self._tree, self._sol, self._best,
                           self._expanded)
        return self.joined

    post_segment = HostSession.post_segment


def make_session(problem, table, prmu, depth, lb_kind: int, init_ub: int,
                 n_threads: int = 0):
    """The `-C` session: the native runtime for PFSP, the Python session
    for another plugin that opted in, and `HostTierUnsupported` for the
    rest."""
    from ..problems import base as problems_base

    if not problem.supports_host_tier:
        raise problems_base.HostTierUnsupported(problem.name)
    if problem.name == "pfsp":
        return HostSession(table, prmu, depth, lb_kind, init_ub,
                           n_threads=n_threads)
    return PyHostSession(problem, table, prmu, depth, lb_kind, init_ub,
                         n_threads=n_threads)


def split_host_share(prmu, depth, host_fraction: int):
    """Split a frontier by stride (roundRobin_distribution): every
    host_fraction-th node goes to the host tier. Returns (dev_mask,
    host_prmu, host_depth); the host share is empty when the frontier is
    too small to split."""
    n = len(depth)
    if host_fraction <= 0 or n < host_fraction:
        return np.ones(n, bool), prmu[:0], depth[:0]
    hmask = np.zeros(n, bool)
    hmask[::host_fraction] = True
    return ~hmask, prmu[hmask], depth[hmask]


def _sizes(state) -> tuple[bool, list[int]]:
    stacked = state.prmu.dim() == 3
    return stacked, state.size.reshape(-1).tolist()


def _with_sizes(state, sizes: list[int], stacked: bool):
    size = torch.tensor(sizes if stacked else sizes[0],
                        dtype=state.size.dtype, device=state.size.device)
    return state._replace(size=size)


def restore_host_share(state, h_prmu, h_depth, p_times, problem=None):
    """Resume WITHOUT `-C` of a checkpoint whose host tier held nodes
    (they ride the checkpoint meta): push them back into the least loaded
    pool, so that no subtree is lost. Their aux rows come from the
    plugin's `seed_aux` (PFSP by default). The pool tensors are written in
    place."""
    n = len(h_depth)
    if n == 0:
        return state
    if problem is None:
        from ..problems import get as _get_problem
        problem = _get_problem("pfsp")
    stacked, sizes = _sizes(state)
    M = state.aux.shape[-2]
    w = int(np.argmin(sizes))
    s = sizes[w]
    if s + n > state.prmu.shape[-1]:
        raise RuntimeError(
            f"no room to restore the {n}-node host share into pool {w} "
            f"(size {s}, capacity {state.prmu.shape[-1]}); resume with "
            "--grow-capacity")
    rows = np.asarray(problem.seed_aux(np.asarray(p_times),
                                       np.asarray(h_prmu),
                                       np.asarray(h_depth)))[:, :M]
    dev = state.prmu.device
    prmu = state.prmu[w] if stacked else state.prmu
    depth = state.depth[w] if stacked else state.depth
    aux = state.aux[w] if stacked else state.aux
    prmu[:, s:s + n] = torch.as_tensor(
        np.asarray(h_prmu, np.int16).T.copy(), device=dev)
    depth[s:s + n] = torch.as_tensor(np.asarray(h_depth, np.int16),
                                     device=dev)
    aux[:, s:s + n] = torch.as_tensor(rows.T.copy(), device=dev).to(aux.dtype)
    sizes[w] = s + n
    return _with_sizes(state, sizes, stacked)


def pop_host_share(state, host_fraction: int, cap: int = 4096):
    """Resume with `-C`: no warm-up frontier exists, so the host tier's
    seed is carved off the TOP of the checkpointed pools (the session
    explores exactly the carved rows, so nothing is lost or counted
    twice). Returns (new_state, host_prmu (n, jobs) int16, host_depth (n,)
    int16)."""
    stacked, sizes = _sizes(state)
    jobs = state.prmu.shape[-2]
    pools_p = state.prmu if stacked else state.prmu[None]
    pools_d = state.depth if stacked else state.depth[None]
    take = [min(s // max(host_fraction, 1), cap // len(sizes)) for s in sizes]
    hp, hd = [], []
    for w, k in enumerate(take):
        s = sizes[w]
        if k > 0:
            hp.append(pools_p[w][:, s - k:s].T)
            hd.append(pools_d[w][s - k:s])
    if not hp:
        return state, np.zeros((0, jobs), np.int16), np.zeros(0, np.int16)
    new_sizes = [s - k for s, k in zip(sizes, take)]
    return (_with_sizes(state, new_sizes, stacked),
            torch.cat(hp).cpu().numpy(), torch.cat(hd).cpu().numpy())


def resume_share(state, meta: dict, problem, table, lb_kind: int,
                 host_fraction: int, host_threads: int = 0):
    """The host tier on a resume. A -C checkpoint carries the tier's seed
    (meta `host_prmu`/`host_depth`), carved out of the pools: with
    `host_fraction > 0` the session is seeded from it (or, lacking one,
    from rows carved off the pools now, `pop_host_share`); without, the
    seed goes back into a pool (`restore_host_share`). Dropping it would
    lose its subtrees. Returns (state, session or None, host_prmu,
    host_depth): the seed to save in the next checkpoint's meta."""
    jobs = state.prmu.shape[-2]
    saved_p = np.asarray(meta.get("host_prmu", np.zeros((0, jobs))),
                         np.int16)
    saved_d = np.asarray(meta.get("host_depth", np.zeros(0)), np.int16)
    h_prmu, h_depth = np.zeros((0, jobs), np.int16), np.zeros(0, np.int16)
    session = None
    if host_fraction > 0:
        if len(saved_d):
            h_prmu, h_depth = saved_p, saved_d
        else:
            state, h_prmu, h_depth = pop_host_share(state, host_fraction)
        if len(h_depth):
            session = make_session(problem, table, h_prmu, h_depth, lb_kind,
                                   int(state.best.min()),
                                   n_threads=host_threads)
    elif len(saved_d):
        state = restore_host_share(state, saved_p, saved_d, table,
                                   problem=problem)
    return state, session, h_prmu, h_depth


def finish(session, best: int):
    """Offer the device's final bound to the session, then join it:
    (host tree, host sol, the best of both, the host's per_device
    fields)."""
    session.offer(best)
    h_tree, h_sol, h_best, h_expanded = session.join()
    return h_tree, h_sol, min(best, h_best), {
        "host_tree": [h_tree], "host_sol": [h_sol],
        "host_expanded": [h_expanded], "exchanges": [session.exchanges],
        "host_improved": [session.host_improved],
        "dev_improved": [session.dev_improved]}


def search(p_times: np.ndarray, lb_kind: int = 1, init_ub: int | None = None,
           chunk: int = 1024, capacity: int = 1 << 20,
           drain_min: int | None = None, host_threads: int = 0,
           host_fraction: int = 8, segment_iters: int = 64,
           tile: int = 1024, device="cuda",
           telemetry: bool | None = None) -> HybridResult:
    """One device with the concurrent native host tier (`-C 1`; JAX
    `hybrid.search`).

    `drain_min` (default: the chunk) is the reference's `-m`: the device
    loop runs while its pool can feed at least that many parents, and the
    residue drains on host threads. The host session seeds with every
    `host_fraction`-th warm-up node (0: no concurrent tier, only warm-up,
    device and drain). `segment_iters` is the exchange cadence in device
    steps. The device part runs on `device` (default the card); the
    native runtime must load, or this raises. Its stages are `tracelog`
    spans: `hybrid.warmup`, `hybrid.seed`, `hybrid.device`,
    `hybrid.drain` and `hybrid.join`."""
    from . import checkpoint

    dev = engine.resolve_device(device)
    jobs = p_times.shape[1]
    tables = batched.make_tables(p_times, device=dev)
    drain_min = chunk if drain_min is None else max(1, drain_min)

    # step 1: native warm-up, so both tiers start with real work
    with tracelog.span("hybrid.warmup") as span:
        fr = distributed.bfs_warmup(p_times, lb_kind, init_ub,
                                    target=max(4 * chunk, 2 * drain_min))
        span.set(frontier=len(fr.depth), tree=fr.tree)
    best0 = fr.best if init_ub is None else min(fr.best, int(init_ub))

    # step 2: the stride split; the host share starts now, the device
    # share seeds the pool
    with tracelog.span("hybrid.seed") as span:
        dmask, h_prmu, h_depth = split_host_share(fr.prmu, fr.depth,
                                                  host_fraction)
        session = None
        if len(h_depth):
            session = HostSession(p_times, h_prmu, h_depth, lb_kind, best0,
                                  n_threads=host_threads)
        state = engine.init_state(jobs, capacity, best0,
                                  prmu0=fr.prmu[dmask],
                                  depth0=fr.depth[dmask], p_times=p_times,
                                  telemetry=telemetry, device=dev)
        span.set(host=len(h_depth), device=int(dmask.sum()))

    # step 3: the device loop in segments, merging incumbents after each
    target = 0
    with tracelog.span("hybrid.device") as span:
        while True:
            target += segment_iters
            state = engine.run(tables, state, lb_kind, chunk,
                               max_iters=target, tile=tile,
                               drain_min=drain_min)
            size, overflow, iters = engine._status(state)
            if overflow:
                capacity *= 2
                state = checkpoint.grow(state, capacity)
                continue
            if session is not None:
                state = session.post_segment(state)
            if size < drain_min:
                break
        span.set(iters=iters)

    # step 4: the host drains the device residue with the freshest bound
    c = engine.counters(state)
    d_tree, d_sol, best = c.tree, c.sol, c.best
    if session is not None:
        best = session.merge(best)
    drained = 0
    if c.size > 0:
        with tracelog.span("hybrid.drain", rows=c.size):
            r_tree, r_sol, best, drained = native.search_from(
                p_times, state.prmu[:, :c.size].T.cpu().numpy(),
                state.depth[:c.size].cpu().numpy(), lb_kind=lb_kind,
                init_ub=best, n_threads=host_threads)
        d_tree += r_tree
        d_sol += r_sol
        if session is not None:
            # a bound the drain improved reaches the session while it
            # still searches
            session.offer(best)

    h_tree = h_sol = h_expanded = 0
    exchanges = host_improved = dev_improved = 0
    if session is not None:
        with tracelog.span("hybrid.join"):
            h_tree, h_sol, h_best, h_expanded = session.join()
        best = min(best, h_best)
        exchanges = session.exchanges
        host_improved = session.host_improved
        dev_improved = session.dev_improved

    return HybridResult(
        explored_tree=d_tree + h_tree + fr.tree,
        explored_sol=d_sol + h_sol + fr.sol,
        best=best,
        per_device={"tree": [d_tree], "sol": [d_sol], "evals": [c.evals],
                    "iters": [c.iters], "steals": [0], "recv": [0],
                    "host_tree": [h_tree], "host_sol": [h_sol],
                    "host_expanded": [h_expanded],
                    "host_drained": [drained],
                    "exchanges": [exchanges],
                    "host_improved": [host_improved],
                    "dev_improved": [dev_improved]},
        warmup_tree=fr.tree, warmup_sol=fr.sol, complete=True,
        telemetry=tele.summarize(state.telemetry))
