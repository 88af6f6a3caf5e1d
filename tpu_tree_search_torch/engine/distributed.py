"""Multi-worker branch-and-bound: one process drives D workers, each with
its own pool on its own `torch.device`.

Reproduces `tpu_tree_search/engine/distributed.py`: `Frontier`,
`default_transfer_cap`, `bfs_warmup` (the native runtime first, the
Python warm-up after one warning), `_shard_frontier` (round-robin
stripes `d::D`), `_balance_round`, `member_body` (one macro-iteration),
the loop of `build_dist_loop`, `DistResult`, `fetch_state`,
`_DistDriver` (`limit`, `seed`, `commit`, `run`, which grows every pool
x2 and resumes on overflow, and `run_async`, the overlapped driver's
dispatch), `_problem_driver` and `search`.

The JAX engine is one `shard_map`ped program over a mesh; here a search
holds a list of single-device `SearchState`s, one per worker, and each
collective is torch operations on device tensors that read nothing back:

- `pmin(best)`: the minimum of the workers' `best`, written back to each;
- `all_gather(size)`: a stack of the sizes;
- the steal-half plan: `parallel/balance.exchange_plan` on the device;
- `all_to_all`: for each (donor, receiver) pair a fixed-width
  `transfer_cap` block gathered from the donor's stack top and copied to
  the receiver's device (`.to`, a no-op when both share a device);
- `argsort(~push, stable=True)`: `ops/columns.partition`;
- `lax.cond`: selects, as `engine/device.py`'s steps do;
- `psum(size) > 0` and the overflow `psum`: one host read of (total size,
  any overflow, iters) per macro-iteration.

A macro-iteration is `balance_period` local steps on every worker, the
incumbent minimum and one balance round, gated as a whole by the loop
condition evaluated on the device at its start (a macro-iteration whose
condition fails is a no-op). When every worker is on one CUDA device,
`_DistDriver.run` captures one macro-iteration as one CUDA graph (cached
by the whole worker set's storage in `device._GRAPHS`) and replays it,
reading the status once a replay; otherwise it runs the same
macro-iterations eagerly. Either way the pools and counters after each
macro-iteration are the JAX loop's, worker by worker.

`stack_states`/`unstack_state` convert between the worker list and the
stacked `(D, ...)` layout of `DistResult.per_device`, `fetch_state` and
the checkpoint file.

`_DistDriver.run_async` (the overlapped segment driver's dispatch,
`checkpoint.run_segmented(overlap=True)`) replays a number of
macro-iterations the host fixes from the segment length and the balance
period alone, reads nothing back and checks no overflow: each
macro-iteration past the loop condition is a no-op on the device. It
returns the worker list with a `checkpoint.CounterBlock`, the counters
copied into pinned host memory behind a CUDA event, since the next
dispatch rewrites the counters and pools in place.

A multi-process job (`parallel/mesh.py`: one process per card, or
several sharing one, in a gloo process group) runs the same search: rank
r drives the global workers `r*D_local ...`, the warm-up runs on every
rank, and a macro-iteration's local steps run on each rank's workers
while the collectives of its host loop (`_Comm`) cross the ranks on CPU
tensors: `pmin(best)` is an `all_reduce(MIN)`, the size `all_gather` an
`all_gather`, the `all_to_all` of the transfer blocks an
`all_to_all_single` and the termination and overflow `psum` an
`all_reduce(SUM)`, read once a macro-iteration. The plan
(`balance.exchange_plan`) is computed on every rank from the gathered
sizes, so every rank's rows and counters are those of one process driving
all D workers. `worker_counters`, `fetch_state` and the checkpoints
gather every rank's workers; rank 0 alone writes. The ladder, the host
tier and overlap stay off there.

`search(..., host_fraction > 0)` runs the `-C` host tier beside the
workers (`engine/hybrid.py`): a host session seeded with a stride share of
the warm-up frontier (or, on a resume, with the checkpoint's saved share
or rows carved off the pools), merging incumbents with the workers at
every segment boundary.

`search` audits every result (`obs/audit.check_result`) and the reshard
of an elastic resume (`check_reshard`) when `obs/audit.enabled()`.

`_ladder_plan` builds the chunk ladder's rung drivers (`engine/ladder.py`)
under one usable-row limit; `search` resolves `chunk=None` /
`balance_period=None` through a `tune.Autotuner` (`tuner`) or from
`tune/defaults.params_for("serving", ...)`, runs the ladder on segmented
runs (`ladder`, or the TTS_LADDER flag) and joins an
`engine/incumbent.IncumbentBoard`.

Left out, raising `NotImplementedError` naming its ROADMAP item: the
executor cache (`loop_cache`, A9).
"""

from __future__ import annotations

import dataclasses
import warnings
from collections import deque
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import convert
from ..obs import audit as obs_audit
from ..obs import tracelog
from ..ops import columns as cols, fused as fz, kernels
from ..ops import reference as ref
from ..parallel import balance as bal, mesh
from ..parallel.mesh import worker_devices
from . import device, sequential as seq, telemetry as tele
from .device import COUNTER_DTYPES, SearchState

# per-worker byte budget for one balance round's transfer blocks (each
# way); caps the default transfer_cap at production shapes
BALANCE_BYTE_BUDGET = 64 << 20
_I64_MAX = 2**63 - 1


def default_transfer_cap(chunk: int, jobs: int, machines: int,
                         n_dev: int, aux_itemsize: int = 4) -> int:
    """Default balance transfer cap: 4*chunk, byte-budgeted. A round moves
    (2J + aux_itemsize*A + 2) bytes per column over D*transfer_cap columns
    each way per worker; the cap keeps that under BALANCE_BYTE_BUDGET."""
    bytes_per_col = 2 * jobs + aux_itemsize * machines + 2
    budget_cols = BALANCE_BYTE_BUDGET // (bytes_per_col * max(n_dev, 1))
    return max(min(4 * chunk, budget_cols), 256)


# ---------------------------------------------------------------------------
# Step 1: the host warm-up

_native_warned = False


def _warn_native_unavailable(e: Exception) -> None:
    """A broken native toolchain degrades loudly, once: the Python warm-up
    gives the same frontier, much more slowly."""
    global _native_warned
    if not _native_warned:
        _native_warned = True
        warnings.warn(
            f"native host runtime unavailable ({e!r}); falling back to "
            "the pure-Python warm-up (identical results, much slower). "
            "Check `g++` and tpu_tree_search_torch/native/__init__.py:build.",
            RuntimeWarning, stacklevel=3)


@dataclasses.dataclass
class Frontier:
    prmu: np.ndarray    # (n, jobs) int16
    depth: np.ndarray   # (n,) int16
    tree: int           # counters accumulated during warm-up
    sol: int
    best: int
    aux: np.ndarray | None = None  # (n, A) per-node aux rows, in the
                                   # pool's aux dtype


def bfs_warmup(p_times: np.ndarray, lb_kind: int, init_ub: int | None,
               target: int, use_native: bool = True) -> Frontier:
    """Pop-front BFS until the frontier holds >= target nodes (or the tree
    is exhausted), with the oracle's decompose semantics, so warm-up
    counters plus device counters add up to the sequential totals. The
    native runtime (`native.bfs_frontier`) first; the Python path below
    gives the same frontier."""
    if use_native:
        try:
            from .. import native
            prmu, depth, tree, sol, best = native.bfs_frontier(
                p_times, lb_kind, init_ub, target)
            return Frontier(prmu=prmu, depth=depth, tree=tree, sol=sol,
                            best=best)
        except Exception as e:  # noqa: BLE001 — any build or load failure
            _warn_native_unavailable(e)
    jobs = p_times.shape[1]
    lb1 = ref.make_lb1_data(p_times)
    lb2 = ref.make_lb2_data(lb1) if lb_kind == seq.LB2 else None
    best = seq.INT_MAX if init_ub is None else int(init_ub)
    tree = sol = 0

    frontier: deque[tuple[np.ndarray, int]] = deque(
        [(np.arange(jobs, dtype=np.int16), 0)])
    while frontier and len(frontier) < target:
        prmu, depth = frontier.popleft()
        limit1 = depth - 1
        if lb_kind == seq.LB1_D:
            lb_begin = ref.lb1_children_bounds(lb1, prmu, limit1, jobs)
        for i in range(depth, jobs):
            child = prmu.copy()
            child[depth], child[i] = child[i], child[depth]
            if lb_kind == seq.LB1:
                bound = ref.lb1_bound(lb1, child, limit1 + 1, jobs)
            elif lb_kind == seq.LB1_D:
                bound = int(lb_begin[int(prmu[i])])
            else:
                bound = ref.lb2_bound(lb1, lb2, child, limit1 + 1, jobs, best)
            if depth + 1 == jobs:
                sol += 1
                if bound < best:
                    best = bound
            elif bound < best:
                frontier.append((child, depth + 1))
                tree += 1

    if frontier:
        prmu = np.stack([f[0] for f in frontier]).astype(np.int16)
        depth = np.array([f[1] for f in frontier], dtype=np.int16)
    else:
        prmu = np.zeros((0, jobs), np.int16)
        depth = np.zeros((0,), np.int16)
    return Frontier(prmu=prmu, depth=depth, tree=tree, sol=sol, best=best)


# ---------------------------------------------------------------------------
# The worker list and the stacked layout


def stack_states(states: list[SearchState]) -> SearchState:
    """The workers' states as one stacked (D, ...) state on the first
    worker's device."""
    dev = states[0].prmu.device
    return SearchState(*(torch.stack([x.to(dev) for x in xs])
                         for xs in zip(*states)))


def unstack_state(stacked: SearchState, devices) -> list[SearchState]:
    """A stacked (D, ...) state as D worker states, worker d's on
    devices[d], each in storage of its own."""
    return [SearchState(*(x[d].to(dev, copy=True) for x in stacked))
            for d, dev in enumerate(devices)]


def worker_counters(states: list[SearchState]) -> dict:
    """Every worker's counters as (D,) numpy arrays of the JAX dtypes, read
    in one transfer (in a multi-process job, every rank's workers, on
    every rank)."""
    dev0 = states[0].prmu.device
    flat = torch.stack([getattr(s, f).to(dev0).long()
                        for f in COUNTER_DTYPES for s in states])
    vals = flat.cpu().numpy().reshape(len(COUNTER_DTYPES), len(states))
    (rows,) = mesh.gather_rows((vals.T,))       # (D, fields)
    return {f: v.astype(convert.np_dtype(dt))
            for v, (f, dt) in zip(rows.T, COUNTER_DTYPES.items())}


def fetch_state(states: list[SearchState]) -> SearchState:
    """Every worker's state on the host as one stacked SearchState of numpy
    arrays (the JAX `fetch_state`'s layout; in a multi-process job every
    rank's workers, on every rank)."""
    return SearchState(**mesh.gather_stacked(convert.state_to_numpy(states)))


# ---------------------------------------------------------------------------
# Step 2: the macro-iteration


def _loop_cond(states: list[SearchState], max_iters) -> torch.Tensor:
    """The JAX loop's `while_loop` condition as a device bool on the first
    worker's device: work left somewhere, no worker overflowed, and the
    (common) iteration count below `max_iters`."""
    dev0 = states[0].prmu.device
    size = torch.stack([s.size.to(dev0) for s in states]).sum()
    ovf = torch.stack([s.overflow.to(dev0) for s in states]).any()
    return (size > 0) & ~ovf & (states[0].iters < max_iters)


def _status(states: list[SearchState]) -> torch.Tensor:
    """(total size, any overflow, iters) as one int64 device vector."""
    dev0 = states[0].prmu.device
    size = torch.stack([s.size.to(dev0).long() for s in states]).sum()
    ovf = torch.stack([s.overflow.to(dev0) for s in states]).any()
    return torch.stack([size, ovf.long(), states[0].iters])


class _Comm:
    """The cross-process collectives of a macro-iteration, for a rank that
    drives `n_local` of the job's workers (global workers `first ...
    first + n_local - 1`). Each runs on the gloo group over CPU tensors,
    staged through the host; a rank's tensors leave its card in one copy
    per collective."""

    def __init__(self, n_local: int):
        self.rank, self.world = mesh.process_index(), mesh.process_count()
        counts = self.all_gather(torch.tensor([n_local]))
        if bool((counts != n_local).any()):
            raise ValueError(f"every rank must drive the same number of "
                             f"workers, got {counts.tolist()}")
        self.n_local = n_local
        self.first = self.rank * n_local
        self.n_global = self.world * n_local

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        """`pmin`: the minimum over the ranks (`all_reduce(MIN)`)."""
        out = x.cpu().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MIN)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of `x`, concatenated in rank order."""
        x = x.cpu()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """`psum`: the sum over the ranks (`all_reduce(SUM)`)."""
        out = x.cpu().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    def status(self, states: list[SearchState]) -> list:
        """(total size, any overflow, iters) of the whole job, in one read
        of this rank's workers and one `all_reduce(SUM)`."""
        local = _status(states).cpu()
        total = self.psum(local[:2])
        return [int(total[0]), int(total[1] > 0), int(local[2])]

    def exchange(self, blocks: list, tc: int, devices) -> list:
        """The `all_to_all` of a balance round: `blocks[d]` is local donor
        d's (prmu, aux, depth) transfer blocks, block e (columns
        `e*tc ... e*tc + tc - 1`) for global receiver e. Returns, for each
        local receiver, the blocks of every global donor in donor order,
        concatenated (the single-process round's layout), on its device.
        One `all_to_all_single` of the blocks packed into int32 rows (gloo
        has no int16)."""
        J, A = blocks[0][0].shape[0], blocks[0][1].shape[0]
        dtypes = (blocks[0][0].dtype, blocks[0][1].dtype, blocks[0][2].dtype)
        R, W, L = J + A + 1, self.world, self.n_local
        send = torch.stack([
            torch.cat([p.int(), a.int(), dp.int()[None]]).cpu()
            .reshape(R, W, L, tc).permute(1, 2, 0, 3)
            for p, a, dp in blocks], 1)        # (to rank, donor, to, R, tc)
        recv = torch.empty_like(send)          # (from rank, donor, to, ...)
        dist.all_to_all_single(recv.reshape(-1), send.reshape(-1))
        out = []
        for e, dev in enumerate(devices):
            got = (recv[:, :, e].reshape(W * L, R, tc).permute(1, 0, 2)
                   .reshape(R, W * L * tc).to(dev))
            out.append((got[:J].to(dtypes[0]), got[J:J + A].to(dtypes[1]),
                        got[J + A].to(dtypes[2])))
        return out


def _pmin(states: list[SearchState], active,
          comm: _Comm | None = None) -> list[SearchState]:
    """`pmin(best)`: the workers' minimum incumbent, written to each (over
    every rank's workers with a `comm`)."""
    dev0 = states[0].prmu.device
    best = torch.stack([s.best.to(dev0) for s in states]).min()
    if comm is not None:
        best = comm.pmin(best)
    return [s._replace(best=torch.where(active.to(s.prmu.device),
                                        best.to(s.prmu.device), s.best))
            for s in states]


def _balance_round(states: list[SearchState], transfer_cap: int,
                   min_transfer: int, limit: int,
                   active: torch.Tensor,
                   comm: _Comm | None = None) -> list[SearchState]:
    """One steal-half exchange across the workers (JAX `_balance_round`),
    a no-op unless `active`.

    The sizes are stacked and the plan computed on the first worker's
    device. Each donor gathers its outgoing rows off its stack top into D
    blocks of `transfer_cap` columns (columns past the pair's flow marked
    as holes by depth -1); receiver e takes block e of every donor, copies
    it to its device, compacts the received rows to the front
    (`columns.partition`) and writes the D*transfer_cap-column block at
    its new base. The round is globally transactional: if any receiver
    would pass `limit`, no worker exchanges or commits and every worker's
    overflow flag is set (the driver grows every pool and resumes). A
    round that does not flow writes its block at `limit`, in the headroom
    the driver reserves above it, which no live row reaches.

    With a `comm`, `states` are this rank's workers of a multi-process job:
    the sizes are gathered from every rank (`all_gather`) and the plan is
    computed on the host, the same on every rank, and the blocks cross the
    ranks in one `all_to_all_single`."""
    dev0 = states[0].prmu.device
    capacity = states[0].prmu.shape[-1]
    tc = transfer_cap
    sizes = torch.stack([s.size.to(dev0) for s in states])
    first = 0
    if comm is not None:
        sizes, first = comm.all_gather(sizes), comm.first
        dev0 = sizes.device
    D = sizes.shape[0]
    plan = bal.exchange_plan(sizes, tc, min_transfer)
    total_out = plan.sum(1, dtype=torch.int32)
    total_in = plan.sum(0, dtype=torch.int32)
    base = sizes - total_out
    ovf = ((base + total_in) > limit).any() & active
    do_flow = (plan.sum() > 0) & ~ovf & active

    offs = torch.cumsum(plan, 1, dtype=torch.int32) - plan
    k = torch.arange(tc, dtype=torch.int32, device=dev0)
    rows = (base[:, None, None] + offs[:, :, None] + k).clamp(0, capacity - 1)
    send = k < plan[:, :, None]                              # (D, D, tc)
    blocks = []
    for d, s in enumerate(states):
        dev = s.prmu.device
        r = rows[first + d].reshape(-1).long().to(dev)
        hole = ~send[first + d].reshape(-1).to(dev)
        blocks.append((s.prmu.index_select(1, r), s.aux.index_select(1, r),
                       s.depth.index_select(0, r).masked_fill(hole, -1)))
    if comm is not None:
        received = comm.exchange(blocks, tc, [s.prmu.device for s in states])

    out = []
    n_cols = D * tc
    for e, s in enumerate(states):
        dev = s.prmu.device
        if comm is not None:
            r_prmu, r_aux, r_depth = received[e]
        else:
            blk = slice(e * tc, (e + 1) * tc)
            r_prmu = torch.cat([b[0][:, blk].to(dev) for b in blocks], 1)
            r_aux = torch.cat([b[1][:, blk].to(dev) for b in blocks], 1)
            r_depth = torch.cat([b[2][blk].to(dev) for b in blocks])
        push = r_depth >= 0
        order = cols.partition(push)
        n_push = push.sum(dtype=torch.int32)
        flow = do_flow.to(dev)
        my_base = base[first + e].to(dev)
        at = torch.where(flow, my_base, limit).long()
        cols_at = at + torch.arange(n_cols, device=dev)
        s.prmu.index_copy_(1, cols_at, r_prmu[:, order])
        s.depth.index_copy_(0, cols_at, r_depth[order])
        s.aux.index_copy_(1, cols_at, r_aux[:, order])

        sent = total_out[first + e].to(dev).long()
        got = n_push.long()

        def keep(new, old, flow=flow):
            return torch.where(flow, new, old)

        telem = s.telemetry
        if telem.shape[-1] > 0:
            # the steal-flow slots mirror sent/recv, under the same guard
            slot = torch.arange(telem.shape[-1], device=dev)
            flow_in = (torch.where(slot == tele.O_STEAL_SENT, sent, 0)
                       + torch.where(slot == tele.O_STEAL_RECV, got, 0))
            telem = keep(telem + flow_in, telem)
        out.append(s._replace(
            telemetry=telem,
            size=keep(my_base + n_push, s.size),
            sent=keep(s.sent + sent, s.sent),
            recv=keep(s.recv + got, s.recv),
            steals=keep(s.steals + (n_push > 0).long(), s.steals),
            overflow=s.overflow | ovf.to(dev)))
    return out


def member_body(step_fns, balance_period: int, transfer_cap: int,
                min_transfer: int, limit: int, comm: _Comm | None = None):
    """One macro-iteration (JAX `member_body`): `balance_period` local
    steps on every worker, the incumbent minimum and one balance round,
    all a no-op unless the device bool `active`. `step_fns[d]` is worker
    d's step (`Problem.make_step` at the tightened `limit`). Steps are
    issued step-major, so workers on different devices run together. With
    a `comm` the minimum and the round cross the ranks."""

    def body(states: list[SearchState], active) -> list[SearchState]:
        acts = [active.to(s.prmu.device) for s in states]
        states = list(states)
        for _ in range(balance_period):
            for d, fn in enumerate(step_fns):
                states[d] = fn(states[d], active=acts[d])
        states = _pmin(states, active, comm)
        return _balance_round(states, transfer_cap, min_transfer, limit,
                              active, comm)

    return body


# ---------------------------------------------------------------------------
# Host entry point


class DistResult:
    def __init__(self, explored_tree, explored_sol, best, per_device,
                 warmup_tree, warmup_sol, complete=True, telemetry=None,
                 problem: str = "pfsp"):
        self.explored_tree = explored_tree
        self.explored_sol = explored_sol
        self.best = best
        self.per_device = per_device        # dict of (D,) arrays
        self.warmup_tree = warmup_tree
        self.warmup_sol = warmup_sol
        self.complete = complete            # all pools drained
        self.telemetry = telemetry          # telemetry.summarize dict, or
                                            # None when the vector is off
        self.problem = problem              # registry name


def _shard_frontier(fr: Frontier, n_dev: int, jobs: int, init_best: int,
                    limit: int) -> dict:
    """Round-robin stripes of the frontier, worker d taking rows `d::D`
    (the reference's roundRobin_distribution): a stacked dict of numpy
    arrays keyed by state field, each pool as wide as the widest stripe
    (the driver re-homes it into the pool capacity). Every stripe must
    fit under `limit`."""
    aux_w = 0 if fr.aux is None else fr.aux.shape[1]
    width = -(-len(fr.depth) // n_dev)
    assert width <= limit, (width, limit)
    prmu = np.zeros((n_dev, jobs, width), np.int16)
    depth = np.zeros((n_dev, width), np.int16)
    aux = np.zeros((n_dev, aux_w, width),
                   fr.aux.dtype if aux_w else np.int32)
    sizes = np.zeros(n_dev, np.int32)
    for d in range(n_dev):
        n = len(fr.depth[d::n_dev])
        prmu[d, :, :n] = fr.prmu[d::n_dev].T
        depth[d, :n] = fr.depth[d::n_dev]
        if aux_w:
            aux[d, :, :n] = fr.aux[d::n_dev].T
        sizes[d] = n
    zeros = np.zeros(n_dev, np.int64)
    return dict(prmu=prmu, depth=depth, aux=aux, size=sizes,
                best=np.full(n_dev, init_best, np.int32),
                tree=zeros, sol=zeros, iters=zeros, evals=zeros,
                sent=zeros, recv=zeros, steals=zeros,
                overflow=np.zeros(n_dev, bool),
                telemetry=np.zeros((n_dev, tele.enabled_width()), np.int64))


class _DistGraph(NamedTuple):
    """One captured macro-iteration: the graph, each worker's counters and
    telemetry vector it reads and writes, its iteration ceiling, the
    status it leaves and the kernel launches of one replay."""

    graph: torch.cuda.CUDAGraph
    counters: list
    telemetry: list
    max_iters: torch.Tensor
    status: torch.Tensor
    launches: dict


class _DistDriver:
    """Runs the macro-iteration loop over a fixed worker list, with
    lossless overflow recovery: on overflow every pool is re-homed into
    double the capacity (checkpoint.grow) and the search resumes exactly
    where it stopped.

    `limit_fn(capacity)` is the problem's usable-row bound; `limit` tightens
    it so the balance round's D*transfer_cap receive block also fits above
    it, and both the local steps and the round's commit use the tightened
    limit. `host_reads` counts the status reads of `run` (one per
    macro-iteration), `macro_iters` the macro-iterations it and `run_async`
    issued and `captures` the CUDA graphs it captured, by pool capacity.

    In a multi-process job the driver's `devices` are this rank's workers
    of `n_global` in all (`comm`, a `_Comm`): the receive block, the
    warm-up stripes and a committed stacked state are the whole job's, and
    `run` drives each macro-iteration from the host (local steps, then the
    collectives), reading the job's status once a macro-iteration."""

    def __init__(self, devices, make_tables, make_local_step,
                 balance_period: int, transfer_cap: int, min_transfer: int,
                 limit_fn, name: str = "pfsp", key: tuple = ()):
        self.devices = list(devices)
        self.n_dev = len(self.devices)
        self.tables = {}
        for dev in self.devices:
            if dev not in self.tables:
                self.tables[dev] = make_tables(dev)
        self.make_local_step = make_local_step
        self.balance_period = balance_period
        self.transfer_cap = transfer_cap
        self.min_transfer = min_transfer
        self.limit_fn = limit_fn
        self.name = name
        self.key = tuple(key)
        self.comm = _Comm(self.n_dev) if mesh.process_count() > 1 else None
        self.n_global = self.comm.n_global if self.comm else self.n_dev
        self.first = self.comm.first if self.comm else 0
        self.n_recv = self.n_global * transfer_cap
        self._bodies: dict[int, object] = {}
        self.host_reads = 0
        self.macro_iters = 0
        self.captures: dict[int, int] = {}
        self._ring = None          # run_async's pinned counter buffers

    def limit(self, capacity: int) -> int:
        return min(self.limit_fn(capacity), capacity - self.n_recv)

    def body(self, capacity: int):
        """The macro-iteration for pools of `capacity` rows."""
        if capacity not in self._bodies:
            lim = self.limit(capacity)
            steps = [self.make_local_step(self.tables[dev], lim)
                     for dev in self.devices]
            self._bodies[capacity] = member_body(
                steps, self.balance_period, self.transfer_cap,
                self.min_transfer, lim, self.comm)
        return self._bodies[capacity]

    def commit(self, state: SearchState) -> list[SearchState]:
        """A stacked (D, ...) state (any device) as the worker list (this
        rank's workers of it in a multi-process job)."""
        mine = slice(self.first, self.first + self.n_dev)
        return unstack_state(SearchState(*(x[mine] for x in state)),
                             self.devices)

    def seed(self, frontier: Frontier, capacity: int, jobs: int,
             init_best: int) -> list[SearchState]:
        """Stripe a warm-up frontier across the workers, pre-growing the
        pool until a stripe fits under the usable-row limit."""
        stripe = -(-max(len(frontier.depth), 1) // self.n_global)
        while self.limit(capacity) < max(stripe, 1):
            capacity *= 2
        arrays = _shard_frontier(frontier, self.n_global, jobs, init_best,
                                 self.limit(capacity))
        return [convert.state_from_numpy(
            {f: a[self.first + d] for f, a in arrays.items()}, dev,
            capacity=capacity) for d, dev in enumerate(self.devices)]

    def _graph_ok(self, states) -> bool:
        devs = {s.prmu.device for s in states}
        return (self.comm is None and len(devs) == 1
                and next(iter(devs)).type == "cuda")

    def _graph_key(self, states, capacity: int) -> tuple:
        tensors = []
        for dev in self.devices:
            t = self.tables[dev]
            tensors += ([t] if isinstance(t, torch.Tensor)
                        else [x for x in t if isinstance(x, torch.Tensor)])
        for s in states:
            tensors += [s.prmu, s.depth, s.aux]
        storage = tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                        for t in tensors)
        return ("dist", self.name, self.key, self.balance_period,
                self.transfer_cap, self.min_transfer, capacity,
                self.limit(capacity), states[0].telemetry.shape[-1],
                storage)

    def _capture(self, states, capacity: int) -> _DistGraph:
        """Capture one macro-iteration on `states`' pools (updated in
        place, at the addresses the graph holds). One no-op macro-iteration
        runs first on a side stream, so that every kernel's first launch
        and the allocator's first blocks happen outside the capture."""
        body = self.body(capacity)
        self.captures[capacity] = self.captures.get(capacity, 0) + 1
        dev = states[0].prmu.device
        static = [s._replace(
            **{f: getattr(s, f).clone() for f in COUNTER_DTYPES},
            telemetry=s.telemetry.clone()) for s in states]
        max_iters = torch.zeros((), dtype=torch.int64, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body(static, torch.zeros((), dtype=torch.bool, device=dev))
        torch.cuda.current_stream(dev).wait_stream(side)
        kernels.take_captured()
        status = torch.zeros(3, dtype=torch.int64, device=dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = body(static, _loop_cond(static, max_iters))
            for s, o in zip(static, out):
                for f in COUNTER_DTYPES:
                    getattr(s, f).copy_(getattr(o, f))
                s.telemetry.copy_(o.telemetry)
            status.copy_(_status(out))
        return _DistGraph(
            graph, [{f: getattr(s, f) for f in COUNTER_DTYPES}
                    for s in static],
            [s.telemetry for s in static], max_iters, status,
            kernels.take_captured())

    def _graph(self, states, capacity: int, ceiling: int) -> _DistGraph:
        """The cached (or newly captured) macro-iteration graph of
        `states`' pools, loaded with their counters and `ceiling`."""
        key = self._graph_key(states, capacity)
        g = device._GRAPHS.pop(key, None)
        if g is None:
            g = self._capture(states, capacity)
        device._GRAPHS[key] = g
        while len(device._GRAPHS) > device._GRAPH_CACHE:
            device._GRAPHS.popitem(last=False)
        for s, ctr, tv in zip(states, g.counters, g.telemetry):
            for f, t in ctr.items():
                t.copy_(getattr(s, f))
            tv.copy_(s.telemetry)
        g.max_iters.fill_(ceiling)
        return g

    @staticmethod
    def _graph_out(states, g: _DistGraph) -> list[SearchState]:
        """The states after `g`'s replays: their pools, with copies of the
        graph's counters and telemetry (a later replay rewrites those)."""
        return [s._replace(**{f: t.clone() for f, t in ctr.items()},
                           telemetry=tv.clone())
                for s, ctr, tv in zip(states, g.counters, g.telemetry)]

    def _run_graph(self, states, ceiling: int, capacity: int, going):
        g = self._graph(states, capacity, ceiling)
        while True:
            kernels.replay(g.graph, g.launches)
            self.macro_iters += 1
            status = g.status.tolist()
            self.host_reads += 1
            if not going(status):
                break
        return self._graph_out(states, g), status

    def _drive(self, states, ceiling: int, capacity: int):
        """Macro-iterations until the loop condition fails, reading (total
        size, any overflow, iters) once after each; returns (states,
        last status)."""

        def going(status) -> bool:
            size, overflow, iters = status
            return size > 0 and not overflow and iters < ceiling

        if self._graph_ok(states):
            return self._run_graph(states, ceiling, capacity, going)
        body = self.body(capacity)
        if self.comm is not None:
            # the host gates each macro-iteration on the job's status
            status = self.comm.status(states)
            self.host_reads += 1
            active = torch.ones((), dtype=torch.bool)
            while going(status):
                states = body(states, active)
                self.macro_iters += 1
                status = self.comm.status(states)
                self.host_reads += 1
            return states, status
        lim = torch.full((), ceiling, dtype=torch.int64,
                         device=states[0].prmu.device)
        while True:
            states = body(states, _loop_cond(states, lim))
            self.macro_iters += 1
            status = _status(states).tolist()
            self.host_reads += 1
            if not going(status):
                return states, status

    def run(self, states: list[SearchState],
            max_iters=None) -> list[SearchState]:
        """Run until exhaustion or the cumulative per-worker iteration
        ceiling, growing every pool x2 and resuming on overflow. The pools
        are updated in place (until a growth re-homes them)."""
        from . import checkpoint

        ceiling = _I64_MAX if max_iters is None else int(max_iters)
        while True:
            capacity = states[0].prmu.shape[-1]
            states, status = self._drive(states, ceiling, capacity)
            if not status[1]:
                return states
            states = [checkpoint.grow(s, capacity * 2) for s in states]

    def run_async(self, states: list[SearchState], max_iters: int,
                  macro_iters: int):
        """Issue `macro_iters` macro-iterations toward the cumulative
        per-worker ceiling `max_iters` (JAX `run_async`: the overlapped
        driver's dispatch), reading nothing back and checking no overflow:
        each macro-iteration past the loop condition (the pool drained or
        overflowed, or `max_iters` reached) is a no-op on the device. On a
        card they are replays of the captured macro-iteration, left queued
        on the stream; the pools are updated in place, and the returned
        `checkpoint.DispatchedStates` carries the counters' copy into
        pinned host memory (two buffers in turn, as the block of the next
        dispatch can be in flight beside this one). On CPU workers the
        same macro-iterations run eagerly, each past the condition
        skipped."""
        from . import checkpoint

        if self.comm is not None:
            raise RuntimeError("run_async is single-process: a "
                               "multi-process job runs synchronously")
        capacity = states[0].prmu.shape[-1]
        if self._graph_ok(states):
            g = self._graph(states, capacity, int(max_iters))
            for _ in range(macro_iters):
                kernels.replay(g.graph, g.launches)
                self.macro_iters += 1
            out = self._graph_out(states, g)
            if self._ring is None:
                self._ring = checkpoint.PinnedRing()
        else:
            body = self.body(capacity)
            lim = torch.full((), int(max_iters), dtype=torch.int64,
                             device=states[0].prmu.device)
            out, cpu = list(states), states[0].prmu.device.type == "cpu"
            for _ in range(macro_iters):
                cond = _loop_cond(out, lim)
                self.macro_iters += 1
                if cpu and not bool(cond):
                    continue          # a no-op: skipped on the host
                out = body(out, cond)
        return checkpoint.DispatchedStates(
            out, checkpoint.CounterBlock(out, self._ring))


def _resolve_problem(problem):
    """Registry name or plugin object -> plugin object."""
    if isinstance(problem, str):
        from .. import problems as problems_pkg
        return problems_pkg.get(problem)
    return problem


def _problem_driver(problem, devices, table, lb_kind: int, chunk: int,
                    balance_period: int, transfer_cap: int,
                    min_transfer: int, fused: str = "off",
                    limit_fn=None) -> _DistDriver:
    """The driver of any registered problem: the plugin's tables on each
    worker device, its step (`make_step`, fused mode `fused` where the
    plugin uses one) and its usable-row bound (`limit_fn`, None: this
    chunk's own; the ladder passes the limit shared by its rungs)."""
    table = np.asarray(table)
    jobs = problem.slots(table)
    if not problem.supports_fused:
        fused = "off"

    def make_local_step(t, limit):
        return problem.make_step(t, lb_kind, chunk, 1024, limit, fused=fused)

    return _DistDriver(
        devices, lambda dev: problem.make_tables(table, device=dev),
        make_local_step, balance_period, transfer_cap, min_transfer,
        limit_fn=limit_fn or (lambda cap: problem.usable_rows(cap, chunk,
                                                              jobs)),
        name=problem.name,
        key=(jobs, int(table.shape[0]), lb_kind, chunk, fused))


def _ladder_plan(problem, devices, table, lb_kind: int, chunk: int,
                 balance_period: int, transfer_cap: int | None,
                 min_transfer: int | None, adt, rung_profile=None,
                 fused_mode: str = "off") -> tuple[tuple, dict]:
    """One `_DistDriver` per chunk-ladder rung (JAX `_ladder_plan`), all
    under one usable-row limit: the minimum over the rungs of each rung's
    scratch margin and balance headroom. A state committed by any rung is
    then in bounds for every other, so a switch in either direction at a
    segment boundary never writes a block over live rows.

    `transfer_cap` / `min_transfer` are the caller's explicit values, for
    every rung; None derives each rung's own (`default_transfer_cap`,
    2*chunk). `rung_profile` (`Params.rung_modes`) admits rungs by their
    measured time (`ladder.rungs_from_profile`) in place of the static
    per-bound floor, and picks each rung's fused mode (`ladder.fused_for`)
    under `fused_mode`."""
    from .ladder import (fused_for, min_rung_for, rungs_for,
                         rungs_from_profile)

    jobs, aux_rows = problem.slots(table), problem.aux_rows(table)
    n_dev = len(devices)
    rungs = rungs_from_profile(chunk, rung_profile, fused_mode=fused_mode)
    if rungs is None:
        rungs = rungs_for(chunk, min_chunk=min_rung_for(lb_kind))
    cfgs = []
    for c in rungs:
        tc = (transfer_cap if transfer_cap is not None
              else default_transfer_cap(c, jobs, aux_rows, n_dev,
                                        aux_itemsize=adt.itemsize))
        mt = min_transfer if min_transfer is not None else 2 * c
        cfgs.append((c, tc, mt))

    def unified_limit(cap: int) -> int:
        return min(min(problem.usable_rows(cap, c, jobs), cap - n_dev * tc)
                   for c, tc, _ in cfgs)

    drivers = {
        c: _problem_driver(problem, devices, table, lb_kind, c,
                           balance_period, tc, mt,
                           fused=fused_for(c, rung_profile, fused_mode),
                           limit_fn=unified_limit)
        for c, tc, mt in cfgs}
    return tuple(sorted(drivers)), drivers


def _fold_cap(states: list[SearchState], cap) -> list[SearchState]:
    """The board's pruning ceiling folded into every worker's `best` on its
    device (JAX's `min(best, bound_cap)` at loop entry); None folds
    nothing."""
    if cap is None:
        return states
    return [s._replace(best=s.best.clamp_max(int(cap))) for s in states]


def _not_ported(what: str, item: str, where: str = "distributed.search"):
    return NotImplementedError(
        f"{where}: {what} is not ported yet (ROADMAP {item})")


def search(p_times: np.ndarray, lb_kind: int = 1, init_ub: int | None = None,
           n_devices: int | None = None, chunk: int | None = 64,
           capacity: int = 1 << 17, balance_period: int | None = 4,
           transfer_cap: int | None = None, min_transfer: int | None = None,
           min_seed: int = 32, max_rounds: int | None = None,
           devices: list | None = None,
           segment_iters: int | None = None,
           checkpoint_path: str | None = None,
           checkpoint_every: int = 1,
           heartbeat=None, host_fraction: int = 0, host_threads: int = 0,
           stop_event=None, should_stop=None,
           loop_cache=None, checkpoint_meta_extra=None,
           overlap: bool | None = None,
           incumbent_board=None, incumbent_key=None,
           ladder: bool | None = None, tuner=None,
           problem="pfsp", telemetry: bool | None = None,
           retry_attempts: int | None = None,
           segment_timeout_s: float | None = None) -> DistResult:
    """Multi-worker branch-and-bound (the JAX `search`).

    The workers are `parallel.mesh.worker_devices(n_devices, devices)`: the
    visible cards by default, or any list of devices (repeats allowed:
    several workers on one card, or on the CPU). A host warm-up
    (`Problem.warmup`) makes a frontier of >= `min_seed` nodes per worker,
    striped round-robin across the pools; the workers then run
    macro-iterations of `balance_period` steps each, an incumbent minimum
    and a steal-half balance round (`transfer_cap` columns per pair at
    most, `min_transfer` the smallest surplus that donates), until every
    pool is empty or each worker has taken `max_rounds * balance_period`
    steps. An overflow grows every pool x2 and resumes.

    `chunk=None` / `balance_period=None` take the value of
    `tuner.resolve(..., allow_probe=False)` (a `tune.Autotuner`: its cache
    entry for this shape and worker count, with the probed `rung_modes`
    feeding the ladder, else the defaults) or, without a tuner,
    `tune/defaults.params_for("serving", ...)` for this problem and shape;
    a `tuner.resolve` event names the source ("cache" or "default").

    With `segment_iters`, `checkpoint_path`, `stop_event` or
    `should_stop` the loop runs in segments (`checkpoint.run_segmented`):
    `heartbeat(SegmentReport)` after each (with per-worker sizes and
    steals), a stacked checkpoint in the JAX file format (meta
    `warmup_tree`, `warmup_sol` and `problem`; `checkpoint_meta_extra`, a
    dict or a callable returning one, merged in), and a stop at the next
    segment boundary. An existing checkpoint is resumed, on any worker
    count (elastic: `checkpoint.reshard_state`); one written by another
    problem is refused.

    `ladder` (None: the TTS_LADDER flag) runs a segmented search on the
    chunk ladder (`engine/ladder.py`): a driver per rung under one
    usable-row limit (`_ladder_plan`), the rung picked at each segment
    boundary from the pool occupancy, the top rung (`chunk`) seeding,
    committing and resuming. The live rung rides the checkpoint meta
    (`ladder_rung`) and a resume starts on it. It does not engage without
    segments, beside a host tier, or when `chunk` gives fewer than two
    rungs; a ladder checkpoint resumes on the plain driver and back.

    `incumbent_board` (`engine/incumbent.IncumbentBoard`) joins the
    cross-request exchange under `incumbent_key` (None:
    `incumbent.share_key` of the table): the starting best, the best at
    each segment boundary and the final best are published, and before
    each dispatch the board's tighter value is folded into every worker's
    `best` on the device. A lone search is bit-identical to one with no
    board.

    `problem` is a registry name or a plugin; `p_times` its instance table.
    The PFSP step takes the fused route on CUDA workers and the unfused one
    on the CPU (`ops/fused.resolve_mode`). `telemetry` (None: the
    TTS_SEARCH_TELEMETRY flag) gives each pool the telemetry vector;
    `retry_attempts` and `segment_timeout_s` go to `run_segmented` (None:
    its environment defaults).

    `host_fraction > 0` runs the `-C` host tier (`engine/hybrid.py`) with
    `host_threads` threads (0: the native default): every
    host_fraction-th warm-up node seeds a host session, and the search
    runs in segments that merge the incumbents of the workers and the
    session. Its seed rides the checkpoint meta (`host_prmu`,
    `host_depth`): a resume with `-C` re-seeds the session from it (or,
    lacking it, from rows carved off the pools), one without `-C` pushes
    it back into a pool. A plugin without a host tier raises
    `HostTierUnsupported`.

    `overlap` (None: the TTS_OVERLAP flag) runs a segmented search on the
    overlapped driver (`checkpoint.run_segmented(overlap=True)`): each
    segment is one `_DistDriver.run_async` of `ceil(segment_iters /
    balance_period)` macro-iterations with the board's ceiling folded in
    at dispatch, the next one dispatched before this one's counters are
    read, checkpoints written on a thread, and an overflow grown x2 in the
    middle of the pipeline. The counts and every segment report but its
    wall-clock fields are the synchronous driver's. A ladder rung chosen at
    a boundary then lands one segment later. It does not engage beside a
    host tier or in a multi-process job.

    In a multi-process job (`parallel/mesh.py`, every rank calling
    `search` alike) `devices` are this rank's workers (by default
    `mesh.local_worker_devices(n_devices)`, `n_devices` then counting the
    whole job's workers, one a rank if None): every rank runs the warm-up,
    seeds its stripes of the job's D workers and drives them through the
    cross-process collectives (`_Comm`), gathers every worker's counters
    into the result, and reads and (rank 0) writes the stacked checkpoint.
    The ladder and overlap stay off, and `host_fraction > 0` raises
    ValueError (each rank would search the same host share)."""
    from ..utils import config as _cfg
    from . import checkpoint, hybrid, incumbent as inc_mod

    prob = _resolve_problem(problem)
    if host_fraction > 0 and not prob.supports_host_tier:
        from ..problems.base import HostTierUnsupported
        raise HostTierUnsupported(prob.name)
    if loop_cache is not None:
        raise _not_ported("the executor cache (loop_cache)", "A9")
    n_procs = mesh.process_count()
    if n_procs > 1 and host_fraction > 0:
        raise ValueError("the -C host tier does not run in a multi-process "
                         "job: every rank would search the same share")

    table = np.asarray(p_times)
    if n_procs > 1 and devices is None:
        devs = mesh.local_worker_devices(n_devices or n_procs)
    else:
        devs = worker_devices(n_devices, devices)
    n_dev = len(devs) * n_procs             # the job's workers
    jobs = prob.slots(table)
    mode = fz.resolve_mode(None, on_cuda=devs[0].type == "cuda")
    rung_profile = None
    if chunk is None or balance_period is None:
        # the knobs left open: the tuner's cache entry (its hot path never
        # probes), else the serving defaults
        from ..tune import defaults as tune_defaults
        if tuner is not None:
            params = tuner.resolve(jobs, table.shape[0], lb_kind,
                                   n_workers=n_dev, allow_probe=False,
                                   problem=prob.name, device=devs[0])
        else:
            params = tune_defaults.params_for("serving", jobs,
                                              table.shape[0],
                                              problem=prob.name)
        if chunk is None:
            chunk = params.chunk
            if transfer_cap is None and params.transfer_cap:
                transfer_cap = params.transfer_cap
        if balance_period is None:
            balance_period = params.balance_period
        rung_profile = params.rung_modes
        tracelog.event("tuner.resolve", chunk=chunk,
                       balance_period=balance_period, source=params.source,
                       evals_per_s=params.evals_per_s, fused=mode,
                       rung_profile=bool(rung_profile))
    adt = prob.aux_dtype(table)
    resumed = None
    if checkpoint_path and checkpoint.resume_path(checkpoint_path):
        # loaded before the balance buffers are sized: a resume keeps the
        # saved pools' aux dtype
        state, meta, _ = checkpoint.load_resilient(
            checkpoint_path, p_times=table if prob.name == "pfsp" else None,
            device="cpu")
        saved_prob = meta.get("problem")
        saved_prob = ("pfsp" if saved_prob is None
                      else str(np.asarray(saved_prob)))
        if saved_prob != prob.name:
            raise ValueError(
                f"checkpoint {checkpoint_path} was written by problem "
                f"{saved_prob!r}; refusing to resume it as "
                f"{prob.name!r} (pick a fresh tag/checkpoint path)")
        adt = state.aux.dtype
        resumed = (state, meta)
    if ladder is None:
        ladder = _cfg.env_flag(_cfg.LADDER_FLAG)
    # the ladder switches at segment boundaries, so it engages only on a
    # segmented run; a host tier keeps the single driver, and a
    # multi-process job the one synchronous loop
    ladder_drivers = None
    if (ladder and host_fraction == 0 and n_procs == 1
            and (segment_iters is not None or checkpoint_path is not None
                 or stop_event is not None or should_stop is not None)):
        # the rungs get the caller's explicit transfer knobs (None derives
        # each rung's own)
        rungs, ladder_drivers = _ladder_plan(
            prob, devs, table, lb_kind, chunk, balance_period, transfer_cap,
            min_transfer, adt, rung_profile=rung_profile, fused_mode=mode)
        if len(rungs) < 2:
            ladder_drivers = None
    if transfer_cap is None:
        transfer_cap = default_transfer_cap(
            chunk, jobs, prob.aux_rows(table), n_dev,
            aux_itemsize=adt.itemsize)
    min_transfer = min_transfer or 2 * chunk
    if ladder_drivers is not None:
        # the top rung seeds, commits and resumes (every rung shares its
        # limit)
        driver = ladder_drivers[chunk]
    else:
        from .ladder import fused_for
        driver = _problem_driver(prob, devs, table, lb_kind, chunk,
                                 balance_period, transfer_cap, min_transfer,
                                 fused=fused_for(chunk, rung_profile, mode))

    session = None
    meta_rung = None            # the checkpoint's recorded rung
    if resumed is not None:
        host_state, meta = resumed
        if "ladder_rung" in meta:
            meta_rung = int(np.asarray(meta["ladder_rung"]))
        shape = tuple(host_state.prmu.shape)
        if len(shape) != 3 or shape[0] != n_dev:
            old = shape[0] if len(shape) == 3 else 1
            warnings.warn(
                f"resharding checkpoint {checkpoint_path} from {old} to "
                f"{n_dev} workers (elastic resume)", RuntimeWarning,
                stacklevel=2)
            # the elastic reshard must keep every summed counter, the
            # pooled node count and the incumbent
            pre_sums = (obs_audit.state_sums(host_state)
                        if obs_audit.enabled() else None)
            host_state = checkpoint.reshard_state(host_state, n_dev,
                                                  device="cpu")
            if pre_sums is not None:
                obs_audit.check_reshard(pre_sums, host_state,
                                        edge="elastic_resume")
        # re-home into a capacity whose usable-row limit covers the
        # fullest pool
        cap0 = cap = host_state.prmu.shape[-1]
        need = int(host_state.size.max())
        while driver.limit(cap) < max(need, 1):
            cap *= 2
        if cap != cap0:
            host_state = checkpoint.grow(host_state, cap)
        host_state, session, h_prmu, h_depth = hybrid.resume_share(
            host_state, meta, prob, table, lb_kind, host_fraction,
            host_threads)
        fr = Frontier(prmu=np.zeros((0, jobs), np.int16),
                      depth=np.zeros(0, np.int16),
                      tree=int(meta.get("warmup_tree", 0)),
                      sol=int(meta.get("warmup_sol", 0)),
                      best=int(host_state.best.min()))
        states = driver.commit(host_state)
        del host_state
    else:
        with tracelog.span("bfs_warmup", problem=prob.name,
                           target=min_seed * n_dev) as ws:
            fr = prob.warmup(table, lb_kind, init_ub,
                             target=min_seed * n_dev)
            ws.set(frontier=len(fr.depth), tree=fr.tree)
        init_best = (fr.best if init_ub is None
                     else min(fr.best, int(init_ub)))
        dmask, h_prmu, h_depth = hybrid.split_host_share(
            fr.prmu, fr.depth, host_fraction)
        if len(h_depth):
            session = hybrid.make_session(prob, table, h_prmu, h_depth,
                                          lb_kind, init_best,
                                          n_threads=host_threads)
            fr.prmu, fr.depth = fr.prmu[dmask], fr.depth[dmask]
        fr.aux = prob.seed_aux(table, fr.prmu, fr.depth)
        states = driver.seed(fr, capacity, jobs, init_best)
        if telemetry is not None:
            width = tele.WIDTH if telemetry else 0
            states = [s._replace(telemetry=torch.zeros(
                width, dtype=torch.int64, device=s.prmu.device))
                for s in states]

    if overlap is None:
        overlap = _cfg.env_flag(_cfg.OVERLAP_FLAG)
    # the host tier's per-segment merge needs the synchronous boundary, and
    # a multi-process job stays synchronous (run_segmented's own rule)
    use_overlap = bool(overlap) and session is None and n_procs == 1

    ladder_ctl = client = None
    if ladder_drivers is not None or incumbent_board is not None:
        c0 = worker_counters(states)
    if ladder_drivers is not None:
        from .ladder import RungController
        ladder_ctl = RungController(ladder_drivers, n_dev)
        ladder_ctl.start(int(c0["size"].sum()), meta_rung=meta_rung)
    if incumbent_board is not None:
        client = inc_mod.BoardClient(
            incumbent_board,
            incumbent_key or inc_mod.share_key(table, problem=prob.name))
        # the starting best (a resumed checkpoint's, or the warm-up's /
        # init_ub), so peers tighten before this search's first segment
        client.publish(int(c0["best"].min()))

    def cap():
        return client.cap() if client is not None else None

    max_iters = (None if max_rounds is None
                 else max_rounds * balance_period)
    stop_fn = None
    if stop_event is not None or should_stop is not None:
        def stop_fn(rep):
            return ((stop_event is not None and stop_event.is_set())
                    or (should_stop is not None and should_stop(rep)))
    if (segment_iters is None and checkpoint_path is None
            and session is None and stop_fn is None):
        with tracelog.span("engine.run", workers=n_dev):
            out = driver.run(_fold_cap(states, cap()), max_iters)
    else:
        ckpt_meta = {"warmup_tree": fr.tree, "warmup_sol": fr.sol,
                     # the snapshot's problem stamp: a resume refuses a
                     # cross-problem re-home (checked above)
                     "problem": prob.name,
                     # the host tier's seed rides every checkpoint, so a
                     # killed -C run resumes without losing its share (the
                     # killed session's work was committed nowhere)
                     "host_prmu": h_prmu if session else
                     np.zeros((0, jobs), np.int16),
                     "host_depth": h_depth if session else
                     np.zeros(0, np.int16)}
        if checkpoint_meta_extra is not None or ladder_ctl is not None:
            base_meta = ckpt_meta

            def ckpt_meta():
                extra = (checkpoint_meta_extra()
                         if callable(checkpoint_meta_extra)
                         else checkpoint_meta_extra or {})
                # the rung of the next segment, chosen at this boundary
                rung = ({"ladder_rung": ladder_ctl.current_chunk}
                        if ladder_ctl is not None else {})
                return {**base_meta, **extra, **rung}

        grow_fn = stop_pending = None
        seg_iters = segment_iters or 2048
        if use_overlap:
            # one dispatch a segment, its macro-iteration count fixed from
            # the segment length alone (the ones past the ceiling are
            # device no-ops); overflow recovery and draining live in the
            # overlapped driver
            n_macro = -(-seg_iters // balance_period)

            def run_fn(s, target):
                drv = (ladder_ctl.driver() if ladder_ctl is not None
                       else driver)
                return drv.run_async(_fold_cap(s, cap()), target, n_macro)

            def grow_fn(s):
                capacity = s[0].prmu.shape[-1]
                return [checkpoint.grow(x, capacity * 2) for x in s]

            if stop_event is not None:
                stop_pending = stop_event.is_set
        else:
            def run_fn(s, target):
                drv = (ladder_ctl.driver() if ladder_ctl is not None
                       else driver)
                return drv.run(_fold_cap(s, cap()), max_iters=target)

        def hb(rep):
            if ladder_ctl is not None:
                # the rung of the next dispatch, from this boundary's pool
                # (under overlap the next segment is already in flight, so
                # the switch lands one boundary later)
                ladder_ctl.observe(rep.pool_size, segment=rep.segment)
            if client is not None:
                client.publish(rep.best)
            if heartbeat is not None:
                heartbeat(rep)

        out = checkpoint.run_segmented(
            run_fn, states, segment_iters=seg_iters,
            checkpoint_path=checkpoint_path, heartbeat=hb,
            checkpoint_every=checkpoint_every, max_total_iters=max_iters,
            checkpoint_meta=ckpt_meta, should_stop=stop_fn,
            post_segment=session.post_segment if session else None,
            retry_attempts=retry_attempts,
            segment_timeout_s=segment_timeout_s, overlap=use_overlap,
            grow_fn=grow_fn, stop_pending=stop_pending)

    c = worker_counters(out)
    best = int(c["best"].min())
    if client is not None:
        client.publish(best)     # the final best: peers prune against it
    h_tree = h_sol = 0
    host_stats = {}
    if session is not None:
        h_tree, h_sol, best, host_stats = hybrid.finish(session, best)
    tree = int(c["tree"].sum()) + fr.tree + h_tree
    complete = int(c["size"].sum()) == 0
    tracelog.event(
        "engine.complete", workers=n_dev, tree=tree, best=best,
        iters=int(c["iters"].max()),
        balance_rounds=int(c["iters"].max()) // max(balance_period, 1),
        steals=int(c["steals"].sum()), complete=complete)
    summary = None
    if out[0].telemetry.shape[-1] > 0:
        summary = tele.summarize(mesh.gather_rows(
            (torch.stack([s.telemetry.cpu() for s in out]).numpy(),))[0])
    res = DistResult(
        explored_tree=tree,
        explored_sol=int(c["sol"].sum()) + fr.sol + h_sol,
        best=best, telemetry=summary,
        per_device={"tree": c["tree"], "sol": c["sol"], "iters": c["iters"],
                    "evals": c["evals"], "sent": c["sent"],
                    "recv": c["recv"], "steals": c["steals"],
                    "final_size": c["size"], **host_stats},
        warmup_tree=fr.tree, warmup_sol=fr.sol, complete=complete,
        problem=prob.name)
    if obs_audit.enabled():
        # node conservation on every result (host-side sums of counters
        # already fetched); a failure raises under TTS_AUDIT_HARD=1
        obs_audit.check_result(res)
    return res
