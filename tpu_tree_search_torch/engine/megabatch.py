"""Request megabatching: B instances of one shape class in one loop.

Reproduces `tpu_tree_search/engine/megabatch.py`: `MemberIncompatible`,
`stack_states`, `slice_member`, the batched loop (`BatchedDriver`),
`MemberSpec` and `serve_batch`.

The JAX engine gives every `SearchState` leaf a member axis after the
worker axis (pools `(D, B, J, capacity)`, counters `(D, B)`) and runs the
solo macro-iteration (`distributed.member_body`) under `jax.vmap`. Here a
search is a list of single-device worker states, so a batch of B members
on D workers is B such lists: member b's workers hold member b's tables
and step functions, and one macro-iteration of the batch runs
`member_body(steps_b, ...)(states_b, active_b)` for every member. The
per-member rules of the JAX loop hold:

- termination: `active_b` (work left among b's workers, none of them
  overflowed, b's iteration count below its own `max_iters[b]`) is a
  device bool computed at the start of each macro-iteration; a member
  past it takes no-op steps and a no-op balance round, so its counters,
  telemetry and live rows stay as they were while the others go on. The
  batch stops when no member is active;
- `bound_cap`: each member's pruning ceiling is folded into its workers'
  `best` once a dispatch, on the device, before the first macro-iteration;
- `max_iters`: a cumulative ceiling per member, so a stopped member's
  target stops advancing and it freezes;
- accounting: counters, telemetry and audits per member; a member's
  checkpoint is its slice `(D, ...)` of the batch state, in the solo file
  format, so it resumes solo or in another batch.

When every worker is on one CUDA device, `BatchedDriver.run_once`
captures one macro-iteration of the whole batch, every member's kernels
launched in it, as one CUDA graph (the counterpart of the vmapped
`pallas_call`) and replays it, reading a `(B, 3)` status (each member's
total size, any overflow, iterations) once a replay. The capture takes
`_DistDriver._capture`'s discipline: one no-op macro-iteration on a side
stream first, counters in static tensors, the targets in a static `(B,)`
tensor loaded before the replays. A batch on one card that cannot be
captured raises. On other workers (the CPU) the same macro-iterations run
eagerly, a member past its condition skipped, so a frozen member's whole
state, pool rows above the cursor included, stays the same bytes. On the
card the no-op steps of a frozen member write only rows above its cursor,
which are garbage by the pool invariant.

The pool capacity is shared: the batch runs at the largest member's
requirement, an overflowing member grows every member's pools x2 (a new
capture) and the same targets are dispatched again. The step's fused
route stays off, as in JAX (the batched route is the unfused pipeline).

Left out, raising `NotImplementedError` naming its ROADMAP item: the
executor cache (`loop_cache`, A9) and a batch in a multi-process job
(A8b).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import convert
from ..obs import audit as obs_audit
from ..obs import tracelog
from ..ops import kernels
from ..parallel import mesh
from . import device, distributed as dist, telemetry as tele
from .device import COUNTER_DTYPES, SearchState
from .distributed import DistResult

_POOL_LEAVES = ("prmu", "depth", "aux")


class MemberIncompatible(ValueError):
    """One member's resume state cannot join this batch (a cross-problem
    checkpoint, another aux dtype, another telemetry width). Typed, with
    the offending member's index, so a caller can serve that member solo
    and batch the others."""

    def __init__(self, member: int, reason: str):
        super().__init__(reason)
        self.member = member


# --------------------------------------------------------------- stacking


def stack_states(states: list, capacity: int | None = None) -> SearchState:
    """Stack B host states (leaves `(D, ...)`: numpy, or CPU tensors) into
    one batched host state (numpy leaves `(D, B, ...)`) at `capacity` pool
    rows (default: the widest member's). A member's pool is zero-padded on
    the row axis (`checkpoint.grow`'s rule: rows above the cursor are
    garbage); the batched leaves are allocated once and each member writes
    its slice."""
    D = np.asarray(states[0].prmu).shape[0]
    B = len(states)
    if capacity is None:
        capacity = max(np.asarray(s.prmu).shape[-1] for s in states)
    out = {}
    for name in SearchState._fields:
        leaves = [np.asarray(getattr(s, name)) for s in states]
        shape = list(leaves[0].shape)
        if name in _POOL_LEAVES:
            shape[-1] = int(capacity)
        arr = np.zeros([D, B] + shape[1:], leaves[0].dtype)
        for b, leaf in enumerate(leaves):
            if name in _POOL_LEAVES:
                arr[:, b, ..., :leaf.shape[-1]] = leaf
            else:
                arr[:, b] = leaf
        out[name] = arr
    return SearchState(**out)


def slice_member(state: SearchState, b: int) -> SearchState:
    """Member b's solo-shaped view `(D, ...)` of a batched host state: the
    per-member checkpoint and result."""
    return SearchState(*(x[:, b] for x in state))


# ------------------------------------------------------------ the loop


class _BatchGraph(NamedTuple):
    """One captured macro-iteration of a batch: the graph, each member's
    workers' counters and telemetry vectors it reads and writes, the
    members' iteration ceilings `(B,)`, the `(B, 3)` status it leaves and
    the kernel launches of one replay."""

    graph: torch.cuda.CUDAGraph
    counters: list
    telemetry: list
    max_iters: torch.Tensor
    status: torch.Tensor
    launches: dict


class BatchedDriver:
    """Runs B members' macro-iterations together over one worker list.

    Member b is a `distributed._DistDriver` over `devices` with its own
    tables (`make_tables(b, device)`) and steps, so its body is the solo
    `member_body`. Its `limit` is the solo driver's tightened limit at
    the same knobs, `min(limit_fn(cap), cap - D * transfer_cap)`: the
    balance round's overflow predicate reads it. A committed batch is a
    list of B worker lists. `host_reads` counts the status reads of
    `run_once`, `macro_iters` the batch's macro-iterations and `captures`
    the CUDA graphs captured, by pool capacity."""

    def __init__(self, devices, make_tables, make_local_step,
                 balance_period: int, transfer_cap: int, min_transfer: int,
                 limit_fn, batch: int, name: str = "pfsp", key: tuple = ()):
        if mesh.process_count() > 1:
            raise dist._not_ported("a batch in a multi-process job", "A8b",
                                   "megabatch")
        self.devices = list(devices)
        self.batch = int(batch)
        self.members = [
            dist._DistDriver(self.devices,
                             lambda dev, b=b: make_tables(b, dev),
                             make_local_step, balance_period, transfer_cap,
                             min_transfer, limit_fn, name=name, key=key)
            for b in range(self.batch)]
        self.host_reads = 0
        self.macro_iters = 0
        self.captures: dict[int, int] = {}

    def limit(self, capacity: int) -> int:
        return self.members[0].limit(capacity)

    def commit(self, state: SearchState) -> list[list[SearchState]]:
        """A batched host state `(D, B, ...)` as B worker lists, worker d
        of each on `devices[d]`."""
        arrays = {f: np.asarray(getattr(state, f))
                  for f in SearchState._fields}
        return [[convert.state_from_numpy(
                    {f: a[d, b] for f, a in arrays.items()}, dev)
                 for d, dev in enumerate(self.devices)]
                for b in range(self.batch)]

    @staticmethod
    def _graph_ok(states) -> bool:
        devs = {s.prmu.device for sb in states for s in sb}
        return len(devs) == 1 and next(iter(devs)).type == "cuda"

    def _graph_key(self, states, capacity: int) -> tuple:
        return ("batch", self.batch) + tuple(
            m._graph_key(sb, capacity) for m, sb in zip(self.members, states))

    def _capture(self, states, capacity: int) -> _BatchGraph:
        """Capture one macro-iteration of every member on `states`' pools
        (updated in place, at the addresses the graph holds), after one
        no-op macro-iteration on a side stream."""
        bodies = [m.body(capacity) for m in self.members]
        self.captures[capacity] = self.captures.get(capacity, 0) + 1
        dev = states[0][0].prmu.device
        static = [[s._replace(
            **{f: getattr(s, f).clone() for f in COUNTER_DTYPES},
            telemetry=s.telemetry.clone()) for s in sb] for sb in states]
        max_iters = torch.zeros(self.batch, dtype=torch.int64, device=dev)
        status = torch.zeros((self.batch, 3), dtype=torch.int64, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            off = torch.zeros((), dtype=torch.bool, device=dev)
            for body, sb in zip(bodies, static):
                body(sb, off)
        torch.cuda.current_stream(dev).wait_stream(side)
        kernels.take_captured()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for b, (body, sb) in enumerate(zip(bodies, static)):
                out = body(sb, dist._loop_cond(sb, max_iters[b]))
                for s, o in zip(sb, out):
                    for f in COUNTER_DTYPES:
                        getattr(s, f).copy_(getattr(o, f))
                    s.telemetry.copy_(o.telemetry)
                status[b].copy_(dist._status(out))
        return _BatchGraph(
            graph, [[{f: getattr(s, f) for f in COUNTER_DTYPES} for s in sb]
                    for sb in static],
            [[s.telemetry for s in sb] for sb in static], max_iters, status,
            kernels.take_captured())

    def _graph(self, states, capacity: int) -> _BatchGraph:
        """The cached (or newly captured) batch graph of `states`' pools,
        loaded with their counters."""
        key = self._graph_key(states, capacity)
        g = device._GRAPHS.pop(key, None)
        if g is None:
            g = self._capture(states, capacity)
        device._GRAPHS[key] = g
        while len(device._GRAPHS) > device._GRAPH_CACHE:
            device._GRAPHS.popitem(last=False)
        for sb, ctrs, tvs in zip(states, g.counters, g.telemetry):
            for s, ctr, tv in zip(sb, ctrs, tvs):
                for f, t in ctr.items():
                    t.copy_(getattr(s, f))
                tv.copy_(s.telemetry)
        return g

    def run_once(self, states: list, max_iters_b, bound_caps_b) -> list:
        """One dispatch: macro-iterations of the batch until no member is
        active, member b toward its cumulative ceiling `max_iters_b[b]`
        with its pruning ceiling `bound_caps_b[b]` (None: no fold) folded
        in first. No overflow recovery here: `serve_batch` grows the whole
        batch and dispatches the same targets again. The pools are
        updated in place."""
        targets = [int(t) for t in max_iters_b]
        capacity = states[0][0].prmu.shape[-1]

        def going(b, size, overflow, iters) -> bool:
            return size > 0 and not overflow and iters < targets[b]

        if self._graph_ok(states):
            g = self._graph(states, capacity)
            g.max_iters.copy_(torch.tensor(targets, dtype=torch.int64))
            # the per-member incumbent fold, once a dispatch, on the device
            for ctrs, cap in zip(g.counters, bound_caps_b):
                if cap is not None:
                    for ctr in ctrs:
                        ctr["best"].clamp_(max=int(cap))
            while True:
                kernels.replay(g.graph, g.launches)
                self.macro_iters += 1
                status = g.status.tolist()
                self.host_reads += 1
                if not any(going(b, *st) for b, st in enumerate(status)):
                    break
            return [[s._replace(**{f: t.clone() for f, t in ctr.items()},
                                telemetry=tv.clone())
                     for s, ctr, tv in zip(sb, ctrs, tvs)]
                    for sb, ctrs, tvs in zip(states, g.counters,
                                             g.telemetry)]
        states = [dist._fold_cap(sb, cap)
                  for sb, cap in zip(states, bound_caps_b)]
        bodies = [m.body(capacity) for m in self.members]
        dev0 = states[0][0].prmu.device
        lims = [torch.full((), t, dtype=torch.int64, device=sb[0].prmu.device)
                for sb, t in zip(states, targets)]
        while True:
            conds = [dist._loop_cond(sb, lim) for sb, lim in zip(states, lims)]
            act = torch.stack([c.to(dev0) for c in conds]).tolist()
            self.host_reads += 1
            if not any(act):
                return states
            self.macro_iters += 1
            for b, (body, cond) in enumerate(zip(bodies, conds)):
                if act[b]:
                    states[b] = body(states[b], cond)


# ----------------------------------------------------------- host driver


@dataclasses.dataclass
class MemberSpec:
    """One request's slice of a batch. The knobs that must agree across
    the batch (problem, table shape, lb, chunk, capacity, balance knobs,
    segment geometry) are `serve_batch`'s; everything per request is
    here."""

    table: np.ndarray
    init_ub: int | None = None
    checkpoint_path: str | None = None
    # a dict, or a callable returning one, merged into every checkpoint
    # meta this member writes
    checkpoint_meta_extra: object = None
    incumbent_key: str | None = None


class _Member:
    """One member's host-side bookkeeping inside a batch."""

    def __init__(self, idx: int, spec: MemberSpec):
        self.idx = idx
        self.spec = spec
        self.warmup_tree = 0
        self.warmup_sol = 0
        self.start_iters = 0
        self.frozen_target: int | None = None   # set on a stop
        self.active = True
        self.stopped = False     # stopped (not drained) when it froze
        self.folder = None       # checkpoint._ReportFolder
        self.client = None       # incumbent BoardClient
        self.result: DistResult | None = None
        self.last_saved_seg = -1


def _host(state) -> SearchState:
    """A host state (CPU tensors or numpy) with numpy leaves."""
    return SearchState(*(np.asarray(x) for x in state))


def _fetch_batch(states: list, fields: tuple, rows: int | None = None
                 ) -> dict:
    """Fields of every member's workers as numpy `(D, B, ...)` arrays: the
    counters and telemetry vectors in one transfer
    (`checkpoint._fetch_many`), each pool field (with `rows`, each pool's
    first `rows` rows) in one more."""
    from . import checkpoint

    B, D = len(states), len(states[0])
    dev0 = states[0][0].prmu.device
    stacked = {}
    for f in fields:
        leaves = [getattr(s, f) for sb in states for s in sb]
        if f in _POOL_LEAVES and rows is not None:
            leaves = [x[..., :rows] for x in leaves]
        stacked[f] = torch.stack([x.to(dev0) for x in leaves])
    small = [f for f in fields if f not in _POOL_LEAVES]
    got = dict(zip(small, checkpoint._fetch_many(
        tuple(stacked[f] for f in small), fire=False)))
    got.update({f: stacked[f].cpu().numpy() for f in fields
                if f in _POOL_LEAVES})
    return {f: np.swapaxes(got[f].reshape((B, D) + got[f].shape[1:]), 0, 1)
            for f in fields}


def serve_batch(specs: list, problem="pfsp", lb_kind: int = 1,
                devices: list | None = None, n_devices: int | None = None,
                chunk: int | None = None, capacity: int | None = None,
                balance_period: int | None = None,
                transfer_cap: int | None = None,
                min_transfer: int | None = None,
                min_seed: int = 32,
                segment_iters: int = 512,
                checkpoint_every: int = 1,
                heartbeat=None, member_stop=None, on_member_done=None,
                on_member_stopped=None,
                stop_event=None, loop_cache=None,
                incumbent_board=None, tuner=None,
                stall_limit: int = 3) -> list:
    """Solve B instances of one table shape in one batched loop, in
    segments (the JAX `serve_batch`). The workers are
    `parallel.mesh.worker_devices(n_devices, devices)`, as in
    `distributed.search`.

    Per-member hooks (all optional, `b` the member's index):
    `heartbeat(b, SegmentReport)` after every segment;
    `member_stop(b, SegmentReport) -> bool` stops the member at this
    boundary (it is checkpointed and freezes, the others go on);
    `on_member_done(b, DistResult)` fires when a member's pools drain;
    `on_member_stopped(b, DistResult)` fires when a stop takes effect,
    with the member's partial result. `stop_event` stops the whole batch
    at the next boundary (every active member checkpoints).

    Each member is seeded by the solo rules (warm-up, `init_ub` fold,
    round-robin stripes) or resumed from its checkpoint (a `-C` host share
    pushed back into a pool, an elastic reshard audited, the pool grown
    until its fullest stripe fits); the batch runs at the largest member's
    capacity. A member whose checkpoint is another problem's, or whose aux
    dtype or telemetry width differs from the majority, raises
    `MemberIncompatible`.

    Returns the per-member `DistResult` list: `complete=True` members
    drained; the others stopped with partial counters, and their
    checkpoints resume (solo or in a later batch) to the same totals.

    `chunk=None`/`balance_period=None` resolve through
    `tuner.resolve(..., batch=B, allow_probe=False)`, else
    `tune/defaults.params_for("serving", ..., batch=B)` (the batched
    row, never the solo one)."""
    from ..tune import defaults as tune_defaults
    from ..utils import faults
    from . import checkpoint, incumbent as inc_mod

    prob = dist._resolve_problem(problem)
    if not specs:
        raise ValueError("serve_batch needs at least one MemberSpec")
    if loop_cache is not None:
        raise dist._not_ported("the executor cache (loop_cache)", "A9",
                               "megabatch.serve_batch")
    devs = mesh.worker_devices(n_devices, devices)
    n_dev = len(devs)
    B = len(specs)
    tables0 = np.asarray(specs[0].table)
    for sp in specs:
        if np.asarray(sp.table).shape != tables0.shape:
            raise ValueError(
                "all batch members must share one table shape, got "
                f"{np.asarray(sp.table).shape} vs {tables0.shape}")
    jobs = prob.slots(tables0)
    aux_rows = prob.aux_rows(tables0)
    adt = prob.aux_dtype(tables0)
    if chunk is None or balance_period is None:
        if tuner is not None:
            params = tuner.resolve(jobs, tables0.shape[0], lb_kind,
                                   n_workers=n_dev, allow_probe=False,
                                   problem=prob.name, batch=B,
                                   device=devs[0])
        else:
            params = tune_defaults.params_for(
                "serving", jobs, tables0.shape[0], problem=prob.name,
                batch=B)
        if chunk is None:
            chunk = params.chunk
            if transfer_cap is None and params.transfer_cap:
                transfer_cap = params.transfer_cap
        if balance_period is None:
            balance_period = params.balance_period
        tracelog.event("tuner.resolve", chunk=chunk,
                       balance_period=balance_period,
                       source=params.source, batch=B)
    if capacity is None:
        capacity = prob.default_capacity(tables0)
    if transfer_cap is None:
        transfer_cap = dist.default_transfer_cap(
            chunk, jobs, aux_rows, n_dev, aux_itemsize=adt.itemsize)
    min_transfer = min_transfer or 2 * chunk

    def make_local_step(t, limit):
        # the fused route stays off under megabatch, as in JAX: the batched
        # route is the unfused pipeline
        return prob.make_step(t, lb_kind, chunk, 1024, limit, fused="off")

    driver = BatchedDriver(
        devs, lambda b, dev: prob.make_tables(np.asarray(specs[b].table),
                                              device=dev),
        make_local_step, balance_period, transfer_cap, min_transfer,
        limit_fn=lambda cap: prob.usable_rows(cap, chunk, jobs), batch=B,
        name=prob.name,
        key=(jobs, int(tables0.shape[0]), lb_kind, chunk, "off"))

    members = [_Member(i, sp) for i, sp in enumerate(specs)]

    # each member by the solo rules, to one common capacity: the largest
    # member's requirement (growth keeps the contents)
    host_states: list[SearchState] = []
    need_caps: list[int] = []
    for m in members:
        sp = m.spec
        table = np.asarray(sp.table)
        resumed = None
        if sp.checkpoint_path and checkpoint.resume_path(sp.checkpoint_path):
            st, meta, _ = checkpoint.load_resilient(
                sp.checkpoint_path,
                p_times=table if prob.name == "pfsp" else None,
                device="cpu")
            saved_prob = meta.get("problem")
            saved_prob = ("pfsp" if saved_prob is None
                          else str(np.asarray(saved_prob)))
            if saved_prob != prob.name:
                raise MemberIncompatible(
                    m.idx,
                    f"checkpoint {sp.checkpoint_path} was written by "
                    f"problem {saved_prob!r}; refusing to resume it as "
                    f"{prob.name!r}")
            resumed = (st, meta)
        if resumed is not None:
            host_state, meta = resumed
            if len(np.asarray(meta.get("host_depth", []))):
                # a -C checkpoint's host share goes back into a pool (the
                # batch has no host tier), so no subtree is lost
                from . import hybrid
                host_state = hybrid.restore_host_share(
                    host_state, np.asarray(meta["host_prmu"], np.int16),
                    np.asarray(meta["host_depth"], np.int16), table,
                    problem=prob)
            shape = tuple(host_state.prmu.shape)
            if len(shape) != 3 or shape[0] != n_dev:
                pre_sums = (obs_audit.state_sums(host_state)
                            if obs_audit.enabled() else None)
                host_state = checkpoint.reshard_state(host_state, n_dev,
                                                      device="cpu")
                if pre_sums is not None:
                    obs_audit.check_reshard(pre_sums, host_state,
                                            edge="elastic_resume")
            m.warmup_tree = int(meta.get("warmup_tree", 0))
            m.warmup_sol = int(meta.get("warmup_sol", 0))
            cap = host_state.prmu.shape[-1]
            need = int(host_state.size.max())
            while driver.limit(cap) < max(need, 1):
                cap *= 2
            if cap != host_state.prmu.shape[-1]:
                host_state = checkpoint.grow(host_state, cap)
            host_states.append(_host(host_state))
            need_caps.append(cap)
        else:
            with tracelog.span("bfs_warmup", problem=prob.name,
                               member=m.idx,
                               target=min_seed * n_dev) as ws:
                fr = prob.warmup(table, lb_kind, sp.init_ub,
                                 target=min_seed * n_dev)
                ws.set(frontier=len(fr.depth), tree=fr.tree)
            init_best = (fr.best if sp.init_ub is None
                         else min(fr.best, int(sp.init_ub)))
            fr.aux = prob.seed_aux(table, fr.prmu, fr.depth)
            m.warmup_tree, m.warmup_sol = fr.tree, fr.sol
            # the member runs at the common capacity, but its stripes are
            # built at their own width: striping is front-aligned, and
            # stack_states pads them with zero rows
            cap = capacity
            stripe = -(-max(len(fr.depth), 1) // n_dev)
            while driver.limit(cap) < max(stripe, 1):
                cap *= 2
            need_caps.append(cap)
            host_states.append(SearchState(**dist._shard_frontier(
                fr, n_dev, jobs, init_best, limit=driver.limit(cap))))

    common_cap = max(need_caps)

    def _homogeneous(values, what: str) -> None:
        # a resumed member may carry another aux dtype or telemetry width;
        # the one that differs from the majority is blamed
        if len(set(values)) <= 1:
            return
        modal = max(set(values), key=values.count)
        offender = next(i for i, v in enumerate(values) if v != modal)
        raise MemberIncompatible(
            offender,
            f"batch member {offender} carries {what} "
            f"{values[offender]!r} (batch majority: {modal!r}); "
            "serve that request solo")

    _homogeneous([s.aux.dtype for s in host_states], "pool aux dtype")
    _homogeneous([int(s.telemetry.shape[-1]) for s in host_states],
                 "telemetry block width")

    t0 = time.perf_counter()
    for m, hs in zip(members, host_states):
        m.start_iters = int(hs.iters.max())
        m.folder = checkpoint._ReportFolder(
            SearchState(*(torch.as_tensor(x) for x in hs)), t0, stall_limit,
            m.start_iters)
        if incumbent_board is not None:
            m.client = inc_mod.BoardClient(
                incumbent_board,
                m.spec.incumbent_key
                or inc_mod.share_key(np.asarray(m.spec.table),
                                     problem=prob.name))
            m.client.publish(int(hs.best.min()))

    state = driver.commit(stack_states(host_states, capacity=common_cap))
    del host_states

    def member_meta(m: _Member) -> dict:
        extra = m.spec.checkpoint_meta_extra
        extra = (extra() if callable(extra) else dict(extra or {}))
        return {"warmup_tree": m.warmup_tree, "warmup_sol": m.warmup_sol,
                "problem": prob.name,
                "host_prmu": np.zeros((0, jobs), np.int16),
                "host_depth": np.zeros(0, np.int16), **extra}

    # one whole-batch fetch a save boundary (each pool's live rows), shared
    # by every member that saves there
    host_cache: dict = {"seg": -1, "state": None}

    def _host_state(st, seg: int, rows: int) -> SearchState:
        if host_cache["seg"] != seg:
            host_cache["seg"] = seg
            host_cache["state"] = SearchState(
                **_fetch_batch(st, SearchState._fields, rows=rows))
        return host_cache["state"]

    def save_member(m: _Member, st, seg: int, rows: int) -> None:
        if not m.spec.checkpoint_path:
            return
        snap = slice_member(_host_state(st, seg, rows), m.idx)
        snap = convert.state_from_numpy(
            {f: getattr(snap, f) for f in SearchState._fields}, "cpu",
            capacity=st[0][0].prmu.shape[-1])
        checkpoint.save(m.spec.checkpoint_path, snap,
                        meta={**member_meta(m), "segment": seg})
        if obs_audit.roundtrip_enabled():
            obs_audit.check_checkpoint_roundtrip(m.spec.checkpoint_path,
                                                 snap)
        m.last_saved_seg = seg

    def finish_member(m: _Member, fetched, complete: bool) -> DistResult:
        f = {k: (v[:, m.idx] if v is not None else None)
             for k, v in fetched.items()}
        best = int(f["best"].min())
        if m.client is not None:
            m.client.publish(best)
        telemetry = None
        if f.get("telemetry") is not None and f["telemetry"].size:
            telemetry = tele.summarize(f["telemetry"])
        res = DistResult(
            explored_tree=int(f["tree"].sum()) + m.warmup_tree,
            explored_sol=int(f["sol"].sum()) + m.warmup_sol,
            best=best, telemetry=telemetry,
            per_device={
                "tree": f["tree"], "sol": f["sol"], "iters": f["iters"],
                "evals": f["evals"], "sent": f["sent"],
                "recv": f["recv"], "steals": f["steals"],
                "final_size": f["size"],
            },
            warmup_tree=m.warmup_tree, warmup_sol=m.warmup_sol,
            complete=complete, problem=prob.name)
        if obs_audit.enabled():
            obs_audit.check_result(res)
        m.result = res
        m.active = False
        return res

    seg = 0
    names = ("iters", "tree", "sol", "size", "best", "steals",
             "overflow", "evals", "sent", "recv")
    tele_on = int(state[0][0].telemetry.shape[-1]) > 0
    with tracelog.span("batch.execute", batch=B, problem=prob.name,
                       jobs=jobs, chunk=chunk) as bs:
        while any(m.active for m in members):
            # run_segmented's injection points, so the drills cover a batch
            faults.fire("segment_start", segment=seg + 1)
            targets = []
            caps = []
            for m in members:
                if not m.active:
                    # frozen: its recorded iteration count, so its
                    # condition is already false
                    targets.append(m.frozen_target or m.start_iters)
                    caps.append(None)
                else:
                    targets.append(m.start_iters + (seg + 1) * segment_iters)
                    caps.append(m.client.cap() if m.client else None)
            out = driver.run_once(state, targets, caps)
            # one transfer of every member's counters
            faults.fire("host_fetch")
            fetched = _fetch_batch(
                out, names + (("telemetry",) if tele_on else ()))
            fetched.setdefault("telemetry", None)
            if bool(fetched["overflow"].any()):
                # lossless whole-batch growth: every pool x2, a new
                # capture, the same targets again (not a new segment)
                cap2 = out[0][0].prmu.shape[-1] * 2
                state = [[checkpoint.grow(s, cap2) for s in sb]
                         for sb in out]
                continue
            state = out
            seg += 1
            rows = int(fetched["size"].max())
            batch_stop = stop_event is not None and stop_event.is_set()
            for m in members:
                if not m.active:
                    continue
                rep = m.folder.fold(
                    tuple(fetched[n][:, m.idx]
                          for n in checkpoint.REPORT_FIELDS)
                    + ((fetched["telemetry"][:, m.idx],) if tele_on
                       else ()), seg)
                if m.client is not None:
                    m.client.publish(rep.best)
                if heartbeat is not None:
                    heartbeat(m.idx, rep)
                if rep.pool_size == 0:
                    # no drain-save: a drained member's snapshot would hold
                    # an empty pool nobody resumes
                    res = finish_member(m, fetched, complete=True)
                    if on_member_done is not None:
                        on_member_done(m.idx, res)
                    continue
                stop = batch_stop or (
                    member_stop is not None and member_stop(m.idx, rep))
                if stop:
                    save_member(m, state, seg, rows)
                    m.frozen_target = rep.iters
                    m.stopped = True
                    res = finish_member(m, fetched, complete=False)
                    if on_member_stopped is not None:
                        on_member_stopped(m.idx, res)
                    continue
                if m.spec.checkpoint_path and seg % checkpoint_every == 0:
                    save_member(m, state, seg, rows)
                m.folder.check_stall(rep)
            faults.fire("post_segment", segment=seg)
        bs.set(segments=seg,
               done=sum(1 for m in members
                        if m.result is not None and m.result.complete))
    return [m.result for m in members]
