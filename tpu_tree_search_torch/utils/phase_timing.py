"""Measured per-phase cost attribution for the CSV timing columns.

Reproduces `tpu_tree_search/utils/phase_timing.py`. The reference
brackets every phase of its host loop with wall-clock timers
(memcpy/malloc/kernel/genchild/poolops/idle/termination,
PFSP_statistic.c:69-112). Here a step is pop -> bound -> prune -> branch
on the device, a CUDA graph of many steps on the card, so phases cannot
be timed in flight. Instead their unit costs are MEASURED on the real
instance and shapes: the pop and bound evaluation alone against the
full step, each on a warmed pool state, and over several workers one
balance round. The attribution scales them by each worker's counters:

    kernel_time[w]    = evals[w] * (bound time / evals per step)
    gen_child_time[w] = iters[w] * (full step - bound)     # the rest
    time_load_bal[w]  = rounds   * balance round time
    idle_time[w]      = elapsed - (the above)              # remainder

On the card a unit cost is CUDA-event time around a run of calls: a
host clock around one call would add the launch and synchronisation
floor to sub-millisecond costs. The bound's run of calls is captured
into a CUDA graph and replayed, as the steps it is compared with are
(`device.run`), so that launch gaps count in neither. On the CPU it is
`perf_counter` time.

`write_csv_with_phases` is the `pfsp --csv` row writer: the reference's
single-device or multi-device schema (`csv_stats`), with these measured
columns. A profiling failure prints a warning and still writes the row,
with zero timing columns.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops import expand as ex, kernels

# bound evaluations timed back to back on the card; the CPU, with no
# launch floor to spread, times `reps` of them
CUDA_REPS = 64


def _seconds(fn, dev: torch.device) -> float:
    """Seconds fn() takes: CUDA events around it on a card, the host
    clock on the CPU."""
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _graph_seconds(fn, dev: torch.device) -> float:
    """Seconds of fn's device work: fn captured into a CUDA graph (after
    one eager call, which makes every kernel's first launch), one replay
    timed by CUDA events. The kernels launched count at the replay."""
    from ..engine import device

    fn()
    torch.cuda.synchronize(dev)
    with device.CAPTURE_LOCK:
        kernels.take_captured()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph,
                              capture_error_mode=device.CAPTURE_MODE):
            fn()
        launches = kernels.take_captured()
    return _seconds(lambda: kernels.replay(graph, launches), dev)


def _pop_and_bound(tables, state, lb_kind: int, chunk: int, tile: int):
    """The step's pop and bound evaluation, nothing else: the 'kernel'
    phase in the reference's terms (evaluate_gpu, PFSP_gpu_lib.cu:129-152).
    LB1/LB1_d take the bounds-only expand kernel at the route's tile; LB2
    the dense route's bound (the fronts-only expand launch, then the pair
    sweep) over the whole child grid, for any job count; `profile_phases`
    scales that to the prefilter route's sweep tiers."""
    from ..engine import device

    J = state.prmu.shape[0]
    M = tables.p.shape[0]
    if lb_kind == 2:
        _, TB, _ = device.lb2_route(J, M, int(tables.ma0.shape[0]), chunk,
                                    tile, on_cuda=state.prmu.is_cuda)
    else:
        TB = ex.effective_tile(J, chunk, tile, lb_kind, machines=M)
    p_prmu, p_depth, p_aux, *_ = device.pop_chunk(state, chunk, M)
    return ex.expand_bounds(tables, p_prmu, p_depth, p_aux.to(torch.int32),
                            lb_kind=lb_kind, tile=TB)


def _clone(state):
    return state._replace(**{f: getattr(state, f).clone()
                             for f in state._fields})


def profile_phases(tables, state, lb_kind: int, chunk: int,
                   tile: int = 1024, reps: int = 3,
                   warm_iters: int = 8) -> dict:
    """Measured per-step phase costs on this instance and these shapes.

    Returns {"bound": s/step, "step": s/step, "compact": s/step,
    "per_eval": s/eval}. `state` is any seeded pool state; a copy of it is
    run a few steps first (the caller's state is untouched), so that the
    timed pops see realistic depths."""
    from ..engine import device
    from ..ops import batched

    dev = state.prmu.device
    warm = device.run(tables, _clone(state), lb_kind, chunk,
                      max_iters=warm_iters, tile=tile)
    if device.counters(warm).size < 1:
        warm = _clone(state)              # tiny instance: the seed
    K = max(reps, CUDA_REPS) if dev.type == "cuda" else reps

    def timed_bound(kind):
        # K pops at K window offsets, each result consumed
        def loop():
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(K):
                s = warm._replace(size=(warm.size - i * 128).clamp(min=1))
                acc += _pop_and_bound(tables, s, kind, chunk,
                                      tile).sum(dtype=torch.float32)
            return acc
        if dev.type == "cuda":
            return _graph_seconds(loop, dev) / K
        _pop_and_bound(tables, warm, kind, chunk, tile)   # first call
        return _seconds(loop, dev) / K

    J = state.prmu.shape[0]
    M = tables.p.shape[0]
    P = int(tables.ma0.shape[0])
    route, _, _ = device.lb2_route(J, M, P, chunk, tile,
                                   on_cuda=dev.type == "cuda")
    if lb_kind == 2 and route == "prefilter":
        # the prefilter route prunes by LB1 first, then sweeps the head
        # pairs over about N/4 candidates and the tail pairs over the
        # survivors (about 5N/64 at ta021's steady state): the timed dense
        # sweep over the whole grid is scaled by that tier fraction
        t1 = timed_bound(1)
        t2 = max(timed_bound(2), t1)
        KH = batched.PAIR_PREFILTER
        frac = (0.25 * min(KH, P) / P + (5 / 64) * max(P - KH, 0) / P)
        t_bound = t1 + (t2 - t1) * frac
    else:
        t_bound = timed_bound(lb_kind)
    # the full step: K live steps of the real loop, after one step that
    # captures its graph outside the window
    start = device.counters(warm).iters
    out = [device.run(tables, warm, lb_kind, chunk, max_iters=start + 1,
                      tile=tile)]

    def steps():
        out.append(device.run(tables, out[0], lb_kind, chunk,
                              max_iters=start + 1 + K, tile=tile))

    secs = _seconds(steps, dev)
    did = max(device.counters(out[-1]).iters - start - 1, 1)
    t_step = max(secs / did, t_bound)
    return {"bound": t_bound, "step": t_step, "compact": t_step - t_bound,
            "per_eval": t_bound / float(chunk * J)}


def profile_balance(states: list, transfer_cap: int, min_transfer: int,
                    limit: int, reps: int = 3) -> float:
    """Seconds of one balance round over the worker list
    (`distributed._balance_round`; the reference's `time_load_bal`,
    PFSP_statistic.c:123-167). The rounds write the given pools."""
    from ..engine import distributed

    dev = states[0].prmu.device
    on = torch.ones((), dtype=torch.bool, device=dev)

    def rounds():
        for _ in range(reps):
            distributed._balance_round(states, transfer_cap, min_transfer,
                                       limit, on)

    distributed._balance_round(states, transfer_cap, min_transfer, limit, on)
    return _seconds(rounds, dev) / reps


def attribute(prof: dict, elapsed: float, evals, iters,
              balance_rounds: int = 0, t_balance: float = 0.0) -> dict:
    """Per-worker wall-clock attribution (see the module docstring).

    `evals`/`iters` are (D,) arrays (or scalars for one device); returns
    {"kernel_time", "gen_child_time", "balance_time", "idle_time"} as
    (D,) float arrays that sum to elapsed unless the measured phases
    exceed it (idle is clipped at 0)."""
    evals = np.atleast_1d(np.asarray(evals, dtype=float))
    iters = np.broadcast_to(
        np.atleast_1d(np.asarray(iters, dtype=float)), evals.shape)
    kernel = evals * prof["per_eval"]
    compact = iters * prof["compact"]
    balance = np.full_like(kernel, balance_rounds * t_balance)
    idle = np.clip(elapsed - kernel - compact - balance, 0.0, None)
    return {"kernel_time": kernel, "gen_child_time": compact,
            "balance_time": balance, "idle_time": idle}


def publish_attribution(att: dict, registry=None, **labels) -> None:
    """Publish an :func:`attribute` result into a metrics registry
    (obs/metrics, default: the process's) as
    ``tts_phase_seconds{phase=, worker=, ...labels}`` gauges, so that
    `/metrics` and the CSV row cannot disagree."""
    from ..obs import metrics as obs_metrics

    reg = registry if registry is not None else obs_metrics.default()
    g = reg.gauge("tts_phase_seconds",
                  "measured per-worker wall-clock phase attribution")
    for phase, arr in att.items():
        name = phase[:-5] if phase.endswith("_time") else phase
        for w, v in enumerate(np.atleast_1d(np.asarray(arr, float))):
            g.set(float(v), phase=name, worker=w, **labels)


def _balance_profile(args, p, workers: list, best: int, iters) -> tuple:
    """(seconds of one balance round, rounds run) for `pfsp -D` with
    balancing on: one round timed over pools seeded from the root, at a
    capacity whose usable-row limit leaves room for the D*transfer_cap
    receive block (grown, as `_DistDriver.seed` grows, never clamped)."""
    from .. import convert
    from ..engine import device, distributed as dist
    from ..ops import reference as ref

    jobs, machines = p.shape[1], p.shape[0]
    n_dev = len(workers)
    adt = device.aux_dtype(p)
    transfer_cap = dist.default_transfer_cap(args.chunk, jobs, machines,
                                             n_dev,
                                             aux_itemsize=adt.itemsize)

    def limit(c):
        return min(device.row_limit(c, args.chunk, jobs),
                   c - n_dev * transfer_cap)

    cap = args.capacity
    while limit(cap) < 1:
        cap *= 2
    fr = dist.Frontier(prmu=np.arange(jobs, dtype=np.int16)[None, :],
                       depth=np.zeros(1, np.int16), tree=0, sol=0, best=best)
    fr.aux = ref.prefix_front_remain(p, fr.prmu, fr.depth)[:, :machines] \
        .astype(convert.np_dtype(adt))
    arrays = dist._shard_frontier(fr, n_dev, jobs, best, limit(cap))
    states = [convert.state_from_numpy({f: a[d] for f, a in arrays.items()},
                                       dv, capacity=cap)
              for d, dv in enumerate(workers)]
    t_bal = profile_balance(states, transfer_cap, 2 * args.chunk, limit(cap))
    return t_bal, int(np.max(iters)) // max(1, args.balance_period)


def write_csv_with_phases(args, p, init_ub, workers: list, elapsed: float,
                          tree: int, sol: int, best: int,
                          per_device: dict) -> None:
    """Append the `pfsp --csv` row with MEASURED phase columns: the
    reference's single-device schema for one worker, its multi-device
    (intra-node) schema for several, its distributed schema for a
    `--multihost` job (`csv_stats`; `workers` are then this rank's, and
    `per_device` holds the job's). The unit costs are timed on the first
    worker's device at the run's instance, bound and chunk, and published
    as `tts_phase_seconds` gauges too; a multi-process job's balance round
    crosses the ranks and is not profiled (its column stays 0)."""
    from ..engine import device
    from ..ops import batched
    from ..parallel import mesh
    from . import csv_stats

    jobs = p.shape[1]
    ranks = mesh.process_count()
    n_dev = len(workers) * ranks
    att = {}
    try:
        dev = workers[0]
        tables = batched.make_tables(p, device=dev)
        pstate = device.init_state(jobs, args.capacity, init_ub, p_times=p,
                                   telemetry=args.search_telemetry or None,
                                   device=dev)
        prof = profile_phases(tables, pstate, args.lb, args.chunk)
        evals = per_device.get("evals", [0] * n_dev)
        iters = per_device.get("iters",
                               [max(1, int(e)) // (args.chunk * jobs)
                                for e in evals])
        t_bal, rounds = 0.0, 0
        if n_dev > 1 and (args.ws or args.L) and ranks == 1:
            t_bal, rounds = _balance_profile(args, p, workers, best, iters)
        att = attribute(prof, elapsed, evals, iters, balance_rounds=rounds,
                        t_balance=t_bal)
        publish_attribution(att, inst=args.inst, lb=args.lb)
        per_device = {**per_device,
                      **{k: list(v) for k, v in att.items()}}
    except Exception as e:  # noqa: BLE001 — profiling never eats the row
        print(f"warning: phase profiling failed ({e!r}); writing zero "
              "timing columns", file=sys.stderr)

    if n_dev == 1:
        csv_stats.write_single(
            args.csv, args.inst, args.lb, best, args.m, args.M, elapsed,
            float(att["kernel_time"][0]) if att else elapsed, tree, sol,
            gen_child_time=float(att["gen_child_time"][0]) if att else 0.0)
    elif ranks > 1:
        # the multi-process tier: the reference's dist_multigpu.csv schema
        # (PFSP_statistic.c:123-167), its comm_size the process count
        csv_stats.write_dist(args.csv, args.inst, args.lb, n_dev, args.C,
                             args.L, ranks, best, args.m, args.M, args.T,
                             elapsed, tree, sol, per_device)
    else:
        # one process driving several workers is the intra-node tier: the
        # reference's multigpu.csv schema (PFSP_statistic.c:69-112)
        csv_stats.write_multi(args.csv, args.inst, args.lb, n_dev, args.C,
                              args.ws, best, args.m, args.M, args.T,
                              elapsed, tree, sol, per_device)
