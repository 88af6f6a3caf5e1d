"""Command line of the port: the `pfsp`, `nqueens`, `solve`, `devices`,
`serve`, `client`, `journey`, `profile`, `doctor` and `capacity`
subcommands, on one device or on several workers (`-D`).

Reproduces these paths of `tpu_tree_search/cli.py`:
`run_pfsp` -> `device.search`, and with `--segment-iters` or
`--checkpoint` `_run_pfsp_segmented` -> `checkpoint.run_segmented`, which
runs the search in bounded segments with a `[segment k]` heartbeat line,
checkpoints (the JAX package's file: either package resumes the other's),
resume from a checkpoint (a stacked multi-device one collapses onto this
device), `--grow-capacity` after an overflow, retries, a watchdog and
fault injection (`--faults`, or `TTS_FAULTS`); the output lines and exit
codes are the JAX CLI's. Runs on `cuda` unless `--device cpu` is given;
on the card it takes the fused route (`ops/fused.py`) where that applies.
`--search-telemetry` (or `TTS_SEARCH_TELEMETRY=1`) gives the state the
search-telemetry vector (`engine/telemetry.py`) and prints its summary as
one JSON line after the results; the other output lines are the same
either way.

`nqueens` (`run_nqueens` -> `problems.nqueens.search`) and `solve`
(`run_solve` -> `device.solve`, any registered problem, an instance from
`-i`, `--size`/`--seed` or `--instance-json`) print the JAX CLI's lines
and JSON fields, with "GPU" for "TPU".

`-D n` above 1 runs the multi-worker search (`engine/distributed.py`,
the JAX CLI's distributed branches): on the card it needs n visible cards
and exits 2 naming the count otherwise; with `--device cpu` it runs n
workers on the CPU. `pfsp` and `nqueens` default to `-D 0`, as the JAX
CLI's do: every visible card, so a one-card host takes the single-device
route of `-D 1`, as does `--device cpu`; `solve` defaults to `-D 1`.
`devices` prints one line per visible card (its name, process, and
allocated and total memory; `utils/device_info.py`), in the JAX CLI's
format. `pfsp -D n` takes `-m` (the warm-up's nodes per worker),
`--balance-period`, `-w`/`-L` (`-w 0 -L 0` turns balancing off: no
surplus reaches the transfer threshold 2**30),
`--max-iters` as a ceiling on balance rounds, and with `--segment-iters`
or `--checkpoint` prints a `[segment k]` line with per-worker sizes and
steals; its checkpoint is the stacked one either package resumes. With
`TTS_LADDER=1` such a segmented run switches between chunk rungs at its
segment boundaries (`engine/ladder.py`; the JAX CLI has no flag for it on
`pfsp` either), and with `TTS_OVERLAP=1` it runs on the overlapped segment
driver (the next segment dispatched before the last one's counters are
read, checkpoints written on a thread; `distributed.search` reads the flag,
as in the JAX CLI, which has no `pfsp` flag for it).

`serve` runs the search server (`service/server.py`) over a file spool
and `client` drops one request into it and waits (JAX `run_serve`,
`run_client`): `serve --device cpu -D n` serves on n CPU workers, on the
card every visible card (or `-D` of them), partitioned into `--submeshes`.
`--prewarm`, `--megabatch`, `--remediate`, `--overlap`, `--ladder`,
`--tune-cache` and the drain on SIGTERM work as in JAX, and so do the
durability flags: `--ledger DIR` (the request ledger, replayed at boot; the
workdir defaults to `DIR/workdir`), `--fleet-dir F` (a fenced lease on the
ledger and a watcher over the peers' leases under F) and `--failover`
(adopt an expired peer's ledger), with JAX's `ledger:` and `failover:`
banner lines; a server that boots fenced serves nothing and exits 0, as
does a SIGTERM drain. `client --portfolio K` races K configurations.
`--http-port N` (0: ephemeral) puts the HTTP front end (`obs/httpd.py`)
before the server, bound to `--http-host`, and prints JAX's
`observability: <url>/healthz ...` line; `--otel-endpoint URL` exports the
flight recorder as OTLP at shutdown (`obs/otel.py`) and with
`--otel-interval-s N` every N seconds too, printing JAX's `otel:` lines;
`--profile-dir` is the root of `POST /profile` captures. `--aot-cache`
exits 1 naming ROADMAP A9d.

`profile` (JAX `run_profile`) warms the single-device loop (`device.run`,
`--warm` steps), traces `--iters` more through the process's one profiler
(`obs/profiler.py`) and prints JAX's JSON line (`artifact`, `inst`, `lb`,
`iters`, `evals`, `device_self_ms`, `buckets_ms`) and the top ops by self
time: the card's ops on the card, the CPU ops with `--device cpu`.
`doctor URL...` scrapes servers' front ends (`obs/aggregate.py`) and
prints the fleet's verdict, exit 0 healthy, 1 unhealthy or unreachable
(or down with its lease held), 2 (`DOCTOR_TAKEOVER_EXIT_CODE`) for a lease
in `--fleet-dir` that expired unreleased; `--dashboard` and
`--metrics-out` write the fleet's HTML page and Prometheus text.
`capacity URL...` prints each server's `/capacity` document, exit 1 when
one is unreachable.

`journey --ledger DIR` (repeatable) and/or `--fleet-dir F` prints one
stitched timeline per logical request across restarts and takeovers
(`obs/journey.py`, JAX `run_journey`): `--tag T` filters, `--json` prints
the machine form, exit 2 without a directory and 1 when a tag matches
nothing. It only reads files and starts nothing on the card.

`--multihost` (before the subcommand) joins a `torch.distributed` job of
several processes, one per card or several sharing one, from the
environment `python -m torch.distributed.run` sets (gloo backend;
`parallel/mesh.py`): `-D` counts the job's workers (0: one a process) and
must divide evenly across the processes (exit 2 otherwise), each process
drives its share, every process prints the job's results, and rank 0
alone writes the checkpoint and the `--csv` row, in the reference's
distributed schema (`csv_stats.write_dist`).

`pfsp -C 1` runs the host tier (`engine/hybrid.py`) beside the device
search on every driver, in the JAX CLI's branch order: with `-D` above 1
inside `distributed.search`; segmented, beside `_run_pfsp_segmented`'s
segments (its seed rides the checkpoint, and a resume with or without
`-C` loses no node); else `hybrid.search`, where `-m` is the pool size
below which the host drains the device's residue and `--max-iters` exits
2. `--host-fraction` (default 8) and `--host-threads` (default: the
host's cores over the workers) tune it; on the card the device part runs
on the card. `--csv` appends the reference's CSV row
(`utils/csv_stats.py`) with measured phase-time columns
(`utils/phase_timing.py`); `-M`, `-T` and `-p` feed only that schema.

    python -m tpu_tree_search_torch pfsp -i 3 -l 2 -u 1
    python -m tpu_tree_search_torch nqueens -N 15 --chunk 65536
    python -m tpu_tree_search_torch solve --problem knapsack --size 1000 -l 2
    python -m tpu_tree_search_torch pfsp -i 14 -l 2 --segment-iters 8 \\
        --checkpoint c.npz --max-iters 16     # then again, to resume
    python -m tpu_tree_search_torch pfsp -i 3 -l 2 -u 1 --device cpu -D 4
    TTS_LADDER=1 python -m tpu_tree_search_torch pfsp -i 14 -l 2 -u 1 \
        --chunk 4096 --device cpu -D 4 --segment-iters 8
    TTS_OVERLAP=1 python -m tpu_tree_search_torch pfsp -i 3 -l 2 -u 1 \\
        --device cpu -D 4 --segment-iters 64 --checkpoint c3.npz
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m tpu_tree_search_torch --multihost pfsp -i 14 -l 2 -u 1 -D 4
    python -m tpu_tree_search_torch pfsp -i 8 -l 2 -u 1 --chunk 65536 -C 1 \\
        --csv runs.csv
    python -m tpu_tree_search_torch serve --spool sp --idle-exit 30 &
    python -m tpu_tree_search_torch client --spool sp -i 3 -l 2 \\
        --chunk 16384
    python -m tpu_tree_search_torch serve --spool sp --ledger L &
    python -m tpu_tree_search_torch journey --ledger L --tag T
    python -m tpu_tree_search_torch serve --spool sp --http-port 0 &
    python -m tpu_tree_search_torch doctor http://127.0.0.1:PORT
    python -m tpu_tree_search_torch profile -i 21 -l 2 --chunk 65536 \\
        --capacity 4194304 --warm 64 --iters 64
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

from .tune.defaults import CLI_CHUNK_DEFAULT
from .utils import config as _cfg


def _print_pfsp_settings(args, machines: int, jobs: int, device,
                         n_dev: int = 1) -> None:
    print("=" * 49)
    balancing = (f" - balancing [{int(bool(args.ws or args.L))}]"
                 if n_dev > 1 else "")
    print(f"GPU B&B ({n_dev} device(s) - {device}{balancing})")
    print(f"Resolution of PFSP Taillard's instance: ta{args.inst} "
          f"(m = {machines}, n = {jobs})")
    print("Initial upper bound: " + ("opt" if args.ub == 1 else "inf"))
    print("Lower bound function: " + {0: "lb1_d", 1: "lb1", 2: "lb2"}[args.lb])
    print("Branching rule: fwd")
    print("=" * 49)


def _print_results(optimum: int, tree: int, sol: int, elapsed: float,
                   complete: bool = True) -> None:
    print("=" * 49)
    print(f"Size of the explored tree: {tree}")
    print(f"Number of explored solutions: {sol}")
    label = ("Optimal makespan" if complete
             else "Best makespan found (truncated run)")
    print(f"{label}: {optimum}")
    print(f"Elapsed time: {elapsed:.4f} [s]")
    print("=" * 49)


def _host_tier(args, n_dev: int) -> tuple[int, int]:
    """(host_fraction, host_threads) of `-C`: fraction 8 and the host's
    cores over the workers by default (the reference's
    num_procs/deviceCount rule, pfsp_multigpu_cuda.c:61-69); (0, 0)
    without `-C`."""
    if not args.C:
        return 0, 0
    fraction = 8 if args.host_fraction is None else max(args.host_fraction, 0)
    threads = (max(1, (os.cpu_count() or 1) // max(n_dev, 1))
               if args.host_threads is None else max(args.host_threads, 1))
    return fraction, threads


def run_pfsp(args) -> int:
    from .engine import device
    from .parallel import mesh
    from .problems import taillard
    from .utils import faults

    dev = device.resolve_device(args.device)
    workers = _workers(args.D, dev)
    if workers is None:
        return 2
    n_dev = _job_size(workers)
    p = taillard.processing_times(args.inst)
    jobs, machines = p.shape[1], p.shape[0]
    if args.capacity is None:
        args.capacity = device.default_capacity(jobs, machines)
    init_ub = taillard.optimal_makespan(args.inst) if args.ub == 1 else None
    host_fraction, host_threads = _host_tier(args, n_dev)
    segmented = args.segment_iters is not None or args.checkpoint is not None
    if n_dev == 1 and args.C and not segmented \
            and args.max_iters is not None:
        print("error: --max-iters is not supported with -C 1",
              file=sys.stderr)
        return 2
    _print_pfsp_settings(args, machines, jobs, dev, n_dev)
    t0 = time.perf_counter()
    # the fault plan is this call's (an in-process caller keeps its own)
    with (faults.scoped(args.faults) if args.faults
          else contextlib.nullcontext()):
        try:
            run = _run_pfsp_paths(args, p, init_ub, workers, host_fraction,
                                  host_threads, segmented)
        except (RuntimeError, ValueError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    tree, sol, best, complete, summary, per_device = run
    elapsed = time.perf_counter() - t0
    _print_results(best, tree, sol, elapsed, complete=complete)
    if summary is not None:
        print("Search telemetry: " + json.dumps(summary))
    if args.csv and mesh.process_index() == 0:
        # rank 0 alone writes the row of a --multihost job
        from .utils import phase_timing
        phase_timing.write_csv_with_phases(args, p, init_ub, workers,
                                           elapsed, tree, sol, best,
                                           per_device)
    return 0


def _run_pfsp_paths(args, p, init_ub, workers, host_fraction: int,
                    host_threads: int, segmented: bool):
    """The `pfsp` search on the path the flags pick (the JAX CLI's branch
    order): several workers -> `distributed.search`; one, segmented ->
    `_run_pfsp_segmented`; one with `-C` -> `hybrid.search`; else
    `device.search`. Returns (tree, sol, best, complete, telemetry
    summary, per-worker counters for the CSV row)."""
    from .engine import device, hybrid, telemetry

    dev = workers[0]
    if _job_size(workers) > 1:
        res = _run_pfsp_distributed(args, p, init_ub, workers,
                                    host_fraction, host_threads)
        return (res.explored_tree, res.explored_sol, res.best, res.complete,
                res.telemetry,
                {k: list(v) for k, v in res.per_device.items()})
    if segmented:
        out, extras = _run_pfsp_segmented(args, p, init_ub, dev,
                                          host_fraction, host_threads)
        c = device.counters(out)
        best = c.best if extras["best"] is None else min(c.best,
                                                         extras["best"])
        per_device = {"tree": [c.tree], "sol": [c.sol], "evals": [c.evals],
                      "iters": [c.iters], "steals": [0], "recv": [0],
                      **extras["host"]}
        return (c.tree + extras["tree"], c.sol + extras["sol"], best,
                c.size == 0, telemetry.summarize(out.telemetry), per_device)
    if args.C:
        # -C 1 on one device: native warm-up, the device loop while the
        # pool feeds >= -m parents, the host session beside it and a
        # native drain of the residue (pfsp_multigpu_cuda.c's CPU tier)
        res = hybrid.search(p, lb_kind=args.lb, init_ub=init_ub,
                            chunk=args.chunk, capacity=args.capacity,
                            drain_min=max(args.m, 1),
                            host_fraction=host_fraction,
                            host_threads=host_threads, device=dev,
                            telemetry=args.search_telemetry or None)
        return (res.explored_tree, res.explored_sol, res.best, res.complete,
                res.telemetry, res.per_device)
    res = device.search(p, lb_kind=args.lb, init_ub=init_ub,
                        chunk=args.chunk, capacity=args.capacity,
                        max_iters=args.max_iters, device=dev,
                        telemetry=args.search_telemetry or None)
    return (res.explored_tree, res.explored_sol, res.best, res.complete,
            res.telemetry,
            {"tree": [res.explored_tree], "sol": [res.explored_sol],
             "evals": [res.evals], "iters": [res.iters], "steals": [0],
             "recv": [0]})


def _run_pfsp_segmented(args, p, init_ub, dev, host_fraction: int = 0,
                        host_threads: int = 0):
    """Segmented single-device search with heartbeat + checkpoint/resume
    (the JAX CLI's `_run_pfsp_segmented`). With `host_fraction > 0` a
    native `-C` host session runs beside the segments, seeded from a
    warm-up share (fresh) or the checkpoint's saved share (else rows
    carved off the pool) on a resume, merging incumbents at every segment
    boundary (`engine/hybrid.HostSession`); a resume without `-C` pushes a
    saved share back into the pool.

    Returns (state, extras): the warm-up's and the host tier's tree and
    sol to add to the device totals, the host's best (None without a
    session) and its per-worker counters for the CSV row."""
    from . import problems
    from .engine import checkpoint, device, distributed, hybrid
    from .ops import batched

    jobs = p.shape[1]
    tables = batched.make_tables(p, device=dev)
    session = None
    warm_tree = warm_sol = 0
    h_prmu = np.zeros((0, jobs), np.int16)
    h_depth = np.zeros(0, np.int16)
    if args.checkpoint and checkpoint.resume_path(args.checkpoint):
        # a torn snapshot rolls back to its last-good sibling; a stacked
        # snapshot collapses onto this device
        state, meta, _ = checkpoint.load_resilient(args.checkpoint,
                                                   p_times=p, device=dev)
        state = checkpoint.collapse_to_single_device(state, args.chunk, jobs,
                                                     device=dev)
        if args.grow_capacity:
            state = checkpoint.grow(state, args.grow_capacity)
        warm_tree = int(meta.get("warmup_tree", 0))
        warm_sol = int(meta.get("warmup_sol", 0))
        state, session, h_prmu, h_depth = hybrid.resume_share(
            state, meta, problems.get("pfsp"), p, args.lb, host_fraction,
            host_threads)
        c = device.counters(state)
        print(f"Resumed from {args.checkpoint} "
              f"(segment {int(meta.get('segment', 0))}, "
              f"iters {c.iters}, pool {c.size})")
    elif host_fraction > 0:
        # the host tier needs real nodes: a native warm-up frontier, split
        # by stride as hybrid.search splits it
        fr = distributed.bfs_warmup(p, args.lb, init_ub,
                                    target=4 * host_fraction)
        best0 = fr.best if init_ub is None else min(fr.best, int(init_ub))
        warm_tree, warm_sol = fr.tree, fr.sol
        dmask, h_prmu, h_depth = hybrid.split_host_share(
            fr.prmu, fr.depth, host_fraction)
        if len(h_depth):
            session = hybrid.HostSession(p, h_prmu, h_depth, args.lb, best0,
                                         n_threads=host_threads)
        state = device.init_state(jobs, args.grow_capacity or args.capacity,
                                  best0, prmu0=fr.prmu[dmask],
                                  depth0=fr.depth[dmask], p_times=p,
                                  telemetry=args.search_telemetry or None,
                                  device=dev)
    else:
        state = device.init_state(jobs, args.grow_capacity or args.capacity,
                                  init_ub, p_times=p,
                                  telemetry=args.search_telemetry or None,
                                  device=dev)

    def run_fn(s, target):
        return device.run(tables, s, args.lb, args.chunk, max_iters=target)

    def heartbeat(r):
        print(f"[segment {r.segment}] iters={r.iters} tree={r.tree} "
              f"sol={r.sol} best={r.best} pool={r.pool_size} "
              f"t={r.elapsed:.2f}s")

    out = checkpoint.run_segmented(
        run_fn, state, segment_iters=args.segment_iters or 2048,
        checkpoint_path=args.checkpoint, heartbeat=heartbeat,
        checkpoint_every=args.checkpoint_every,
        max_total_iters=args.max_iters,
        checkpoint_meta={"warmup_tree": warm_tree, "warmup_sol": warm_sol,
                         "host_prmu": (h_prmu if session else
                                       np.zeros((0, jobs), np.int16)),
                         "host_depth": (h_depth if session else
                                        np.zeros(0, np.int16))},
        post_segment=session.post_segment if session else None,
        retry_attempts=args.retry_attempts,
        segment_timeout_s=args.segment_timeout)

    extras = {"tree": warm_tree, "sol": warm_sol, "best": None, "host": {}}
    if session is not None:
        h_tree, h_sol, best, extras["host"] = hybrid.finish(
            session, device.counters(out).best)
        extras.update(tree=warm_tree + h_tree, sol=warm_sol + h_sol,
                      best=best)
    return out, extras


def _run_pfsp_distributed(args, p, init_ub, workers, host_fraction: int = 0,
                          host_threads: int = 0):
    """The JAX CLI's distributed branches: `distributed.search` over the
    workers (with the `-C` host tier beside them when `host_fraction > 0`),
    segmented (a `[segment k]` line with per-worker sizes and steals,
    stacked checkpoint and resume) when `--segment-iters` or
    `--checkpoint` is given."""
    from .engine import distributed

    if args.grow_capacity:
        raise ValueError("--grow-capacity re-homes a one-device checkpoint; "
                         "a -D run grows every pool on overflow by itself")

    def heartbeat(r):
        pw = (f" sizes={r.per_worker['size']}"
              f" steals={r.per_worker['steals']}" if r.per_worker else "")
        print(f"[segment {r.segment}] iters={r.iters} tree={r.tree} "
              f"sol={r.sol} best={r.best} pool={r.pool_size}{pw} "
              f"t={r.elapsed:.2f}s")

    return distributed.search(
        p, lb_kind=args.lb, init_ub=init_ub, devices=workers,
        chunk=args.chunk, capacity=args.capacity,
        balance_period=args.balance_period,
        # balancing off (-w 0 -L 0): no surplus reaches the threshold, so
        # every plan is empty while the loop condition still runs
        min_transfer=None if (args.ws or args.L) else 2**30,
        min_seed=args.m, max_rounds=args.max_iters,
        segment_iters=args.segment_iters, checkpoint_path=args.checkpoint,
        heartbeat=heartbeat, checkpoint_every=args.checkpoint_every,
        telemetry=args.search_telemetry or None,
        retry_attempts=args.retry_attempts,
        segment_timeout_s=args.segment_timeout,
        host_fraction=host_fraction, host_threads=host_threads)


def _job_size(workers: list) -> int:
    """The job's workers: this process's, times the processes of a
    `--multihost` job."""
    from .parallel import mesh

    return len(workers) * mesh.process_count()


def _workers(D: int, dev) -> list | None:
    """This process's worker devices of the `-D` the command asks for: on
    the card, D visible cards (0: every one, and on a one-card host the
    single-device route `-D 1` takes, on `dev`); on the CPU, D workers on
    the CPU (0: one); in a `--multihost` job, its equal share of D (0: one
    a process; `mesh.local_worker_devices`). None after printing why they
    are not there."""
    from .parallel import mesh

    if mesh.process_count() > 1:
        try:
            return mesh.local_worker_devices(D or mesh.process_count(), dev)
        except ValueError as e:
            print(f"error: -D {D}: {e}", file=sys.stderr)
            return None
    if D == 1:
        return [dev]
    try:
        if dev.type == "cuda":
            cards = mesh.worker_devices(D if D > 0 else None)
            return [dev] if len(cards) == 1 else cards
        return mesh.worker_devices(devices=[dev] * max(D, 1))
    except ValueError as e:
        print(f"error: -D {D}: {e} (visible CUDA devices)", file=sys.stderr)
        return None


def run_nqueens(args) -> int:
    from .engine import device
    from .problems import nqueens as nq

    dev = device.resolve_device(args.device)
    workers = _workers(args.D, dev)
    if workers is None:
        return 2
    print("=" * 49)
    print(f"GPU N-Queens ({_job_size(workers)} device(s))")
    print(f"Resolution of the {args.N}-Queens instance")
    print(f"  with {args.g} safety check(s) per evaluation")
    print("=" * 49)
    t0 = time.perf_counter()
    if _job_size(workers) == 1:
        out = nq.search(args.N, g=args.g, chunk=args.chunk,
                        capacity=args.capacity, device=dev)
    else:
        out = nq.search_distributed(args.N, g=args.g, chunk=args.chunk,
                                    capacity=args.capacity, devices=workers)
    elapsed = time.perf_counter() - t0
    print("=" * 49)
    print(f"Size of the explored tree: {out.explored_tree}")
    print(f"Number of explored solutions: {out.explored_sol}")
    print(f"Elapsed time: {elapsed:.4f} [s]")
    print("=" * 49)
    return 0


def _problem_instance_args(p) -> None:
    """Instance flags of `solve`: a problem name and one instance
    source, a Taillard id (PFSP only), a synthetic --size/--seed, or a
    table from a JSON file."""
    p.add_argument("--problem", type=str, default="pfsp",
                   help="workload plugin (problems/base.py): pfsp | "
                        "nqueens | tsp | knapsack")
    p.add_argument("-i", "--inst", type=int, default=None,
                   help="Taillard instance id (PFSP only)")
    p.add_argument("--size", type=int, default=None,
                   help="synthetic instance size: jobs (pfsp), board "
                        "n (nqueens), cities (tsp), items (knapsack)")
    p.add_argument("--machines", type=int, default=5,
                   help="machines for a synthetic PFSP --size instance")
    p.add_argument("--seed", type=int, default=0,
                   help="synthetic instance seed")
    p.add_argument("--instance-json", type=str, default=None,
                   help="path to a JSON 2-D instance table (the "
                        "problem's table format, problems/base.py)")


def _solve_instance_table(args) -> np.ndarray:
    """The instance table from the flags (--inst, else --instance-json,
    else a --size synthetic)."""
    if args.inst is not None:
        if args.problem != "pfsp":
            raise SystemExit("--inst (a Taillard id) is PFSP-only; "
                             "use --size or --instance-json")
        from .problems import taillard
        return taillard.processing_times(args.inst)
    if args.instance_json:
        with open(args.instance_json) as f:
            return np.asarray(json.load(f), np.int32)
    if args.size is None:
        raise SystemExit("pick an instance: -i (pfsp), --size or "
                         "--instance-json")
    n, seed = args.size, args.seed
    if args.problem == "pfsp":
        from .problems.pfsp import PFSPInstance
        return PFSPInstance.synthetic(jobs=n, machines=args.machines,
                                      seed=seed).p_times
    if args.problem == "nqueens":
        from .problems import nqueens as nq
        return nq.table(n)
    if args.problem == "tsp":
        from .problems.tsp import TSPInstance
        return TSPInstance.synthetic(n, seed).d
    if args.problem == "knapsack":
        from .problems.knapsack import KnapsackInstance
        return KnapsackInstance.synthetic(n, seed).table
    raise SystemExit(f"no synthetic builder for problem "
                     f"{args.problem!r}; use --instance-json")


def run_solve(args) -> int:
    from . import problems
    from .engine import device, distributed

    try:
        prob = problems.get(args.problem)
    except KeyError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    dev = device.resolve_device(args.device)
    workers = _workers(args.D, dev)
    if workers is None:
        return 2
    table = _solve_instance_table(args)
    reason = prob.validate(table)
    if reason is not None:
        print(f"error: invalid instance: {reason}", file=sys.stderr)
        return 2
    lb = prob.default_lb if args.lb is None else args.lb
    # -u is in objective units; the engine minimizes (knapsack: -value)
    init_ub = None if args.ub is None else prob.engine_objective(args.ub)
    print("=" * 49)
    print(f"GPU B&B problem={prob.name} shape="
          f"{'x'.join(map(str, table.shape))} lb={lb} D={args.D}")
    print("=" * 49)
    t0 = time.perf_counter()
    if _job_size(workers) == 1:
        out = device.solve(prob, table, lb_kind=lb, init_ub=init_ub,
                           chunk=args.chunk, capacity=args.capacity,
                           max_iters=args.max_iters, device=dev)
    else:
        out = distributed.search(
            table, problem=prob, lb_kind=lb, init_ub=init_ub,
            devices=workers, chunk=args.chunk,
            capacity=args.capacity or prob.default_capacity(table),
            max_rounds=args.max_iters)
    elapsed = time.perf_counter() - t0
    print(json.dumps({
        "problem": prob.name, "explored_tree": out.explored_tree,
        "explored_sol": out.explored_sol, "best": int(out.best),
        "objective": prob.display_objective(out.best),
        "complete": bool(out.complete), "elapsed_s": round(elapsed, 4)}))
    return 0


def _serve_args(sub) -> None:
    """The `serve` command's flags (JAX `cli.py` `_serve_parser`), with
    `--device` and `-D`."""
    p = sub.add_parser(
        "serve",
        help="run the search server over a file spool (service/: submesh "
             "scheduling, priority preemption, loop reuse)")
    p.add_argument("--spool", type=str, required=True,
                   help="directory watched for <id>.req.json request "
                        "files; results land beside them as <id>.res.json "
                        "(service/spool.py)")
    p.add_argument("--submeshes", type=int,
                   default=_cfg.env_int("TTS_SUBMESHES"),
                   help="partition the workers into this many equal "
                        "submeshes, one concurrent request each (must "
                        "divide the worker count; TTS_SUBMESHES)")
    p.add_argument("-D", type=int, default=0,
                   help="workers: on the card, visible cards (0, the "
                        "default: all); with --device cpu, workers on the "
                        "CPU (0: one a submesh)")
    p.add_argument("--workdir", type=str, default=None,
                   help="checkpoint directory for preempted and deadline "
                        "requests (default: <ledger>/workdir with "
                        "--ledger, else a fresh temp dir)")
    p.add_argument("--queue-depth", type=int,
                   default=_cfg.env_int("TTS_QUEUE_DEPTH"),
                   help="admission bound: requests beyond it are rejected "
                        "with a reason, not buffered")
    p.add_argument("--segment-iters", type=int,
                   default=_cfg.SERVICE_SEGMENT_ITERS_DEFAULT,
                   help="segment length between stop checks (the reaction "
                        "time of preemption, deadlines and cancels)")
    p.add_argument("--idle-exit", type=float, default=None,
                   help="exit after this many seconds with no queued or "
                        "running work (default: serve forever)")
    p.add_argument("--status-every", type=float, default=30.0,
                   help="print a JSON status snapshot every N seconds "
                        "(0 disables)")
    p.add_argument("--http-port", type=int, default=None,
                   help="start the HTTP front end (obs/httpd: /healthz "
                        "/metrics /status /trace /alerts /capacity "
                        "/dashboard /journey, POST /submit /cancel "
                        "/profile) on this port (0: ephemeral, printed at "
                        "startup; default: off)")
    p.add_argument("--http-host", type=str, default="127.0.0.1",
                   help="bind address for --http-port (default loopback; "
                        "0.0.0.0 exposes it)")
    p.add_argument("--trace-file", type=str, default=None,
                   help="append the flight recorder's log to this JSONL "
                        "file (also via TTS_TRACE_FILE)")
    p.add_argument("--phase-metrics", action="store_true",
                   help="measure per-phase unit costs once per request "
                        "shape and publish tts_phase_seconds gauges")
    p.add_argument("--search-telemetry", action="store_true",
                   help="keep the search-telemetry vector in every served "
                        "search (also via TTS_SEARCH_TELEMETRY=1)")
    p.add_argument("--otel-endpoint", type=str, default=None,
                   help="export the flight recorder's ring as OTLP spans to "
                        "this OTLP/HTTP traces URL at shutdown "
                        "(obs/otel.py; needs the opentelemetry SDK, "
                        "without it one warning and nothing exported)")
    p.add_argument("--otel-interval-s", type=float, default=0.0,
                   help="also flush the ring to --otel-endpoint every N "
                        "seconds while serving (each flush ships only "
                        "records newer than the last; <= 0: at shutdown "
                        "only)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="artifact root of POST /profile captures "
                        "(obs/profiler; a subdirectory a capture; default: "
                        "<workdir>/profiles)")
    p.add_argument("--resource-sample-s", type=float, default=None,
                   help="memory sampler period in seconds (default 1.0, "
                        "also via TTS_RESOURCE_SAMPLE_S; <= 0 disables)")
    p.add_argument("--health-interval-s", type=float, default=None,
                   help="health rules' evaluation period in seconds "
                        f"(default {_cfg.OBS_HEALTH_INTERVAL_S_DEFAULT}, "
                        "also via TTS_HEALTH_INTERVAL_S; <= 0 disables "
                        "the daemon)")
    p.add_argument("--overlap", action="store_true",
                   help="the overlapped segment driver for every request "
                        "(also via TTS_OVERLAP=1)")
    p.add_argument("--share-incumbent", action="store_true",
                   help="share incumbents across concurrent requests of "
                        "one instance (also via TTS_SHARE_INCUMBENT=1)")
    p.add_argument("--aot-cache", type=str, default=None,
                   help="the disk executor cache (ROADMAP A9d: refused)")
    p.add_argument("--tune-cache", type=str, default=None,
                   help="tuning-cache directory (also via TTS_TUNE_CACHE): "
                        "requests with open knobs resolve from it")
    p.add_argument("--tune", action="store_true",
                   help="with --prewarm: probe cold shapes at boot (also "
                        "via TTS_TUNE=1)")
    p.add_argument("--ladder", action="store_true",
                   help="chunk-ladder execution (also via TTS_LADDER=1)")
    p.add_argument("--megabatch", action="store_true",
                   help="request megabatching (also via TTS_MEGABATCH=1): "
                        "requests of one shape class run as one batch a "
                        "submesh (close at --batch-max members or "
                        "--batch-age-s; a lone request runs solo)")
    p.add_argument("--batch-max", type=int, default=None,
                   help="megabatch: close a batch at this many members "
                        f"(TTS_BATCH_MAX, default {_cfg.BATCH_MAX_DEFAULT})")
    p.add_argument("--batch-age-s", type=float, default=None,
                   help="megabatch: close a batch once its oldest member "
                        "has waited this long (TTS_BATCH_AGE_S, default "
                        f"{_cfg.BATCH_AGE_S_DEFAULT:g})")
    p.add_argument("--remediate", action="store_true",
                   help="execute the remediation policy table (also via "
                        "TTS_REMEDIATE=1; default: observe only)")
    p.add_argument("--ledger", type=str, default=None,
                   help="durable request-ledger directory (also via "
                        "TTS_LEDGER; service/ledger.py): every request "
                        "state transition is journaled (fsync'd, "
                        "CRC-stamped JSONL) before it is acknowledged, "
                        "and a restarted server replays it at boot: "
                        "queued and active requests are admitted again "
                        "with their budgets and resume from their "
                        "checkpoints, terminal results are served again, "
                        "quarantines and admission pauses are restored "
                        "(default workdir with it: <ledger>/workdir)")
    p.add_argument("--fleet-dir", type=str, default=None,
                   help="shared fleet root (also via TTS_FLEET_DIR; "
                        "service/lease.py, failover.py): a fenced lease "
                        "on the --ledger dir (TTL TTS_LEASE_TTL_S), every "
                        "ledger append and checkpoint save stamped with "
                        "its epoch, and a watcher over the peers' leases "
                        "under this root. Requires --ledger")
    p.add_argument("--failover", action="store_true",
                   help="adopt a peer's ledger when its lease expires "
                        "(also via TTS_FAILOVER=1): CAS its epoch, admit "
                        "its requests here, keep its lease so the stale "
                        "owner boots fenced. Default: observe only")
    p.add_argument("--drain-timeout", type=float, default=None,
                   help="SIGTERM/SIGINT drain budget in seconds (also via "
                        "TTS_DRAIN_TIMEOUT_S, default "
                        f"{_cfg.DRAIN_TIMEOUT_S_DEFAULT:g}): stop "
                        "admission, preempt running requests at segment "
                        "boundaries, exit 0; past it, exit "
                        f"{DRAIN_ESCALATE_EXIT_CODE}")
    p.add_argument("--prewarm", type=str, nargs="?", const="",
                   default=None, metavar="SPEC",
                   help="boot pre-warm (also via TTS_PREWARM): 'taillard', "
                        "'spool' and/or JxM entries, comma-separated; bare "
                        "--prewarm means 'spool,taillard'")
    _device_arg(p)
    p.set_defaults(fn=run_serve)


def _client_args(sub) -> None:
    """The `client` command's flags (JAX `cli.py` `_client_parser`)."""
    p = sub.add_parser(
        "client", help="submit one request to a running `serve` spool and "
                       "wait")
    p.add_argument("--spool", type=str, required=True)
    _problem_instance_args(p)
    p.add_argument("-l", "--lb", type=int, default=None,
                   help="bound kind (default: the problem's default)")
    p.add_argument("-u", "--ub", type=int, default=1, choices=(0, 1),
                   help="1: seed the incumbent with the known optimum "
                        "(Taillard -i instances only)")
    p.add_argument("--priority", type=int, default=0,
                   help="higher preempts lower on a full partition")
    p.add_argument("--deadline", type=float, default=None,
                   help="compute budget in seconds (accumulated execution "
                        "time, not queue wait)")
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--capacity", type=int, default=None)
    p.add_argument("--tag", type=str, default=None,
                   help="checkpoint tag; resubmitting a DEADLINE request's "
                        "tag with a larger budget extends it")
    p.add_argument("--portfolio", type=int, default=None, metavar="K",
                   help="bound-portfolio racing: fan out as K sibling "
                        "configurations (bound tiers, tuned chunk plans) "
                        "sharing one incumbent board; the first proof "
                        "wins, the losers cancel (service/portfolio.py)")
    p.add_argument("--timeout", type=float, default=None,
                   help="give up waiting for the result after N seconds")
    p.set_defaults(fn=run_client)


# the exit code of a drain past its budget (JAX's): apart from clean
# drains (0) and errors (1)
DRAIN_ESCALATE_EXIT_CODE = 70


def _install_drain_handlers(drain_evt, timeout_s: float) -> bool:
    """SIGTERM/SIGINT -> graceful drain (JAX `_install_drain_handlers`):
    set `drain_evt` (the serve loop exits and the server's close preempts
    at segment boundaries) and arm a timer that exits with
    DRAIN_ESCALATE_EXIT_CODE when the drain outlasts `timeout_s`; a second
    signal exits at once. False off the main thread."""
    import signal
    import threading

    def _escalate():
        from .obs import tracelog
        tracelog.event("server.drain_escalated", timeout_s=timeout_s)
        print(f"drain exceeded {timeout_s:g}s: checkpoint-and-abort",
              flush=True)
        os._exit(DRAIN_ESCALATE_EXIT_CODE)

    def _handler(signum, frame):
        if drain_evt.is_set():
            os._exit(DRAIN_ESCALATE_EXIT_CODE)
        print(f"signal {signum}: draining (budget {timeout_s:g}s)",
              flush=True)
        drain_evt.set()
        t = threading.Timer(timeout_s, _escalate)
        t.daemon = True
        t.start()
        drain_evt.watchdog = t

    try:
        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)
    except ValueError:      # not the main thread
        return False
    return True


def _serve_workers(args) -> list:
    """The server's workers: on the card `-D` visible cards (0: all), on
    the CPU `-D` CPU workers (0: one a submesh)."""
    from .engine import device
    from .parallel import mesh

    dev = device.resolve_device(args.device)
    if dev.type == "cuda":
        return mesh.worker_devices(args.D or None)
    return [dev] * (args.D or args.submeshes)


def run_serve(args) -> int:
    """The JAX `run_serve`: a `SearchServer` over the workers, fed by
    `spool.serve_spool` until idle or drained."""
    import threading

    from .engine.distributed import _not_ported
    from .obs import tracelog
    from .service import SearchServer, spool

    if args.aot_cache is not None:
        raise _not_ported("--aot-cache", "A9d", "serve")
    if args.search_telemetry:
        _cfg.set_env("TTS_SEARCH_TELEMETRY", "1")
    if args.overlap:
        _cfg.set_env(_cfg.OVERLAP_FLAG, "1")
    if args.share_incumbent:
        _cfg.set_env(_cfg.SHARE_INCUMBENT_FLAG, "1")
    if args.ladder:
        _cfg.set_env(_cfg.LADDER_FLAG, "1")
    if args.remediate:
        _cfg.set_env(_cfg.REMEDIATE_FLAG, "1")
    if args.megabatch:
        _cfg.set_env(_cfg.MEGABATCH_FLAG, "1")
    if args.fleet_dir:
        # the environment too: the lease and watcher layers resolve
        # TTS_FLEET_DIR at one site (the server constructor)
        _cfg.set_env(_cfg.FLEET_DIR_ENV, args.fleet_dir)
    if args.failover:
        _cfg.set_env(_cfg.FAILOVER_FLAG, "1")
    if args.trace_file:
        tracelog.get().set_sink(args.trace_file)
        print(f"flight recorder: {args.trace_file}", flush=True)
    # --ledger passes straight through: SearchServer resolves the
    # TTS_LEDGER fallback itself and, with a ledger and no --workdir,
    # keeps the checkpoints under <ledger>/workdir
    devices = _serve_workers(args)
    drain_evt = threading.Event()
    drain_timeout = (args.drain_timeout if args.drain_timeout is not None
                     else _cfg.env_float("TTS_DRAIN_TIMEOUT_S"))
    _install_drain_handlers(drain_evt, drain_timeout)
    httpd = None
    otel_exp = None
    otel_stop = None
    if args.otel_endpoint:
        from .obs import otel
        # ONE exporter for the interval flushes and the shutdown flush:
        # its seq watermark keeps a record from shipping twice
        otel_exp = otel.IncrementalExporter(endpoint=args.otel_endpoint)
        if args.otel_interval_s and args.otel_interval_s > 0:
            otel_stop = threading.Event()

            def _otel_tick():
                while not otel_stop.wait(args.otel_interval_s):
                    try:
                        otel_exp.flush(tracelog.get().records())
                    except Exception:  # noqa: BLE001 — a flaky
                        # collector must not kill the flusher; the next
                        # tick (same watermark) retries the same tail
                        pass
            threading.Thread(target=_otel_tick, name="otel-flush",
                             daemon=True).start()
            print(f"otel: flushing to {args.otel_endpoint} every "
                  f"{args.otel_interval_s:g}s", flush=True)
    try:
        with SearchServer(n_submeshes=args.submeshes, devices=devices,
                          workdir=args.workdir,
                          max_queue_depth=args.queue_depth,
                          segment_iters=args.segment_iters,
                          phase_profile=True if args.phase_metrics else None,
                          resource_sample_s=args.resource_sample_s,
                          health_interval_s=args.health_interval_s,
                          overlap=True if args.overlap else None,
                          share_incumbent=(True if args.share_incumbent
                                           else None),
                          tune_cache_dir=args.tune_cache,
                          tune_at_boot=True if args.tune else None,
                          remediate=True if args.remediate else None,
                          ledger_dir=args.ledger,
                          megabatch=True if args.megabatch else None,
                          batch_max=args.batch_max,
                          batch_age_s=args.batch_age_s) as srv:
            if srv.megabatch:
                print(f"megabatch: ON (max {srv.former.max_size}, "
                      f"age {srv.former.age_s:g}s)", flush=True)
            print(f"remediation: "
                  f"{'ACT' if srv.remediation.enabled else 'observe'}"
                  f"-mode (TTS_REMEDIATE)", flush=True)
            if srv.ledger is not None:
                led = srv.ledger.snapshot()
                rec = srv._recovered
                print(f"ledger: {led['dir']} (restart "
                      f"#{led['restarts']}, replayed "
                      f"{led['replayed']} record(s), recovered "
                      f"{rec['queued']}q/{rec['active']}a/"
                      f"{rec['held']}h/{rec['terminal']}t, "
                      f"truncated {led['truncated']})", flush=True)
            if srv.lease is not None or srv.fenced:
                mode = ("FENCED" if srv.fenced else
                        ("ACT" if srv.watcher is not None
                         and srv.watcher.act else "observe"))
                epoch = srv.lease.epoch if srv.lease is not None else "-"
                print(f"failover: {mode}-mode, lease epoch {epoch}, "
                      f"ttl {_cfg.env_float('TTS_LEASE_TTL_S'):g}s "
                      f"(TTS_FLEET_DIR/TTS_FAILOVER)", flush=True)
            if srv.tuner is not None and srv.tuner.cache is not None:
                print(f"tune cache: {srv.tuner.cache.root} "
                      f"({srv.tuner.cache.entries()} entr(y/ies), "
                      f"probe-at-boot={srv.tune_at_boot})", flush=True)
            if args.http_port is not None:
                # BEFORE the pre-warm: a readiness probe (or the doctor)
                # that cannot reach /healthz during a long warm would
                # restart the server into the same warm
                from .obs.httpd import start_http_server
                httpd = start_http_server(srv, host=args.http_host,
                                          port=args.http_port,
                                          profile_dir=args.profile_dir)
                print(f"observability: {httpd.url}/healthz /metrics "
                      "/status /trace /alerts /dashboard; "
                      "POST /submit /cancel /profile?duration_s=N",
                      flush=True)
            env_spec = _cfg.env_str(_cfg.PREWARM_ENV)
            prewarm_spec = (args.prewarm if args.prewarm is not None
                            else env_spec)
            if env_spec is not None and env_spec.strip().lower() in (
                    "0", "off", "no"):
                # the environment's kill-switch wins over the flag
                prewarm_spec = None
            if prewarm_spec is not None and prewarm_spec.strip().lower() \
                    not in ("0", "off", "no"):
                try:
                    summary = srv.prewarm_boot(prewarm_spec,
                                               spool_dir=args.spool)
                except ValueError as e:
                    # a bad spec boots cold, as in JAX
                    print(f"prewarm SKIPPED: {e}", flush=True)
                else:
                    print(f"prewarm: {summary['warms']} executable(s) for "
                          f"{summary['shapes']} shape(s) in "
                          f"{summary['seconds']}s "
                          f"(disk={summary['by']['disk']} "
                          f"compile={summary['by']['compile']} "
                          f"warm={summary['by']['warm']} "
                          f"skipped={summary['by']['skipped']} "
                          f"errors={summary['errors']})", flush=True)
            print(f"serving: {args.submeshes} submesh(es) x "
                  f"{len(srv.slots[0].devices)} device(s) "
                  f"({srv.slots[0].devices[0]}), spool {args.spool}",
                  flush=True)
            served = spool.serve_spool(
                srv, args.spool, idle_exit_s=args.idle_exit,
                status_every_s=args.status_every or None,
                emit=lambda s: print(s, flush=True),
                # a FENCED server (its lease lost to an adopter) stops
                # serving the spool too: its requests live on the peer now
                should_exit=lambda: drain_evt.is_set() or srv.fenced)
            # the `with` close below is the drain: stop at segment
            # boundaries, save, flush the writers (the watchdog escalates if
            # it wedges); /healthz answers 503 meanwhile
    finally:
        if httpd is not None:
            httpd.close()
        if otel_stop is not None:
            otel_stop.set()
        if otel_exp is not None:
            # the interval flusher's instance: only the tail past its
            # watermark ships, never a record a flush already shipped
            n = otel_exp.flush(tracelog.get().records())
            print(f"otel: exported {n} span(s) at shutdown "
                  f"({otel_exp.spans} total) to "
                  f"{args.otel_endpoint}", flush=True)
    watchdog = getattr(drain_evt, "watchdog", None)
    if watchdog is not None:
        watchdog.cancel()
    if drain_evt.is_set():
        print("drained cleanly", flush=True)
    if srv.fenced:
        # exit 0 on purpose: a fenced server did the right thing (no
        # commit past the fence), and a nonzero exit would make a
        # supervisor restart-loop a host whose ledger lives on a peer
        print(f"fenced: {srv._fence_reason or 'lease lost'} — a peer "
              "owns this ledger now; exited without commits",
              flush=True)
    print(f"served {served} request(s)", flush=True)
    return 0


def run_client(args) -> int:
    """The JAX `run_client`: one request file into the spool, then its
    result; exit 0 when it is DONE."""
    from .service import spool

    payload = {"problem": args.problem,
               "priority": args.priority, "deadline_s": args.deadline,
               "chunk": args.chunk, "capacity": args.capacity,
               "tag": args.tag}
    if args.lb is not None:
        payload["lb"] = args.lb
    if args.portfolio is not None:
        payload["portfolio"] = args.portfolio
    if args.problem == "pfsp" and args.inst is not None:
        payload["inst"] = args.inst
        payload["ub"] = "opt" if args.ub == 1 else None
    else:
        payload["p_times"] = _solve_instance_table(args).tolist()
    sid = spool.submit_file(args.spool, payload)
    print(f"submitted {sid}", flush=True)
    try:
        res = spool.wait_result(args.spool, sid, timeout=args.timeout)
    except TimeoutError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(res, indent=1))
    return 0 if res.get("state") == "DONE" else 1


def _device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpu_tree_search_torch")
    ap.add_argument("--multihost", action="store_true",
                    help="join a multi-process job (one process per card, "
                         "or several sharing one) from the environment, "
                         "as `python -m torch.distributed.run` sets it "
                         "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, "
                         "LOCAL_RANK), on the gloo backend; -D then counts "
                         "the job's workers, split evenly across the "
                         "processes; must precede the subcommand")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("pfsp", help="exact PFSP branch-and-bound")
    p.add_argument("-i", "--inst", type=int, default=14,
                   help="Taillard instance number (1..120)")
    p.add_argument("-l", "--lb", type=int, choices=(0, 1, 2), default=1,
                   help="lower bound: 0 lb1_d, 1 lb1, 2 lb2")
    p.add_argument("-u", "--ub", type=int, choices=(0, 1), default=1,
                   help="initial upper bound: 1 the optimum, 0 infinity")
    p.add_argument("-D", type=int, default=0,
                   help="workers: on the card, visible cards (0, the "
                        "default: all); with --device cpu, workers on the "
                        "CPU (0: one)")
    p.add_argument("-m", type=int, default=25,
                   help="with -D > 1: warm-up frontier nodes per worker; "
                        "with -C 1 on one device: the pool size below "
                        "which the host drains the device's residue")
    p.add_argument("-M", type=int, default=50000,
                   help="reference offload chunk ceiling; accepted for "
                        "command-line and CSV-schema compatibility")
    p.add_argument("-T", type=int, default=5000,
                   help="reference CPU bulk-pop size; accepted for "
                        "command-line and CSV-schema compatibility but "
                        "inert here, like -p (the host tier's native DFS "
                        "pops per node; PFSP_lib.c:175-185)")
    p.add_argument("-C", type=int, default=0,
                   help="1: run the host tier beside the device search "
                        "(engine/hybrid.py; every driver)")
    p.add_argument("--host-fraction", type=int, default=None,
                   help="with -C 1: seed the native host tier with every "
                        "k-th warm-up node (default 8; 0 disables the "
                        "concurrent tier)")
    p.add_argument("--host-threads", type=int, default=None,
                   help="with -C 1: native host worker threads "
                        "(default: host cores / device count, the "
                        "reference's num_procs/deviceCount rule, "
                        "pfsp_multigpu_cuda.c:61-69)")
    p.add_argument("-w", "--ws", type=int, default=1,
                   help="with -D > 1: work stealing on (1) or off (0)")
    p.add_argument("-L", type=int, default=1,
                   help="with -D > 1: the same balance round (-w 0 -L 0 "
                        "turns balancing off)")
    p.add_argument("-p", "--perc", type=float, default=0.5,
                   help="reference steal fraction; accepted for "
                        "command-line compatibility (the balance round "
                        "steals half)")
    p.add_argument("--balance-period", type=int, default=4,
                   help="with -D > 1: steps between balance rounds")
    p.add_argument("--chunk", type=int, default=CLI_CHUNK_DEFAULT,
                   help="parents popped per step")
    p.add_argument("--capacity", type=int, default=None,
                   help="initial pool rows per worker (default: by "
                        "instance class)")
    p.add_argument("--csv", type=str, default=None,
                   help="append a row in the reference's CSV schema, with "
                        "measured phase-time columns (utils/phase_timing)")
    p.add_argument("--max-iters", type=int, default=None,
                   help="stop after this many steps (with -D > 1: balance "
                        "rounds; a truncated run)")
    p.add_argument("--segment-iters", type=int, default=None,
                   help="run in bounded segments with heartbeat reports "
                        "(enables checkpointing)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint path; if the file exists the search "
                        "resumes from it")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="write the checkpoint every N segments (the "
                        "compressed pool snapshot costs seconds at "
                        "production sizes; amortize it on long runs)")
    p.add_argument("--grow-capacity", type=int, default=None,
                   help="re-home a resumed checkpoint into a larger pool "
                        "(recovery after an overflow abort)")
    p.add_argument("--retry-attempts", type=int, default=None,
                   help="transient-error retries per segment operation "
                        f"(default {_cfg.RETRY_ATTEMPTS_DEFAULT}; "
                        "exponential backoff base "
                        f"{_cfg.RETRY_BASE_S_DEFAULT}s — also via "
                        "TTS_RETRY_ATTEMPTS / TTS_RETRY_BASE_S)")
    p.add_argument("--segment-timeout", type=float, default=None,
                   help="per-segment wall-clock watchdog in seconds "
                        "(0/default: off; a hung device call raises "
                        "instead of waiting forever — also via "
                        "TTS_SEG_TIMEOUT_S)")
    p.add_argument("--faults", type=str, default=None,
                   help="deterministic fault-injection spec for "
                        "resilience drills, e.g. "
                        "'kill_after_segment=3,fail_host_fetch=1' "
                        "(utils/faults.py; also via TTS_FAULTS)")
    p.add_argument("--search-telemetry", action="store_true",
                   help="keep the on-device search-telemetry vector "
                        "(engine/telemetry.py; also TTS_SEARCH_TELEMETRY=1)"
                        " and print its summary; the counts stay the same")
    _device_arg(p)
    p.set_defaults(fn=run_pfsp)

    p = sub.add_parser("nqueens", help="N-Queens backtracking")
    p.add_argument("-N", type=int, default=14, help="board size")
    p.add_argument("-g", type=int, default=1,
                   help="safety-check repetitions (work scaling)")
    p.add_argument("-D", type=int, default=0,
                   help="workers: on the card, visible cards (0, the "
                        "default: all); with --device cpu, workers on the "
                        "CPU (0: one)")
    p.add_argument("--chunk", type=int, default=CLI_CHUNK_DEFAULT)
    p.add_argument("--capacity", type=int, default=1 << 20)
    _device_arg(p)
    p.set_defaults(fn=run_nqueens)

    p = sub.add_parser(
        "solve", help="one-shot solve of any registered problem through "
                      "the plugin engine")
    _problem_instance_args(p)
    p.add_argument("-l", "--lb", type=int, default=None,
                   help="bound kind (default: the problem's default)")
    p.add_argument("-u", "--ub", type=int, default=None,
                   help="seed incumbent value (objective units)")
    p.add_argument("-D", type=int, default=1,
                   help="workers (1: the single-device engine); on the "
                        "card visible cards (0: all), with --device cpu "
                        "workers on the CPU")
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--capacity", type=int, default=None)
    p.add_argument("--max-iters", type=int, default=None,
                   help="truncate the search (debugging)")
    _device_arg(p)
    p.set_defaults(fn=run_solve)

    _serve_args(sub)
    _client_args(sub)
    _journey_args(sub)
    _profile_args(sub)
    _doctor_args(sub)
    _capacity_args(sub)

    p = sub.add_parser("devices",
                       help="describe the visible devices (the reference's "
                            "gpu_info, common/gpu_util.cu:5-17)")
    p.set_defaults(fn=run_devices)
    return ap


def _journey_args(sub) -> None:
    """The `journey` command's flags (JAX `cli.py` `_journey_parser`)."""
    p = sub.add_parser(
        "journey",
        help="reconstruct request journeys from durable state "
             "(obs/journey): one stitched timeline per logical request "
             "across restarts, takeovers and portfolio fan-outs, read "
             "from ledger and fleet directories; no server needed")
    p.add_argument("--ledger", action="append", default=[],
                   metavar="DIR",
                   help="request-ledger directory (repeatable)")
    p.add_argument("--fleet-dir", type=str, default=None,
                   help="shared fleet root (TTS_FLEET_DIR): read every "
                        "peer ledger under it")
    p.add_argument("--store", type=str, default=None,
                   help="flight-recorder store directory (TTS_OBS_STORE): "
                        "fold its trace events into each journey")
    p.add_argument("--tag", type=str, default=None,
                   help="only journeys whose tag (or any member rid) "
                        "matches")
    p.add_argument("--json", action="store_true",
                   help="machine-readable journeys instead of the report")
    p.set_defaults(fn=run_journey)


def run_journey(args) -> int:
    """The JAX `run_journey`: exit 2 without a directory, 1 when a tag
    matches no journey, else 0."""
    from .obs import journey as journey_mod

    if not args.ledger and not args.fleet_dir:
        print("journey: need --ledger and/or --fleet-dir",
              file=sys.stderr)
        return 2
    journeys = journey_mod.find_journeys(
        ledger_dirs=args.ledger or None, fleet_dir=args.fleet_dir,
        store=args.store, tag=args.tag)
    if args.json:
        print(journey_mod.to_json(journeys))
    elif not journeys:
        print("no journeys"
              + (f" matching tag {args.tag!r}" if args.tag else ""))
    else:
        for j in journeys:
            print(journey_mod.render_journey(j))
    # a tag given but nothing matched: nonzero, so a caller checking for
    # one journey cannot pass on an empty answer
    return 0 if journeys or not args.tag else 1


def _profile_args(sub) -> None:
    """The `profile` command's flags (JAX `cli.py` `_profile_parser`),
    with `--device`."""
    p = sub.add_parser(
        "profile",
        help="standalone capture on demand: warm the single-device loop "
             "past its ramp, trace a steady-state window with "
             "torch.profiler (obs/profiler, the session POST /profile "
             "uses) and print the self-time attribution")
    p.add_argument("-i", "--inst", type=int, default=21,
                   help="Taillard instance id")
    p.add_argument("-l", "--lb", type=int, default=1, choices=(0, 1, 2))
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--capacity", type=int, default=1 << 18)
    p.add_argument("--warm", type=int, default=50,
                   help="warm-up iterations before the traced window")
    p.add_argument("--iters", type=int, default=20,
                   help="traced-window iterations")
    p.add_argument("--out", type=str, default=None,
                   help="artifact root (default: a fresh temp dir); each "
                        "capture gets its own subdirectory")
    p.add_argument("--top", type=int, default=15,
                   help="ops to list in the self-time table")
    _device_arg(p)
    p.set_defaults(fn=run_profile)


def run_profile(args) -> int:
    """The JAX `run_profile`: `--warm` steps, then `--iters` more under
    the profiler; the JSON line, then the top ops by self time."""
    import tempfile

    from .engine import device
    from .obs import chrome_trace, profiler
    from .ops import batched
    from .problems import taillard

    dev = device.resolve_device(args.device)
    p = taillard.processing_times(args.inst)
    ub = taillard.optimal_makespan(args.inst)
    tables = batched.make_tables(p, device=dev)
    state = device.init_state(p.shape[1], args.capacity, ub, p_times=p,
                              device=dev)
    state = device.run(tables, state, args.lb, args.chunk,
                       max_iters=args.warm)
    before = device.counters(state)       # one read: the loop is idle
    print(f"# warmed: iters={before.iters} pool={before.size}",
          file=sys.stderr)

    sess = profiler.session()
    root = args.out or tempfile.mkdtemp(prefix="tts_profile_")
    log_dir = sess.fresh_dir(root)
    with sess.trace(log_dir):
        out = device.run(tables, state, args.lb, args.chunk,
                         max_iters=args.warm + args.iters)
        after = device.counters(out)      # waits for the window's work

    self_us, counts = chrome_trace.self_times(
        chrome_trace.load_profile_trace(log_dir))
    total = sum(self_us.values())
    buckets = chrome_trace.bucketed_self_times(self_us)
    print(json.dumps({
        "artifact": log_dir, "inst": args.inst, "lb": args.lb,
        "iters": after.iters - before.iters,
        "evals": after.evals - before.evals,
        "device_self_ms": round(total / 1e3, 2),
        "buckets_ms": {k: round(v / 1e3, 2)
                       for k, v in buckets.most_common()},
    }))
    print("\n# top ops by device self-time "
          "(obs/chrome_trace.self_times):")
    for name, d in self_us.most_common(args.top):
        print(f"{d / 1e3:10.2f} ms  x{counts[name]:<6} "
              f"[{chrome_trace.bucket_of(name):>15}]  {name[:90]}")
    print(f"\n# artifact: {log_dir}")
    return 0


def _doctor_args(sub) -> None:
    """The `doctor` command's flags (JAX `cli.py` `_doctor_parser`)."""
    p = sub.add_parser(
        "doctor",
        help="one-shot fleet health verdict: scrape N servers' /healthz "
             "/status /metrics /alerts (obs/aggregate), print the "
             "judgment, exit nonzero on any unreachable server or firing "
             "alert")
    p.add_argument("urls", nargs="+", metavar="URL",
                   help="server base URLs (http://host:port)")
    p.add_argument("--json", action="store_true",
                   help="print the merged fleet view as JSON instead of "
                        "the table")
    p.add_argument("--dashboard", type=str, default=None,
                   help="also render the fleet dashboard HTML here "
                        "(obs/dashboard; self-contained, no external "
                        "assets)")
    p.add_argument("--metrics-out", type=str, default=None,
                   help="also write the merged, origin-labelled Prometheus "
                        "exposition here (one aggregated scrape target)")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="per-endpoint scrape timeout in seconds")
    p.add_argument("--fleet-dir", type=str, default=None,
                   help="shared fleet root (TTS_FLEET_DIR): also read "
                        "every peer's lease file, so a down server splits "
                        "into down with its lease held (exit 1: wait out "
                        "the TTL) and down with its lease expired (exit 2: "
                        "requests orphaned, takeover needed)")
    p.set_defaults(fn=run_doctor)


# doctor exit codes (JAX's): 0 healthy; 1 unhealthy (unreachable, firing,
# degraded, or down with its lease held: wait out the TTL); 2 an expired
# unreleased lease in --fleet-dir (an orphaned ledger: take it over now)
DOCTOR_TAKEOVER_EXIT_CODE = 2


def run_doctor(args) -> int:
    """The JAX `run_doctor`: scrape, merge, judge; the table or the JSON,
    the dashboard and the merged metrics when asked."""
    from .obs import aggregate, dashboard

    fleet = aggregate.scrape(args.urls, timeout=args.timeout)
    merged = aggregate.merge(fleet)
    lease_report = (aggregate.fleet_lease_report(args.fleet_dir)
                    if args.fleet_dir else None)
    healthy, reasons = aggregate.verdict(merged,
                                         lease_report=lease_report)
    if args.dashboard:
        with open(args.dashboard, "w") as f:
            f.write(dashboard.render_fleet(merged))
        print(f"# wrote {args.dashboard}", file=sys.stderr)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(aggregate.fleet_to_prometheus(merged))
        print(f"# wrote {args.metrics_out}", file=sys.stderr)
    if args.json:
        print(json.dumps({"healthy": healthy, "reasons": reasons,
                          **({"leases": lease_report}
                             if lease_report is not None else {}),
                          **{k: v for k, v in merged.items()
                             if k != "metrics"}}, indent=1))
    else:
        for s in merged["servers"]:
            print(_doctor_row(s))
        for r in lease_report or []:
            state = ("released" if r["released"] else
                     "EXPIRED" if r["expired"] else "live")
            print(f"lease {r['dir']}: {state} owner={r['owner']} "
                  f"epoch={r['epoch']} age={r['age_s']:g}s"
                  f"/ttl={r['ttl_s']:g}s")
        print("healthy" if healthy else
              "UNHEALTHY:\n  " + "\n  ".join(reasons))
    if healthy:
        return 0
    if lease_report and aggregate.needs_takeover(lease_report):
        return DOCTOR_TAKEOVER_EXIT_CODE
    return 1


def _doctor_row(s: dict) -> str:
    """One server's line of the doctor's table (JAX's columns)."""
    degraded = bool(s.get("quarantined"))
    mark = ("ok" if s["ok"] and s["healthz"] == "ok"
            and not s.get("firing") and not degraded
            else ("DEGRADED" if degraded and s["ok"]
                  and s["healthz"] == "ok"
                  and not s.get("firing") else "UNHEALTHY"))
    aot = s.get("aot_cache")
    aot_col = (f" aot={aot['hits']}h/{aot['misses']}m"
               f"/{aot['entries']}e" if aot else "")
    paused = s.get("admission_paused")
    rem_col = (f" quarantined={s.get('quarantined')}"
               if s.get("quarantined") else "") + (
               f" PAUSED({paused})" if paused else "")
    led_col = ""
    if s.get("restarts") is not None:
        led_col = (f" restarts={s.get('restarts')}"
                   f" recovered={s.get('recovered_requests')}"
                   f" ledger_lag_s={s.get('ledger_lag_s')}")
    pf = s.get("portfolio")
    pf_col = (f" portfolio={pf['active']}a/{pf['won']}w"
              f"/{pf['cancelled_members']}cxl" if pf else "")
    # the predictive columns (obs/estimate): absent while no request
    # publishes an estimate (warm-up, or TTS_PROGRESS=0)
    eta_col = ""
    if s.get("progress_mean") is not None:
        eta_col = f" progress={s['progress_mean'] * 100:.1f}%"
    if s.get("eta_max_s") is not None:
        eta_col += f" eta_s={s['eta_max_s']:g}"
    # the capacity columns (obs/capacity): absent with TTS_CAPACITY=0 or
    # before a service-time estimate exists
    cap_col = ""
    if s.get("utilization") is not None:
        cap_col = (f" rho={s['utilization']:.2f}"
                   f" headroom={s['capacity_headroom']:.2f}")
    fo_col = ""
    if s.get("failover_mode") is not None or s.get("fenced"):
        fo_col = (f" failover={s.get('failover_mode')}"
                  f" epoch={s.get('lease_epoch')}"
                  f" peers_down={s.get('peers_down')}"
                  f" takeovers={s.get('takeovers')}") + (
                  " FENCED" if s.get("fenced") else "")
    return (f"{s['origin']:<24} {mark:<10} "
            f"firing={s.get('firing')} "
            f"queue={s.get('queue_depth')} "
            f"busy={s.get('submeshes_busy')}/{s.get('submeshes')} "
            f"requests={s.get('requests')}{eta_col}{cap_col}"
            f"{aot_col}{rem_col}{pf_col}{led_col}{fo_col}")


def _capacity_args(sub) -> None:
    """The `capacity` command's flags (JAX `cli.py` `_capacity_parser`)."""
    p = sub.add_parser(
        "capacity",
        help="fleet capacity and utilization report (obs/capacity): "
             "scrape N servers' GET /capacity and print per-lane state and "
             "utilization, per-shape-class demand against capacity (rho, "
             "headroom, predicted queue wait) and the what-if partition "
             "advisor")
    p.add_argument("urls", nargs="+", metavar="URL",
                   help="server base URLs (http://host:port)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable documents instead of the tables")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="per-endpoint scrape timeout in seconds")
    p.set_defaults(fn=run_capacity)


def run_capacity(args) -> int:
    """The JAX `run_capacity`: each server's `/capacity` document, as JSON
    or tables; exit 1 when one is unreachable."""
    from .obs import aggregate

    docs, rc = [], 0
    for url in args.urls:
        base = url.rstrip("/")
        origin = base.split("://", 1)[-1]
        try:
            _, body = aggregate._get(base + "/capacity", args.timeout)
            docs.append({"origin": origin, **json.loads(body)})
        except (OSError, ValueError) as e:
            docs.append({"origin": origin, "error": str(e)})
            rc = 1
    if args.json:
        print(json.dumps(docs, indent=1))
        return rc
    for doc in docs:
        for line in _capacity_lines(doc):
            print(line)
    return rc


def _capacity_lines(doc: dict) -> list:
    """The `capacity` command's lines for one server (JAX's format)."""
    if doc.get("error"):
        return [f"{doc['origin']}: UNREACHABLE ({doc['error']})"]
    if not doc.get("enabled"):
        return [f"{doc['origin']}: capacity layer off (TTS_CAPACITY=0)"]
    rho = doc.get("utilization")
    out = [f"{doc['origin']}: lanes={doc.get('healthy_lanes')}"
           f"/{doc.get('lanes')} devices={doc.get('devices')} "
           f"arrivals={doc.get('arrival_per_s', 0):.3f}/s "
           + (f"rho={rho:.2f} headroom={doc.get('headroom'):.2f}"
              if rho is not None else "rho=— (no service estimate)")
           + (f" pred_wait_s={doc['predicted_wait_s']:.3f}"
              if doc.get("predicted_wait_s") is not None else "")
           + (f" pred_req_per_s={doc['predicted_req_per_s']:.3f}"
              if doc.get("predicted_req_per_s") is not None else "")]
    for ln in doc.get("lanes_detail") or []:
        secs = ln.get("seconds") or {}
        top = ", ".join(f"{k}={secs[k]:.1f}s" for k in sorted(
            secs, key=lambda k: -secs[k])[:3])
        out.append(f"  lane {ln.get('lane')}: {ln.get('state'):<13} "
                   f"exec={ln.get('utilization', 0) * 100:5.1f}%  "
                   f"[{top}]  conservation_err="
                   f"{ln.get('conservation_error_s'):.2e}s")
    for c in doc.get("classes") or []:
        srv_s = c.get("service_s")
        out.append(f"  class {c.get('shape')} tenant={c.get('tenant')}: "
                   f"lambda={c.get('arrival_per_s', 0):.3f}/s "
                   + (f"E[S]={srv_s:.3f}s rho={c.get('utilization'):.2f}"
                      if srv_s is not None else "E[S]=— (warming up)"))
    wi = doc.get("what_if") or []
    if wi:
        out.append("  what-if (same devices, n equal lanes):")
        for row in wi:
            cur = "  <- current" if row.get("current") else ""
            wait = row.get("predicted_wait_s")
            out.append(f"    {row['lanes']} lane(s) x "
                       f"{row['devices_per_lane']} dev: "
                       f"req/s={row['predicted_req_per_s']:.3f} "
                       f"rho={row['utilization']:.2f} "
                       + (f"wait_s={wait:.3f}" if wait is not None
                          else "wait_s=inf (saturated)") + cur)
    return out


def run_devices(args) -> int:
    from .utils.device_info import print_device_info

    print_device_info()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.multihost:
        from .parallel import mesh
        mesh.init_processes()
    try:
        return args.fn(args)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
