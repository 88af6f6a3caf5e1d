"""Command line of the port: the `pfsp` subcommand on one device.

Reproduces the single-device paths of `tpu_tree_search/cli.py`:
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

    python -m tpu_tree_search_torch pfsp -i 3 -l 2 -u 1
    python -m tpu_tree_search_torch pfsp -i 14 -l 2 --segment-iters 8 \\
        --checkpoint c.npz --max-iters 16     # then again, to resume
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np

from .tune.defaults import CLI_CHUNK_DEFAULT
from .utils import config as _cfg


def _print_pfsp_settings(args, machines: int, jobs: int, device) -> None:
    print("=" * 49)
    print(f"GPU B&B (1 device(s) - {device})")
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


def run_pfsp(args) -> int:
    from .engine import device, telemetry
    from .problems import taillard
    from .utils import faults

    dev = device.resolve_device(args.device)
    p = taillard.processing_times(args.inst)
    jobs, machines = p.shape[1], p.shape[0]
    if args.capacity is None:
        args.capacity = device.default_capacity(jobs, machines)
    init_ub = taillard.optimal_makespan(args.inst) if args.ub == 1 else None
    _print_pfsp_settings(args, machines, jobs, dev)
    t0 = time.perf_counter()
    if args.segment_iters is not None or args.checkpoint is not None:
        # the plan is this call's (an in-process caller keeps its own)
        with (faults.scoped(args.faults) if args.faults
              else contextlib.nullcontext()):
            try:
                out, warm_tree, warm_sol = _run_pfsp_segmented(args, p,
                                                               init_ub, dev)
            except (RuntimeError, ValueError, OSError) as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
        c = device.counters(out)
        tree, sol, best = c.tree + warm_tree, c.sol + warm_sol, c.best
        complete = c.size == 0
        summary = telemetry.summarize(out.telemetry)
    else:
        res = device.search(p, lb_kind=args.lb, init_ub=init_ub,
                            chunk=args.chunk, capacity=args.capacity,
                            max_iters=args.max_iters, device=dev,
                            telemetry=args.search_telemetry or None)
        tree, sol, best = res.explored_tree, res.explored_sol, res.best
        complete, summary = res.complete, res.telemetry
    elapsed = time.perf_counter() - t0
    _print_results(best, tree, sol, elapsed, complete=complete)
    if summary is not None:
        print("Search telemetry: " + json.dumps(summary))
    return 0


def _run_pfsp_segmented(args, p, init_ub, dev):
    """Segmented single-device search with heartbeat + checkpoint/resume
    (the JAX CLI's `_run_pfsp_segmented` without the `-C` host tier).
    Returns (state, warm-up tree, warm-up sol): a checkpoint of the JAX
    multi-device driver counts its warm-up frontier's nodes in its meta,
    added to the device totals."""
    from .engine import checkpoint, device
    from .ops import batched

    jobs = p.shape[1]
    tables = batched.make_tables(p, device=dev)
    warm_tree = warm_sol = 0
    if args.checkpoint and checkpoint.resume_path(args.checkpoint):
        # a torn snapshot rolls back to its last-good sibling; a stacked
        # snapshot collapses onto this device
        state, meta, _ = checkpoint.load_resilient(args.checkpoint,
                                                   p_times=p, device=dev)
        if len(np.asarray(meta.get("host_depth", ()))):
            raise ValueError(
                f"{args.checkpoint} holds {len(meta['host_depth'])} node(s) "
                "of the JAX CLI's -C host tier (meta host_prmu/host_depth); "
                "that tier (engine/hybrid.py) is not yet ported, and "
                "resuming without it would drop those nodes")
        state = checkpoint.collapse_to_single_device(state, args.chunk, jobs,
                                                     device=dev)
        if args.grow_capacity:
            state = checkpoint.grow(state, args.grow_capacity)
        warm_tree = int(meta.get("warmup_tree", 0))
        warm_sol = int(meta.get("warmup_sol", 0))
        c = device.counters(state)
        print(f"Resumed from {args.checkpoint} "
              f"(segment {int(meta.get('segment', 0))}, "
              f"iters {c.iters}, pool {c.size})")
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
                         "host_prmu": np.zeros((0, jobs), np.int16),
                         "host_depth": np.zeros(0, np.int16)},
        retry_attempts=args.retry_attempts,
        segment_timeout_s=args.segment_timeout)
    return out, warm_tree, warm_sol


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpu_tree_search_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("pfsp", help="exact PFSP branch-and-bound")
    p.add_argument("-i", dest="inst", type=int, default=14,
                   help="Taillard instance number (1..120)")
    p.add_argument("-l", dest="lb", type=int, choices=(0, 1, 2), default=1,
                   help="lower bound: 0 lb1_d, 1 lb1, 2 lb2")
    p.add_argument("-u", dest="ub", type=int, choices=(0, 1), default=1,
                   help="initial upper bound: 1 the optimum, 0 infinity")
    p.add_argument("--chunk", type=int, default=CLI_CHUNK_DEFAULT,
                   help="parents popped per step")
    p.add_argument("--capacity", type=int, default=None,
                   help="initial pool rows (default: by instance class)")
    p.add_argument("--max-iters", type=int, default=None,
                   help="stop after this many steps (a truncated run)")
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
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions)")
    p.set_defaults(fn=run_pfsp)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
