"""Command line of the port: the `pfsp` subcommand on one device.

Reproduces the single-device path of `tpu_tree_search/cli.py`
(`run_pfsp` -> `device.search`, and the lines of `_print_pfsp_settings`
and `_print_results`). Runs on `cuda` unless `--device cpu` is given;
on the card it takes the fused route (`ops/fused.py`) where that applies.
`--search-telemetry` (or `TTS_SEARCH_TELEMETRY=1`) gives the state the
search-telemetry vector (`engine/telemetry.py`) and prints its summary as
one JSON line after the results; the other output lines are the same
either way.

    python -m tpu_tree_search_torch pfsp -i 3 -l 2 -u 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .tune.defaults import CLI_CHUNK_DEFAULT


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
    from .engine import device
    from .problems import taillard

    dev = device.resolve_device(args.device)
    p = taillard.processing_times(args.inst)
    jobs, machines = p.shape[1], p.shape[0]
    capacity = (device.default_capacity(jobs, machines)
                if args.capacity is None else args.capacity)
    init_ub = taillard.optimal_makespan(args.inst) if args.ub == 1 else None
    _print_pfsp_settings(args, machines, jobs, dev)
    t0 = time.perf_counter()
    out = device.search(p, lb_kind=args.lb, init_ub=init_ub,
                        chunk=args.chunk, capacity=capacity,
                        max_iters=args.max_iters, device=dev,
                        telemetry=args.search_telemetry or None)
    elapsed = time.perf_counter() - t0
    _print_results(out.best, out.explored_tree, out.explored_sol, elapsed,
                   complete=out.complete)
    if out.telemetry is not None:
        print("Search telemetry: " + json.dumps(out.telemetry))
    return 0


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
