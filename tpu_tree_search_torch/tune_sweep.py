"""Run one tuning sweep on a Taillard instance and print every probe.

    python -m tpu_tree_search_torch.tune_sweep -i 21 -l 2
    python -m tpu_tree_search_torch.tune_sweep -i 21 -l 2 --warm 1000 \\
        --window 48 --repeats 5 --cache DIR

The sweep is `tune.Autotuner.tune` for one worker with the given probe
settings (unset: the tuner's own, `TTS_TUNE_*` included): the chunk
candidates on each pipeline (the warm-up runs at the smallest), the
balance periods at the winner, the winner's rungs. It
prints one JSON line per probe (the tuner's ledger), then one line with
the winner, the sweep's seconds, the warmed pool's rows and, on the card,
the peak allocated bytes and the card's name and power limit. With
`--cache` the winner is persisted there, as the entry a later
`distributed.search(tuner=Autotuner(cache_dir=DIR))` consumes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch

from .problems import taillard
from .tune import tuner


def _ints(text: str) -> tuple:
    return tuple(int(t) for t in text.split(",") if t.strip())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-i", "--instance", type=int, required=True,
                    help="Taillard instance number (1-120)")
    ap.add_argument("-l", "--lb", type=int, default=2, choices=(1, 2))
    ap.add_argument("--chunks", type=_ints, default=None)
    ap.add_argument("--warm", type=int, default=None,
                    help="warm-up steps before the windows")
    ap.add_argument("--window", type=int, default=None,
                    help="measured iterations a probe")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--cache", default=None, help="tuning-cache directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    card = None
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        torch.cuda.reset_peak_memory_stats(dev)
    p = taillard.processing_times(args.instance)
    t = tuner.Autotuner(cache_dir=args.cache, chunks=args.chunks,
                        window_iters=args.window, warm_iters=args.warm,
                        repeats=args.repeats,
                        device=dev)
    t0 = time.perf_counter()
    params = t.tune(p.shape[1], p.shape[0], lb_kind=args.lb, p_times=p)
    seconds = time.perf_counter() - t0
    for row in t.ledger:
        print(json.dumps({"instance": args.instance, **row}), flush=True)
    print(json.dumps({
        "instance": args.instance, "lb": args.lb,
        "chunks": t.chunks, "periods": t.periods, "warm": t.warm_iters,
        "window": t.window_iters, "repeats": t.repeats,
        "warm_pool": t.ledger[0]["pool_start"],
        "winner": dataclasses.asdict(params), "probes": t.probes_run,
        "sweep_seconds": seconds,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
