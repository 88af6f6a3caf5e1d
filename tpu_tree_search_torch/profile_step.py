"""Where a step's time goes: a `torch.profiler` window over the loop.

    python -m tpu_tree_search_torch.profile_step [-i 21] [-l 2]
        [--chunk 65536] [--capacity 4194304] [--warm 64] [--steps 64]
        [--device cuda]

For each of the two routes, the default (the fused route where it
applies on the card, unfused on the CPU) and `fused="off"`, and for each
of the two loops, eager (`device.step` called `--steps` times from
Python) and graph (`device.run`: on the card, replays of the captured
graph of `device.GRAPH_STEPS` steps; keep `--steps` a multiple of it, so
that no replay ends in no-op steps): seeds Taillard instance `-i` with
ub=opt, runs `--warm` steps through `device.run` (which captures the
graph), then profiles `--steps` more and prints one JSON line: host
milliseconds per step, the device's busy share of the window (the union
of its kernel and copy intervals over the window's wall time), device
milliseconds and operations (kernels and copies) per step, those that
took the most time, by name, with their share of the busy time, and the
peak device memory allocated since the state was made. On a CPU run
there is no device trace: those fields are null. The window is traced
through the process's one profiler (`obs/profiler.session()`, the door
`POST /profile` and the `profile` command use) into a temporary
directory, and read back with `obs/chrome_trace.load_profile_trace`: the
device operations are its events of the card's categories
(`chrome_trace.DEVICE_CATS`).
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from collections import defaultdict

import torch

from .engine import device
from .obs import chrome_trace, profiler
from .ops import batched, fused as fz
from .problems import taillard
from .tune.defaults import BENCH_CHUNK_DEFAULT


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile(inst: int, lb_kind: int, chunk: int, capacity: int, warm: int,
            steps: int, dev: torch.device, top: int = 12,
            fused: str | None = None, loop: str = "graph") -> dict:
    """One profiled window; `fused` is `device.run`'s (None: the
    default route); `loop` is "graph" (`device.run`) or "eager"
    (`device.step` from Python)."""
    on_cuda = dev.type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    p = taillard.processing_times(inst)
    tables = batched.make_tables(p, device=dev)
    state = device.init_state(p.shape[1], capacity,
                              taillard.optimal_makespan(inst), p_times=p,
                              device=dev)
    mode = fz.resolve_mode(fused, on_cuda=on_cuda)
    state = device.run_growing(tables, state, lb_kind, chunk, warm,
                               fused=mode)
    before = device.counters(state)
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    sync()
    log_dir = tempfile.mkdtemp(prefix="tts_profile_step_")
    try:
        with profiler.trace(log_dir):
            t0 = time.perf_counter()
            if loop == "graph":
                out = device.run(tables, state, lb_kind, chunk,
                                 before.iters + steps, fused=mode)
            else:
                out = state
                for _ in range(steps):
                    out = device.step(tables, lb_kind, chunk, out,
                                      fused=mode)
            sync()
            wall_us = 1e6 * (time.perf_counter() - t0)
        events = chrome_trace.load_profile_trace(log_dir)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    after = device.counters(out)
    done = after.iters - before.iters
    res = {"instance": f"ta{inst:03d}", "lb": lb_kind, "chunk": chunk,
           "fused": mode, "loop": loop, "steps": done,
           "overflow": after.overflow,
           "ms_per_step": wall_us / 1e3 / max(done, 1),
           "evals": after.evals - before.evals, "device_busy_share": None,
           "device_ms_per_step": None, "device_ops_per_step": None,
           "top_device_ops": None,
           "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if on_cuda else None)}
    kern = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in chrome_trace.DEVICE_CATS]
    if on_cuda and kern:
        busy = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in kern])
        by_name: dict[str, float] = defaultdict(float)
        count: dict[str, int] = defaultdict(int)
        for e in kern:
            by_name[e["name"]] += e["dur"]
            count[e["name"]] += 1
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        res.update(
            device_busy_share=busy / wall_us,
            device_ms_per_step=busy / 1e3 / max(done, 1),
            device_ops_per_step=len(kern) / max(done, 1),
            top_device_ops=[{"name": n[:100], "share_of_busy": us / busy,
                             "ms_per_step": us / 1e3 / max(done, 1),
                             "calls_per_step": count[n] / max(done, 1)}
                            for n, us in ranked])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_tree_search_torch.profile_step")
    ap.add_argument("-i", dest="inst", type=int, default=21)
    ap.add_argument("-l", dest="lb", type=int, choices=(0, 1, 2), default=2)
    ap.add_argument("--chunk", type=int, default=BENCH_CHUNK_DEFAULT)
    ap.add_argument("--capacity", type=int, default=1 << 22)
    ap.add_argument("--warm", type=int, default=2 * device.GRAPH_STEPS)
    ap.add_argument("--steps", type=int, default=2 * device.GRAPH_STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device.resolve_device(args.device)
    for fused in (None, "off"):
        for loop in ("eager", "graph"):
            print(json.dumps(profile(args.inst, args.lb, args.chunk,
                                     args.capacity, args.warm, args.steps,
                                     dev, fused=fused, loop=loop)),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
