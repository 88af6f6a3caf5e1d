"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the Hopper kernels from `tpu_tree_search_torch/csrc/`, drives the
port's main path (exact PFSP branch-and-bound through `device.search`, the
CLI and `device.run`, which on the card replays a captured CUDA graph of
`device.GRAPH_STEPS` steps; these take the fused route by default where
it applies, and the unfused route is driven with `fused="off"`), checks
every kernel bit for bit (tolerance 0: all of it is int32 math) against
its plain PyTorch version at the main path's shapes, and times both. On
every route the graph run is held against the eager `device.step` loop
and against a graph run of the plain versions, and one eager step runs
with every synchronizing CUDA call an error. Any failed check ends the
run with a non-zero exit code and no result line.

Phases (one line each, then two JSON lines):
  1. the card (`nvidia-smi`), torch and CUDA versions
  2. kernel build, with ptxas's register and spill lines of every kernel
     instance; any instance with a stack frame or spills fails; the
     native host runtime (`g++`) builds beside it
  3. golden solves with ub=opt through the default route (ta003 LB2
     through the CLI, ta014 LB2 `dense`, 50x20 seed 51 LB2 and ta007 LB1
     fused, ta007 LB1_d, ta002 LB1 fused through the CLI), each path's
     launch counts read after it (the dense route launches the expand
     kernel's fronts-only mode), each golden route from the root graph
     against eager against plain; then the dense LB2 route (ta003 at the
     CLI chunk, ta014 at chunk 4096) stepped through the kernels and
     through the plain versions from one state, compared exactly after
     every step, and graph against eager against plain; and ta041
     (50x10) LB2 ub=opt from the root at chunk 65536, dense, until a
     full chunk is popped and 4 steps more, each step against the plain
     versions, then the same steps graph against eager against plain
  4. ta021 LB2 at the bench chunk (65536) / capacity 2^22, 64 warm-up +
     192 timed steps through `device.run` (graph replays) and the same
     192 eager steps from the same state (ms per step, evals/s, peak
     memory, the two states equal), on the default (fused) route and
     with `fused="off"`; 20 unfused steps through the kernels and
     through the plain versions from one state; the fused LB2 tail
     timed at frame N against N/4 on one chunk's survivors
  5. the J > 64 paths: ta071 and ta091 LB2 steps (the unfused prefilter
     route, the bounds-only expand kernel and the J > 64 sweep), graph
     against eager against plain
  6. the fused route against the others: golden solves with
     `fused="off"` (50x20 seed 51 LB2, ta007 LB1); 20 ta021 steps from one
     state through the fused kernel, through its plain version and
     unfused, compared after every step; ta021 ub=inf from the root,
     whose LB1 survivors outgrow N/4: the fused step keeps them at frame
     N, launches no bounds-only kernel and equals the unfused step;
     search telemetry on the card (ta014 `dense`, ta021 `prefilter`,
     fused and unfused, kernels and plain versions, graph and eager)
  7. segmented, checkpointed runs (`checkpoint.run_segmented`, this
     slice's main path): ta021 LB2 ub=opt at chunk 65536 / capacity 2^22
     with telemetry, 64-step segments with a checkpoint every 4 to 256
     steps,
     `load_resilient`, `grow` into 2^23 rows, segments on to 512, against
     one `device.run` to 512 (counters, live rows and telemetry equal; the
     fused kernel and the sweeps launched in graph replays; save and load
     seconds and bytes, segment gaps, ms per step, the device copy that
     makes a retry safe, peak memory); a segment that stepped and then
     failed with an injected fault, retried to the same state; and the
     CLI's drills on ta014 LB2 (stop at 16 steps and resume, a corrupted
     snapshot rolled back, an overflow then `--grow-capacity`), each to
     the golden; then every kernel must have launched inside a graph
     replay
  8. kernel parity and timing at the main path's shapes, and at the
     edges: the expand kernel's three modes (bounds-only, emit, the dense
     route's fronts-only launch) at ta021, ta014, ta003, ta041, ta071,
     ta091 and ta111 (J = 500, TB 32), and with garbage columns past a
     popped count; sweeps of 1 column, of widths that are no multiple of
     the kernel's columns per block, of column prefixes of wider frames,
     at J = 20, 50, 100, 200 and 500; the fused kernel with n_valid < B
     (read from device memory), spilling past its frame, with histogram
     and int16 aux, at J = 200, launched twice on one input and back to
     back on three
  9. the problem-plugin engine (`device.solve`, `run_problem`,
     `generic_step`): N-Queens N = 15, g = 1, chunk 65536 through the
     `nqueens` command (2,279,184 solutions, OEIS A000170, and the JAX
     package's tree, 171,129,071), N = 10 on the card against the same
     solve on the host and the sequential oracle; knapsack
     `synthetic(1000, 0)` at LB1 and LB2 against the DP optimum; TSP
     `synthetic(10, 0)` at both bounds against brute force,
     `synthetic(TSP_N, 0)`, the largest n whose LB2 solve ends within about
     10 s, and `synthetic(TSP_AGREE, 0)`, LB1's, at both bounds (equal
     optima); each with wall time, steps, ms
     per step, peak memory and no kernel launched; each plugin's graph
     run (capture timed) against the same steps taken eagerly, and one
     step with synchronizing calls refused; ta014 LB2 through `solve
     --problem pfsp` at chunk 64 (the fused `prefilter` route) and 4096
     (the dense route), each to the golden with its launches and equal to
     the `pfsp` command
 10. the multi-worker search (`distributed.search`, this slice's main
     path), D = 4 workers on the one card (`mesh.worker_devices(devices=
     [card] * 4)`): (a) ta014 LB2 ub=opt at chunk 4096 (dense) to the
     golden, with balance rounds that moved nodes; (b) ta007 LB1_d ub=opt
     to its golden; (c) case (a) under the plain versions, every worker's
     counters equal to (a)'s; (d) ta021 LB2 ub=opt at chunk 65536,
     capacity 2^22 per worker, fused, balance period 4: every worker's
     live rows and counters after 2 macro-iterations (graph replays)
     equal to a plain-kernel run's and to the same macro-iterations taken
     eagerly, then 64 macro-iterations timed (ms each, evals/s
     over the workers, host reads each, the balance round's device ms by
     graph replays, per-worker sizes and steals, peak memory); (e) N-Queens
     15 at chunk 65536 to its counts; (f) case (a) stopped after 2
     segments with a stacked checkpoint and resumed on 2 workers, to (a)'s
     totals; (g) `pfsp -i 14 -l 2 -u 1 -D 4` through the command, refused
     with the device count when fewer than 4 cards are visible. The
     `kernels` line's `dist_launches` are this phase's launches
 11. the `-C` host tier (`engine/hybrid.py`, this slice's main path): the
     native host session beside the device loop, incumbents merged at
     every segment, the residue drained on host threads. Through the
     `pfsp` command: (a) ta008 LB2 ub=opt at chunk 65536 (dense) against
     the same command without -C, with the session's counters; (b) ta016
     LB2 ub=opt at chunk 65536 (its route recorded); (c) ta007 LB1_d;
     (d) ta014 LB2 ub=inf (live incumbent); (e) ta014 LB2 segmented with
     a checkpoint, stopped at 8 steps, resumed with -C and, a second
     copy, without; (f) `distributed.search` on four workers on the card
     with the tier; (g) the `--csv` rows of (a) and (f) in the JAX CLI's
     schema with measured timing columns. The `kernels` line's
     `hybrid_launches` are this phase's launches
 12. the chunk ladder and the incumbent board (`engine/ladder.py`,
     `engine/incumbent.py`, `distributed.search(ladder=True,
     incumbent_board=...)`), four workers on the card: (1) ta021 LB2
     ub=opt at chunk 65536 (rungs 4096, 16384, 65536), capacity 2^22 a
     worker, period 4, 8-step segments, 6 segments from the root, twice:
     with the default warm-up (starting on 4096) and with 8192 warm-up
     nodes a worker (starting on 16384); each reaches the top rung, every
     segment launches kernels, each rung is captured once, and at every
     boundary the node accounting holds exactly (telemetry on,
     TTS_AUDIT_HARD=1); per rung its segments, captures, graph ms per
     segment and launches, and the peak memory against the same segments
     without the ladder; (2) ta008 LB2 ub=opt at chunk 65536 (dense) to
     completion with the ladder on and off, both to the golden, both
     timed; (3) ta014 LB2 ub=opt at chunk 4096 (rungs 256, 1024, 4096),
     4-step segments, switching up and down; cut after two segments with
     a checkpoint, resumed on the recorded rung and, from a copy, with
     the ladder off, both to the golden; (4) ta014 ub=inf with no board,
     with a lone board client (every worker's counters equal) and a
     second search on that board, which folds the first's best
     (`tts_incumbent_folds_total{direction="in"}`), proves 1377 and
     explores no more than the solo run; (5) `chunk=None` /
     `balance_period=None`, resolved to `params_for("serving")`. The
     `kernels` line's `ladder_launches` are this phase's launches
 13. the tuner (`tune/`, `distributed.search(tuner=...)`) and the LB2
     debug tap: (1) `Autotuner.resolve(20, 20, 2, allow_probe=True)` on
     ta021 with the default candidates (chunks 256 ... 65536 on the fused
     and the unfused pipeline, periods 1, 4, 16, the winner's rungs;
     window 24, warm-up 200, 2 repeats): every probe with its rate, the
     winner, `rung_modes`, the sweep's seconds and peak memory; no
     top-of-ladder candidate dropped, every probe counting evals, each
     candidate's calls from the same state counting the same; (2) a
     second tuner on that directory resolves with zero probes from the
     cache; (3) ta014 probed at chunks 1024 and 4096 for four workers,
     then `search(chunk=None, tuner=...)` from a fresh tuner on four
     workers to the golden (source "cache", the probed chunk), plain and
     with TTS_LADDER=1 over segments (the entry's `rung_modes` choosing
     the rungs); (4) the entry truncated: quarantined and probed again;
     (5) `chip_smoke.py --debug-tap` in a subprocess with
     TTS_DEBUG_STEP=1 (ta021 LB2 on both routes, the tap equal to the
     plain versions', graph equal to eager). The `kernels` line's
     `tune_launches` are the launches of the probes of (1), (3) and (4)
 14. the overlapped segment driver and multi-process runs
     (`checkpoint.run_segmented(overlap=True)`,
     `AsyncCheckpointWriter`, `_DistDriver.run_async`, `--multihost`):
     (1) ta021 LB2 ub=opt at chunk 65536 on four workers, three one-step
     segments from the same seeded state with a save after every one,
     overlap off and on, and on with a save every second segment: every
     segment report but its wall-clock field and every worker's final
     counters and live rows equal; per run its wall seconds, the gaps
     after checkpoint segments and after the others (count, sum, p50,
     max), each save's seconds and thread and the writer's peak of
     pending tasks; one macro-iteration replayed past its ceiling, by
     device time; (2) ta014 LB2 ub=opt on four workers under overlap with
     a save every 4-step segment, to the golden; (3) the same stopped
     under overlap after two segments, resumed with overlap off and on,
     both to the golden; (4) `python -m torch.distributed.run
     --nproc-per-node 2 chip_smoke.py --mp-rank DIR --multihost pfsp -i
     14 -l 2 -u 1 -D 4 ...` (each rank runs `cli.main` on that command
     line and reports its launches, checkpoint writes, seconds and the
     host time of each macro-iteration's cross-process part): truncated
     after two macro-iterations with a checkpoint only rank 0 writes,
     resumed by both ranks (the golden on each, and the `dist` CSV row's
     per-worker trees equal to one process driving the same four
     workers), and its copy resumed by one process to the golden. The
     `kernels` line's `overlap_launches` and `mp_launches` are the
     launches of (1)-(3) and of (4)
 15. request megabatching (`engine/megabatch.serve_batch`, one worker a
     member unless named): (1) the eight 20x5 instances with an LB2
     ub=opt golden (ta001-ta004, ta007-ta010) in one batch, chunk 16384
     a member, capacity 2^21, period 4, 64-step segments: every golden,
     ta008 draining last and after the others, one capture, a replay
     launching 8 times a solo replay's kernels (B4 fronts-only and B2, no
     B5); the batch's wall against the eight solo searches' at the same
     knobs, ms a macro-iteration, an all-frozen replay's device ms
     against a solo no-op one, host reads a replay, peak memory; (2)
     ta021-ta024 on the unfused prefilter route (B1, B2), chunk 65536,
     capacity 2^22, stopped by `stop_event` after two 8-step segments,
     each member's counters equal to its solo `_DistDriver.run(max_iters=
     16)`; (3) leg (1)'s batch without ta008, ta010 stopped at segment 2
     by `member_stop` and its checkpoint resumed by the solo search to
     the golden, the batchmates to theirs; (4) ta003 and ta004 on two
     workers each (goldens, rounds that move nodes, counters equal to
     solo), and ta071/ta072 (B1, B3) at chunk 8192 stopped after two
     4-step segments, equal to solo. The `kernels` line's `mb_launches`
     are the batches' launches
The last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import io
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch finds no CUDA device")

from tpu_tree_search_torch import cli, native, problems  # noqa: E402
from tpu_tree_search_torch.engine import checkpoint, device  # noqa: E402
from tpu_tree_search_torch.engine import distributed, hybrid  # noqa: E402
from tpu_tree_search_torch.engine import incumbent, ladder  # noqa: E402
from tpu_tree_search_torch.engine import megabatch  # noqa: E402
from tpu_tree_search_torch.engine import sequential  # noqa: E402
from tpu_tree_search_torch.engine import telemetry as tele  # noqa: E402
from tpu_tree_search_torch.kernel_times import (  # noqa: E402
    cuda_ms, kernel_ms, pool_chunk, random_chunk)
from tpu_tree_search_torch.obs import audit  # noqa: E402
from tpu_tree_search_torch.obs import metrics as obs_metrics  # noqa: E402
from tpu_tree_search_torch.obs import tracelog  # noqa: E402
from tpu_tree_search_torch.ops import batched, columns  # noqa: E402
from tpu_tree_search_torch.ops import expand as ex  # noqa: E402
from tpu_tree_search_torch.ops import fused as fz, kernels  # noqa: E402
from tpu_tree_search_torch.parallel import mesh  # noqa: E402
from tpu_tree_search_torch.problems import knapsack, nqueens  # noqa: E402
from tpu_tree_search_torch.problems import taillard, tsp  # noqa: E402
from tpu_tree_search_torch.tune import defaults as tune_defaults  # noqa: E402
from tpu_tree_search_torch.tune import tuner as tune_tuner  # noqa: E402
from tpu_tree_search_torch.tune.defaults import (  # noqa: E402
    BENCH_CHUNK_DEFAULT, CLI_CHUNK_DEFAULT)
from tpu_tree_search_torch.utils import csv_stats, faults  # noqa: E402
from tpu_tree_search_torch.utils import phase_timing  # noqa: E402

ROOT = Path(__file__).resolve().parent
DEV = torch.device("cuda", 0)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
# int32 add/min/max rate of the CUDA cores: 64 results per clock per SM
# (compute capability 9.0), 132 SMs, 1.98 GHz boost clock
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# float32 rate: 128 adds per clock per SM (67 TFLOP/s counts an FMA as
# two); float32 min/max run at most as fast, and an SM issues no more
# than 128 thread-instructions a clock, so 128 per clock bounds a chain of
# float32 adds and maxes however they mix (the LB2 sweep computes in
# float32)
FP32_OPS_PER_S = 128 * 132 * 1.98e9


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


@contextlib.contextmanager
def plain_kernels():
    """Route the engine's kernel calls to the plain versions on the same
    CUDA tensors (for the comparisons only). The captured graphs are
    dropped on entry and exit, so that a graph of one kind is never
    replayed under the other."""
    saved = (kernels.expand_bound, kernels.expand_fronts, kernels.lb2_sweep,
             kernels.fused_expand)

    def expand_bound(tables, prmu_T, depth2, front_T, lb_kind, tile, emit):
        if emit:
            return ex.expand_plain(tables, prmu_T, depth2, front_T, lb_kind,
                                   tile)
        return None, None, ex.expand_bounds_plain(tables, prmu_T, depth2,
                                                  front_T, lb_kind, tile)

    def expand_fronts(tables, prmu_T, depth2, front_T, tile):
        return ex.expand_fronts_plain(tables, prmu_T, depth2, front_T, tile)

    def lb2_sweep(tables, cf, sched, live=None):
        return ex.mask_live(ex.lb2_plain(tables, sched, cf), live)

    def fused_expand(tables, prmu_T, depth2, front_T, n_valid, cap, tile,
                     width, with_sched, bins, with_bounds, aux_i16):
        return fz.fused_expand_plain(tables, prmu_T, depth2, front_T,
                                     n_valid, cap, 1, tile, width,
                                     with_sched, bins, with_bounds, aux_i16)

    device.clear_graphs()
    (kernels.expand_bound, kernels.expand_fronts, kernels.lb2_sweep,
     kernels.fused_expand) = (expand_bound, expand_fronts, lb2_sweep,
                              fused_expand)
    try:
        yield
    finally:
        (kernels.expand_bound, kernels.expand_fronts, kernels.lb2_sweep,
         kernels.fused_expand) = saved
        device.clear_graphs()


# launches made by graph replays, over the whole run
IN_GRAPHS = dict.fromkeys(kernels.LAUNCHES, 0)


def path_run(name: str, expect: tuple, fn):
    """Drive one main path with the launch counts set to 0 just before it
    and read just after; every kernel in `expect` must have launched."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    for k, v in kernels.REPLAYED.items():
        IN_GRAPHS[k] += v
    for k in expect:
        check(counts[k] > 0, f"{name}: kernel {k} never launched")
    return out, counts, seconds


def clone(state: device.SearchState) -> device.SearchState:
    return state._replace(prmu=state.prmu.clone(), depth=state.depth.clone(),
                          aux=state.aux.clone())


def run_steps(tables, state, lb_kind: int, chunk: int, steps: int,
              fused: str | None = None):
    """`steps` more steps through `device.run` (graph replays), growing
    the pool on overflow."""
    return device.run_growing(tables, state, lb_kind, chunk,
                              device.counters(state).iters + steps,
                              fused=fused)


def eager_steps(tables, state, lb_kind: int, chunk: int, steps: int,
                fused: str | None = None, check_each: bool = True):
    """`steps` more `device.step` calls from Python; with `check_each`
    the loop stops where `run` stops (an empty pool or an overflow),
    reading the counters after every step."""
    for _ in range(steps):
        if check_each:
            c = device.counters(state)
            if c.size == 0 or c.overflow:
                break
        state = device.step(tables, lb_kind, chunk, state, fused=fused)
    return state


def same_state(a: device.SearchState, b: device.SearchState) -> bool:
    ca, cb = device.counters(a), device.counters(b)
    if ca != cb:
        return False
    n = ca.size
    return (torch.equal(a.prmu[:, :n], b.prmu[:, :n])
            and torch.equal(a.depth[:n], b.depth[:n])
            and torch.equal(a.aux[:, :n], b.aux[:, :n])
            and torch.equal(a.telemetry, b.telemetry))


def graph_vs_eager(label, tables, state, lb_kind, chunk, steps, fused=None):
    """`steps` steps from one state three ways: `device.run` (graph
    replays of the kernels), the eager `device.step` loop, and
    `device.run` with every kernel replaced by its plain version (graphs
    of those); all three compared exactly. Returns the graph run's
    state."""
    g = run_steps(tables, clone(state), lb_kind, chunk, steps, fused)
    e = eager_steps(tables, clone(state), lb_kind, chunk, steps, fused)
    with plain_kernels():
        pl = run_steps(tables, clone(state), lb_kind, chunk, steps, fused)
    check(not device.counters(g).overflow,
          f"{label}: the pool overflowed")
    check(same_state(g, e), f"{label}: graph run != eager steps")
    check(same_state(g, pl), f"{label}: graph run != plain-kernel graph run")
    c = device.counters(g)
    say(f"{label}: {steps} steps graph run vs eager vs plain kernels",
        equal=True, iters=c.iters, size=c.size, tree=c.tree)
    return g


def sync_free_step(label, tables, state, lb_kind, chunk, fused=None):
    """One eager step with every synchronizing CUDA call an error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        device.step(tables, lb_kind, chunk, clone(state), fused=fused)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    say(f"sync-free step {label}", fused=fused, syncs=0)


def debug_tap_child() -> None:
    """Phase 13 (5), in a subprocess started with TTS_DEBUG_STEP=1 (the
    engine reads the flag at import): ta021 LB2 at chunk 65536 from the
    root, 6 steps on the fused and on the unfused `prefilter` route,
    through the kernels and through the plain versions from the same
    states, and through `device.run` (one graph replay, whose 26 steps
    past the ceiling are no-ops that keep the tap); every counter,
    `sent`/`recv`/`steals` (the tap) among them, equal after every step.
    Prints one JSON line of the taps."""
    check(device._DEBUG_STEP, "TTS_DEBUG_STEP did not reach the engine")
    p = taillard.processing_times(21)
    tables = batched.make_tables(p, device=DEV)
    s0 = device.init_state(20, 1 << 22, taillard.optimal_makespan(21),
                           p_times=p, device=DEV)
    taps = {}
    for fused in (None, "off"):
        k_state, p_state, rows = clone(s0), clone(s0), []
        for i in range(6):
            k_state = device.step(tables, 2, 65536, k_state, fused=fused)
            with plain_kernels():
                p_state = device.step(tables, 2, 65536, p_state,
                                      fused=fused)
            ck, cp = device.counters(k_state), device.counters(p_state)
            check(ck == cp, f"debug tap {fused} step {i + 1}: {ck} != {cp}")
            rows.append([ck.sent, ck.recv, ck.steals])
        check(same_state(k_state, p_state), f"debug tap {fused}: pools")
        check(any(r[2] > 0 and r[1] > 0 for r in rows),
              f"debug tap {fused}: the tap wrote nothing {rows}")
        g = device.run(tables, clone(s0), 2, 65536, max_iters=6,
                       fused=fused)
        check(same_state(g, k_state), f"debug tap {fused}: graph != eager")
        sync_free_step(f"debug tap {fused}", tables, k_state, 2, 65536,
                       fused=fused)
        taps[fused or "hw"] = rows
    print(json.dumps({"debug_tap": taps}), flush=True)


def mp_rank_child(out_dir: str, argv: list) -> None:
    """Phase 14 (5): one rank of a `python -m torch.distributed.run
    --nproc-per-node 2 chip_smoke.py --mp-rank OUT_DIR --multihost pfsp
    ...` job (two ranks sharing the card). Runs the command line `argv`
    through `cli.main`, as `python -m tpu_tree_search_torch argv` runs
    it, and writes to OUT_DIR/rank<r>.json its exit code, what it
    printed, its kernel launches, its checkpoint writes, its seconds and
    the host time of the cross-process part of each macro-iteration (the
    incumbent minimum, the balance round and the status read, each timed
    from a synchronized device)."""
    round_s = {"pmin": 0.0, "balance": 0.0, "status": 0.0}
    calls = {"balance": 0}

    def timed(fn, key):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            round_s[key] += time.perf_counter() - t
            if key in calls:
                calls[key] += 1
            return out
        return wrapped

    distributed._pmin = timed(distributed._pmin, "pmin")
    distributed._balance_round = timed(distributed._balance_round,
                                       "balance")
    distributed._Comm.status = timed(distributed._Comm.status, "status")
    writes = []
    write_snapshot = checkpoint._write_snapshot

    def counted(path, arrays):
        writes.append(str(path))
        return write_snapshot(path, arrays)

    checkpoint._write_snapshot = counted
    kernels.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    macros = max(calls["balance"], 1)
    rank = mesh.process_index()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "world": mesh.process_count(), "rc": rc,
        "stdout": buf.getvalue(), "launches": dict(kernels.LAUNCHES),
        "writes": len(writes), "seconds": seconds,
        "macro_iterations": calls["balance"],
        "round_host_ms_per_macro_iteration": {
            k: 1e3 * v / macros for k, v in round_s.items()}}))
    sys.exit(rc)


if sys.argv[1:] == ["--debug-tap"]:
    debug_tap_child()
    sys.exit(0)
if sys.argv[1:2] == ["--mp-rank"]:
    mp_rank_child(sys.argv[2], sys.argv[3:])

# --- phase 1: the card ----------------------------------------------------
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, timeout=60, check=True).stdout.strip()
print(smi.splitlines()[0], flush=True)
say("device", nvidia_smi=smi, torch=torch.__version__,
    cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
    count=torch.cuda.device_count())
torch.cuda.set_device(DEV)

# --- phase 2: build -------------------------------------------------------


def ptxas_instances(log: str) -> list[dict]:
    """One entry per kernel instance of an `nvcc -Xptxas -v` log: its
    mangled name, registers, stack frame and spill bytes."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = {"name": ln.split("'")[1]}
            out.append(cur)
        elif cur is not None and "bytes stack frame" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = nums[:3]
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(ln.split("Used")[1].split()[0])
    return out


def timed_native_build() -> float:
    t = time.perf_counter()
    native.build()
    return time.perf_counter() - t


# the native host runtime (g++, the multi-worker warm-up's) builds beside
# the kernels, so no timed phase below pays for it
t0 = time.perf_counter()
with ThreadPoolExecutor(1) as pool:
    native_built = pool.submit(timed_native_build)
    built = kernels.build()
    native_s = native_built.result()
say("build", seconds=round(time.perf_counter() - t0, 3),
    per_source={k: round(v[0], 3) for k, v in built.items()},
    native_host_runtime=round(native_s, 3))
for stem, (_, log) in built.items():
    insts = ptxas_instances(log)
    for inst in insts:
        say(f"ptxas {stem}", **inst)
    # the log is kept beside the library, so a cached build is checked too
    check(bool(insts), f"{stem}: no ptxas lines")
    for inst in insts:
        check(inst.get("stack") == 0 and inst.get("spill_stores") == 0
              and inst.get("spill_loads") == 0,
              f"{stem}: {inst['name']} has a stack frame or spills")

# --- phase 3: golden solves through the entry points ----------------------
LAUNCH_FROM: dict[str, dict] = {}
with contextlib.redirect_stdout(io.StringIO()) as buf:
    (rc, lines), counts, secs = path_run(
        "ta003 cli", ("expand_emit", "expand_fronts", "lb2_sweep"),
        lambda: (cli.main(["pfsp", "-i", "3", "-l", "2", "-u", "1"]), None))
text = buf.getvalue()
check(rc == 0, "cli pfsp -i 3 -l 2 -u 1 exit code")
for want in ("Size of the explored tree: 80062",
             "Number of explored solutions: 0", "Optimal makespan: 1081"):
    check(want in text, f"ta003 cli output lacks {want!r}")
check(device.lb2_route(20, 5, 10, CLI_CHUNK_DEFAULT)[0] == "dense",
      "ta003 route")
say("golden ta003 lb2 (cli, dense)", tree=80062, seconds=round(secs, 3),
    launches=counts)

matrix = [json.loads(l) for l in (ROOT / "tests" / "golden" /
                                  "pfsp_lb2_matrix.jsonl").read_text()
          .splitlines()]
m51 = next(r for r in matrix if r["seed"] == 51)
GOLDENS = [  # name, p, lb, ub, chunk, (tree, sol, best), launched, not
    ("ta014 lb2 (dense)", taillard.processing_times(14), 2, 1377, 4096,
     (144639, 0, 1377), ("expand_emit", "expand_fronts", "lb2_sweep"),
     ("fused_expand", "expand_bounds")),
    ("50x20 seed 51 lb2 (fused prefilter, W=2)",
     np.asarray(m51["p"], np.int32).reshape(20, 50), 2, m51["ub"], 256,
     (19481, 0, 3691), ("fused_expand", "lb2_sweep"), ()),
    # the uncapped fused LB1 route never needs the bounds-only kernel
    ("ta007 lb1 (fused)", taillard.processing_times(7), 1, 1234, 4096,
     (271602, 28447, 1234), ("fused_expand",), ("expand_bounds",)),
    ("ta007 lb1_d", taillard.processing_times(7), 0, 1234, 4096,
     (271602, 28447, 1234), ("expand_bounds",), ("fused_expand",)),
]
# the bounds-only kernel's main path (it left the default LB2 route when
# the fused route stopped spilling)
BOUNDS_PATH = "ta007 lb1_d"


def golden(name, p, lb, ub, chunk, want, expect, absent, **kw):
    res, counts, secs = path_run(name, expect, lambda: device.search(
        p, lb_kind=lb, init_ub=ub, chunk=chunk, capacity=1 << 20,
        device=DEV, **kw))
    got = (res.explored_tree, res.explored_sol, res.best)
    check(got == want and res.complete, f"{name}: {got} != {want}")
    for k in absent:
        check(counts[k] == 0, f"{name}: kernel {k} launched")
    say(f"golden {name}", tree=got[0], sol=got[1], best=got[2],
        seconds=round(secs, 3), launches=counts)
    return counts


@contextlib.contextmanager
def recording(module, name: str):
    """Keep what each call of module.name returns (the original still
    runs); the list's length counts the calls."""
    out = []
    fn = getattr(module, name)

    def recorded(*args, **kw):
        out.append(fn(*args, **kw))
        return out[-1]

    setattr(module, name, recorded)
    try:
        yield out
    finally:
        setattr(module, name, fn)


# the default route: no `fused` argument, as a user calls it
for row in GOLDENS:
    if row[0] == BOUNDS_PATH:
        continue                      # run below, its launches recorded
    if not row[0].startswith("ta014"):
        golden(*row)
        continue
    # on the card the dense step runs the expand kernel's fronts-only
    # launch, never `sched_mask_cols`, children or a depth row; the emit
    # kernel's row is measured at this path's shape
    with recording(ex, "sched_mask_cols") as calls:
        counts = golden(*row)
    check(not calls and counts["expand_fronts"] == counts["expand_emit"],
          f"ta014 dense: {len(calls)} sched_mask_cols calls, launches "
          f"{counts}")
    LAUNCH_FROM["expand_emit"] = counts
for row in GOLDENS:
    if row[0] == BOUNDS_PATH:
        LAUNCH_FROM["expand_bounds"] = golden(*row)

# each golden path's route from the root: graph run, eager steps and the
# plain-kernel graph run, then one step with synchronizing calls refused
for name, p, lb, ub, chunk, *_ in GOLDENS:
    if name.startswith("ta014"):
        continue                      # the dense phase below covers it
    tb = batched.make_tables(p, device=DEV)
    s0 = device.init_state(p.shape[1], 1 << 20, ub, p_times=p, device=DEV)
    graph_vs_eager(f"golden {name}", tb, s0, lb, chunk, 40)
    sync_free_step(f"golden {name}", tb, s0, lb, chunk)
    if lb == 1:
        sync_free_step(f"golden {name} unfused", tb, s0, lb, chunk, "off")
check(fz.fused_ok("hw", 50, device.lb2_route(50, 20, 190, 256)[1], 2, 20,
                  device=DEV), "50x20 fused gate")

with contextlib.redirect_stdout(io.StringIO()) as buf:
    (rc, _), counts, secs = path_run(
        "ta002 cli (fused)", ("fused_expand",),
        lambda: (cli.main(["pfsp", "-i", "2", "-l", "1", "-u", "1"]), None))
text = buf.getvalue()
check(rc == 0, "cli pfsp -i 2 -l 1 -u 1 exit code")
for want in ("Size of the explored tree: 30",
             "Number of explored solutions: 0", "Optimal makespan: 1359"):
    check(want in text, f"ta002 cli output lacks {want!r}")
check(counts["expand_bounds"] == 0, "ta002 cli: unfused launches")
say("golden ta002 lb1 (cli, fused)", tree=30, seconds=round(secs, 3),
    launches=counts)


def kernels_vs_plain(label, tables, state, chunk, steps, fused=None):
    """`steps` steps from one state through the kernels and through the
    plain versions on the same CUDA tensors, compared exactly after each
    step (the state itself is left as it was)."""
    a, b = clone(state), clone(state)
    for k in range(steps):
        a = device.step(tables, 2, chunk, a, fused=fused)
        with plain_kernels():
            b = device.step(tables, 2, chunk, b, fused=fused)
        check(same_state(a, b), f"{label} step {k + 1}: kernels != plain")
    c = device.counters(a)
    say(f"{label} {steps} steps kernels vs plain", equal=True, size=c.size,
        tree=c.tree)


# the dense route, kernels against plain versions at its two shapes: ta003
# at the CLI chunk (20x5) and ta014 at chunk 4096 (20x10), each from a
# state whose pool holds more than a full chunk
DENSE = {}
for inst, chunk, warm, steps in ((3, CLI_CHUNK_DEFAULT, 10, 30),
                                 (14, 4096, 8, 20)):
    p = taillard.processing_times(inst)
    tb = batched.make_tables(p, device=DEV)
    check(device.lb2_route(20, p.shape[0], int(tb.ma0.shape[0]),
                           chunk)[0] == "dense", f"ta{inst:03d} route")
    s = device.init_state(20, 1 << 20, taillard.optimal_makespan(inst),
                          p_times=p, device=DEV)
    s = run_steps(tb, s, 2, chunk, warm)
    size = device.counters(s).size
    check(size >= chunk, f"ta{inst:03d}: pool {size} < chunk {chunk}")
    kernels_vs_plain(f"ta{inst:03d} lb2 dense chunk {chunk}", tb, s, chunk,
                     steps)
    graph_vs_eager(f"ta{inst:03d} lb2 dense chunk {chunk}", tb, s, 2, chunk,
                   steps + 10)
    sync_free_step(f"ta{inst:03d} lb2 dense", tb, s, 2, chunk)
    DENSE[inst] = (p, tb, s, chunk)


def from_root_vs_plain(tables, state, chunk, max_warm, more):
    """LB2 steps from `state` through the kernels and through the plain
    versions, compared after each step, until the pool holds a full chunk
    (within `max_warm` steps), then the step that pops it and `more` steps
    after it. Returns the kernel run's state."""
    a, b = clone(state), clone(state)
    first = None
    for k in range(max_warm + 1 + more):
        if first is None and device.counters(a).size >= chunk:
            first = k
        if first is None and k >= max_warm:
            break
        a = device.step(tables, 2, chunk, a)
        with plain_kernels():
            b = device.step(tables, 2, chunk, b)
        check(same_state(a, b) and not device.counters(a).overflow,
              f"step {k + 1}: kernels != plain, or the pool overflowed")
        if first is not None and k - first == more:
            break
    check(first is not None and k - first == more,
          f"no full chunk popped in {max_warm} steps, or fewer than {more} "
          "steps after it")
    return a


# ta041 (50x10) at the bench chunk: the dense route at its widest (N =
# 3,276,800 child columns, two scheduled-set words)
p41 = taillard.processing_times(41)
t41 = batched.make_tables(p41, device=DEV)
check(device.lb2_route(50, 10, 45, BENCH_CHUNK_DEFAULT)[0] == "dense",
      "ta041 route")
s41, counts, secs = path_run(
    "ta041 lb2 dense", ("expand_emit", "expand_fronts", "lb2_sweep"),
    lambda: from_root_vs_plain(t41, device.init_state(
        50, 1 << 24, taillard.optimal_makespan(41), p_times=p41,
        device=DEV), BENCH_CHUNK_DEFAULT, 10, 4))
check(counts["expand_bounds"] == 0 and counts["fused_expand"] == 0,
      f"ta041 dense launches {counts}")
LAUNCH_FROM["expand_fronts"] = counts
k41 = device.counters(s41)
say(f"ta041 lb2 dense chunk {BENCH_CHUNK_DEFAULT} from the root, kernels "
    "vs plain", equal=True, steps=k41.iters, size=k41.size, tree=k41.tree,
    seconds=round(secs, 3), launches=counts)
graph_vs_eager(f"ta041 lb2 dense chunk {BENCH_CHUNK_DEFAULT} from the root",
               t41, device.init_state(50, 1 << 24,
                                      taillard.optimal_makespan(41),
                                      p_times=p41, device=DEV),
               2, BENCH_CHUNK_DEFAULT, k41.iters)

# --- phase 4: ta021 at the bench shape ------------------------------------
CHUNK = BENCH_CHUNK_DEFAULT
N21 = CHUNK * 20
p21 = taillard.processing_times(21)
t21 = batched.make_tables(p21, device=DEV)
check(device.lb2_route(20, 20, 190, CHUNK)[0] == "prefilter", "ta021 route")
# whole replays: no timed step is a no-op
TIMED = 6 * device.GRAPH_STEPS


def ta021_run(fused):
    """64 warm-up steps through `device.run` (which captures the graph),
    then TIMED steps through it, timed; returns the warm state's counters,
    a copy of the warm state, the timed run's state and its seconds."""
    s = device.init_state(20, 1 << 22, taillard.optimal_makespan(21),
                          p_times=p21, device=DEV)
    s = run_steps(t21, s, 2, CHUNK, 2 * device.GRAPH_STEPS, fused)
    warm = device.counters(s)
    start = clone(s)
    torch.cuda.synchronize()
    t = time.perf_counter()
    # the pool is updated in place (it is the captured graph's)
    s2 = run_steps(t21, s, 2, CHUNK, TIMED, fused)
    torch.cuda.synchronize()
    return warm, start, s2, time.perf_counter() - t


TA021 = {}
# unfused first, then the default route, which is the fused one here
for fused, label, expect in (
        ("off", "ta021 lb2 unfused", ("expand_bounds", "lb2_sweep")),
        (None, "ta021 lb2", ("fused_expand", "lb2_sweep"))):
    torch.cuda.reset_peak_memory_stats(DEV)
    (warm, start, s21, secs), counts, _ = path_run(
        label, expect, lambda: ta021_run(fused))
    peak = torch.cuda.max_memory_allocated(DEV)
    c21 = device.counters(s21)
    steps = c21.iters - warm.iters
    check(steps == TIMED and c21.best == 2297, f"{label} bench run")
    if fused is None:
        # the main path's launches; the bounds-only kernel is not among
        # them (the fused LB2 step runs at frame N and never spills)
        check(counts["expand_bounds"] == 0, f"{label}: bounds-only launches")
        LAUNCH_FROM.update(dict.fromkeys(("lb2_sweep", "fused_expand"),
                                         counts))
    # the same steps from the same state, eagerly, for the time and the
    # state
    torch.cuda.synchronize()
    t = time.perf_counter()
    e21 = eager_steps(t21, start, 2, CHUNK, TIMED, fused, check_each=False)
    torch.cuda.synchronize()
    eager_secs = time.perf_counter() - t
    check(same_state(s21, e21), f"{label}: graph run != eager steps")
    TA021[fused] = {"graph": 1e3 * secs / steps,
                    "eager": 1e3 * eager_secs / steps}
    say(f"{label} chunk {CHUNK}", steps=steps, graph_seconds=secs,
        eager_seconds=eager_secs,
        graph_evals_per_s=(c21.evals - warm.evals) / secs,
        eager_evals_per_s=(c21.evals - warm.evals) / eager_secs,
        pushed_per_s=(c21.tree - warm.tree) / secs,
        graph_ms_per_step=TA021[fused]["graph"],
        eager_ms_per_step=TA021[fused]["eager"], graph_equals_eager=True,
        pool=c21.size, capacity=s21.prmu.shape[1], peak_memory_bytes=peak,
        launches=counts)
    sync_free_step(label, t21, s21, 2, CHUNK, fused)

kernels_vs_plain("ta021 lb2 prefilter unfused", t21, s21, CHUNK, 20,
                 fused="off")


def graph_ms(fn, reps):
    """Device time of fn's work a call: fn captured once into a CUDA
    graph (after one eager call), its replays timed by CUDA events, so
    no host launch time stands between the operations."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return cuda_ms(g.replay, reps)


def tail_cost(state, reps=20):
    """The fused LB2 step's `_lb2_tail` on one popped chunk's survivors at
    frame N (what the step runs) and at N/4 (the JAX step's steady frame),
    by device time (`graph_ms`) and by CUDA events around eager calls;
    both push the same children."""
    st = clone(state)
    M = 20
    pp, pd, pa, n, start, valid = device.pop_chunk(st, CHUNK, M)
    pa = pa.to(torch.int32)
    best = torch.minimum(device._leaf_scan(t21, pp, pd, pa, valid)[0],
                         st.best)
    tile = device.lb2_route(20, M, 190, CHUNK)[1]
    kch, kaux, _, ksched, n_surv, _ = fz.fused_expand(
        t21, pp, pd, pa, n, best, lb_kind=1, tile=tile, cap_width=N21,
        with_sched=True)
    W = N21 // 4
    n_surv_i = int(n_surv.item())
    check(n_surv_i <= W, f"ta021 tail: {n_surv_i} survivors past N/4")
    limit = device.row_limit(st.prmu.shape[1], CHUNK, 20)

    def tail(width):
        return lambda: device._lb2_tail(
            t21, st, kch[:, :width], kaux[:, :width], ksched[:, :width],
            n_surv, best, start, limit)[1]

    pushed = [int(tail(w)().item()) for w in (N21, W)]
    check(pushed[0] == pushed[1], f"ta021 tail: {pushed} pushed")
    dev_ms = {w: graph_ms(tail(w), reps) for w in (N21, W)}
    ev_ms = {w: cuda_ms(tail(w), reps) for w in (N21, W)}
    say("ta021 fused lb2 tail, frame N against N/4", survivors=n_surv_i,
        pushed=pushed[0], device_ms_frame_n=dev_ms[N21],
        device_ms_frame_n4=dev_ms[W], extra_device_ms=dev_ms[N21] - dev_ms[W],
        event_ms_frame_n=ev_ms[N21], event_ms_frame_n4=ev_ms[W])


tail_cost(s21)

# --- phase 5: the J > 64 paths (ta071, 100x10; ta091, 200x10) -------------
BIGJ = (71, 91)
for inst in BIGJ:
    p = taillard.processing_times(inst)
    M, J = p.shape
    tb = batched.make_tables(p, device=DEV)
    route, tile, _ = device.lb2_route(J, M, M * (M - 1) // 2, 4096)
    # the LB2 kernel lane cap refuses the fused route: unfused prefilter
    check(route == "prefilter" and not fz.fused_ok(
        "hw", J, tile, 2, M, device=DEV), f"ta{inst:03d} route")
    s0 = device.init_state(J, 1 << 22, None, p_times=p, device=DEV)
    s, counts, secs = path_run(f"ta{inst:03d} lb2", (
        "expand_bounds", "lb2_sweep_bigj"),
        lambda: run_steps(tb, clone(s0), 2, 4096, 6))
    check(counts["fused_expand"] == 0, f"ta{inst:03d}: fused launches")
    check(same_state(s, graph_vs_eager(f"ta{inst:03d} lb2 chunk 4096", tb,
                                       s0, 2, 4096, 6)),
          f"ta{inst:03d}: two graph runs differ")
    sync_free_step(f"ta{inst:03d} lb2", tb, s0, 2, 4096)
    if inst == 71:
        LAUNCH_FROM["lb2_sweep_bigj"] = counts
    c = device.counters(s)
    say(f"ta{inst:03d} lb2 6 steps (J > 64, unfused prefilter)",
        tree=c.tree, evals=c.evals, seconds=round(secs, 3),
        equal_to_plain=True, launches=counts)

# --- phase 6: the fused route against the unfused one --------------------
UNFUSED_GOLDENS = [
    ("50x20 seed 51 lb2 unfused (prefilter, W=2)",
     np.asarray(m51["p"], np.int32).reshape(20, 50), 2, m51["ub"], 256,
     (19481, 0, 3691), ("expand_bounds", "lb2_sweep"), ("fused_expand",)),
    ("ta007 lb1 unfused", taillard.processing_times(7), 1, 1234, 4096,
     (271602, 28447, 1234), ("expand_bounds",), ("fused_expand",)),
]
for row in UNFUSED_GOLDENS:
    golden(*row, fused="off")

check(fz.fused_ok("hw", 20, device.lb2_route(20, 20, 190, CHUNK)[1], 2, 20,
                  device=DEV), "ta021 fused gate")


def fused_vs_others(label, tables, state, lb, chunk, steps):
    """`steps` steps from one state through the fused kernel, through the
    fused plain version and unfused (kernels), compared after every
    step."""
    a, b, c = clone(state), clone(state), clone(state)
    for k in range(steps):
        a = device.step(tables, lb, chunk, a)
        with plain_kernels():
            b = device.step(tables, lb, chunk, b)
        c = device.step(tables, lb, chunk, c, fused="off")
        check(same_state(a, b), f"{label} step {k + 1}: kernel != plain")
        check(same_state(a, c), f"{label} step {k + 1}: fused != unfused")
    ca = device.counters(a)
    say(f"{label} {steps} steps fused kernel vs plain vs unfused",
        equal=True, size=ca.size, tree=ca.tree)


fused_vs_others("ta021 lb2 fused", t21, s21, 2, CHUNK, 20)


def spill_run():
    """ta021 ub=inf from the root: nothing is pruned, so from the fifth
    step the LB1 survivors outgrow N/4 (where the JAX fused step spills).
    The fused step keeps them all at frame N: the bounds-only kernel
    never launches in it, and each step equals the unfused step."""
    a = device.init_state(20, 1 << 22, None, p_times=p21, telemetry=True,
                          device=DEV)
    c = clone(a)
    fused_bounds, survivors = 0, []
    real = fz.fused_expand

    def spy(*args, **kw):
        out = real(*args, **kw)
        survivors.append(out[4])
        return out

    fz.fused_expand = spy
    try:
        for k in range(6):
            before = kernels.LAUNCHES["expand_bounds"]
            a = device.step(t21, 2, CHUNK, a)
            fused_bounds += kernels.LAUNCHES["expand_bounds"] - before
            c = device.step(t21, 2, CHUNK, c, fused="off")
            check(same_state(a, c), f"ta021 ub=inf step {k + 1}: fused != "
                                    "unfused")
    finally:
        fz.fused_expand = real
    return a, fused_bounds, [int(x.item()) for x in survivors]


(sp, fused_bounds, survivors), counts, secs = path_run(
    "ta021 lb2 ub=inf", ("fused_expand", "expand_bounds"), spill_run)
check(fused_bounds == 0, "ta021 ub=inf: a fused step ran the bounds-only "
                         "kernel")
check(len(survivors) == 6 and max(survivors) > N21 // 4,
      f"ta021 ub=inf: survivors {survivors} never pass N/4")
csp = device.counters(sp)
say("ta021 lb2 ub=inf 6 steps, fused survivors past N/4 kept at frame N",
    survivors=survivors, size=csp.size, tree=csp.tree,
    equal_to_unfused=True, seconds=round(secs, 3), launches=counts)


def telemetry_case(label, inst, lb, chunk, steps):
    """Telemetry on the card: fused and unfused, kernels and plain
    versions (graph runs), and the eager steps, from one seeded state;
    every vector and counter equal."""
    p = taillard.processing_times(inst)
    tb = batched.make_tables(p, device=DEV)
    s0 = device.init_state(20, 1 << 22, taillard.optimal_makespan(inst),
                           p_times=p, telemetry=True, device=DEV)
    runs = {}
    for fused in ("off", "hw"):
        for plain in (False, True):
            with plain_kernels() if plain else contextlib.nullcontext():
                runs[fused, plain] = run_steps(tb, clone(s0), lb, chunk,
                                               steps, fused=fused)
        runs[fused, "eager"] = eager_steps(tb, clone(s0), lb, chunk, steps,
                                           fused=fused)
    ref = runs["off", False]
    check(bool(ref.telemetry.any()), f"{label}: telemetry is empty")
    for key, r in runs.items():
        check(same_state(ref, r), f"{label}: {key} != unfused kernels")
    sync_free_step(f"{label} telemetry", tb, s0, lb, chunk)
    sync_free_step(f"{label} telemetry", tb, s0, lb, chunk, "off")
    pruned = ref.telemetry[tele.O_PRUNED:tele.O_PRUNED + tele.DEPTH_BUCKETS]
    say(f"{label} telemetry {steps} steps, fused/unfused x kernel/plain "
        "graph runs and eager steps", equal=True,
        tree=device.counters(ref).tree,
        pruned=int(pruned.sum().item()))


telemetry_case("ta014 lb2 dense", 14, 2, 4096, 20)
telemetry_case("ta021 lb2 prefilter", 21, 2, CHUNK, 12)

# --- phase 7: segmented, checkpointed runs --------------------------------
SEG_DIR = Path(tempfile.mkdtemp(prefix="tts_chip_smoke_"))
SEG_ITERS, SEG_EVERY, SEG_HALF, SEG_END = 64, 4, 256, 512


def run21(state, target):
    return device.run(t21, state, 2, CHUNK, max_iters=target)


def mib(nbytes: int) -> float:
    return nbytes / (1 << 20)


def segmented_case(s0):
    """run_segmented from `s0` to SEG_HALF steps (a checkpoint every
    SEG_EVERY segments),
    load_resilient, grow into twice the capacity, run_segmented on to
    SEG_END. Returns the final state, the loaded state and the seconds of
    the load and of the grow."""
    ck = SEG_DIR / "ta021.npz"
    checkpoint.run_segmented(run21, clone(s0), segment_iters=SEG_ITERS,
                             checkpoint_path=ck, checkpoint_every=SEG_EVERY,
                             max_total_iters=SEG_HALF, heartbeat=None)
    t = time.perf_counter()
    loaded, meta, used = checkpoint.load_resilient(ck, device=DEV)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    check(used == ck and int(meta["segment"]) == SEG_HALF // SEG_ITERS,
          f"ta021 segmented: loaded {used}, meta {meta}")
    t = time.perf_counter()
    grown = checkpoint.grow(loaded, 2 * loaded.prmu.shape[1])
    torch.cuda.synchronize()
    grow_s = time.perf_counter() - t
    out = checkpoint.run_segmented(
        run21, grown, segment_iters=SEG_ITERS, checkpoint_path=ck,
        checkpoint_every=SEG_EVERY, max_total_iters=SEG_END - SEG_HALF,
        heartbeat=None)
    return out, loaded, load_s, grow_s


def plain_run(telemetry: bool):
    """The plain loop from the root: one run to SEG_END, timed from step
    SEG_ITERS on (after its graph's capture). Returns the root state, the
    final state and its ms per step."""
    root = device.init_state(20, 1 << 22, taillard.optimal_makespan(21),
                             p_times=p21, telemetry=telemetry, device=DEV)
    s = device.run(t21, clone(root), 2, CHUNK, max_iters=SEG_ITERS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    s = device.run(t21, s, 2, CHUNK, max_iters=SEG_END)
    torch.cuda.synchronize()
    return root, s, 1e3 * (time.perf_counter() - t) / (SEG_END - SEG_ITERS)


# the telemetry vector's cost, then the reference with it on
_, off, plain_off_ms = plain_run(False)
del off
device.clear_graphs()
s0, ref, plain_ms = plain_run(True)
REG = obs_metrics.Registry("tts")
base_mem = torch.cuda.memory_allocated(DEV)
prev_reg = obs_metrics.install(REG)
torch.cuda.reset_peak_memory_stats(DEV)
(seg_out, seg_loaded, load_s, grow_s), counts, secs = path_run(
    "ta021 segmented", ("fused_expand", "lb2_sweep"),
    lambda: segmented_case(s0))
seg_peak = torch.cuda.max_memory_allocated(DEV)
in_graph = {k: kernels.REPLAYED[k] for k in ("fused_expand", "lb2_sweep")}
obs_metrics.install(prev_reg)
check(counts["expand_bounds"] == 0, "ta021 segmented: bounds-only launches")
check(all(v > 0 for v in in_graph.values()),
      f"ta021 segmented: kernels outside graph replays {in_graph}")
rc_ = device.counters(ref)
check(rc_.iters == SEG_END and rc_.size > 0 and rc_.best == 2297,
      f"ta021 plain run {rc_}")
check(same_state(seg_out, ref), "ta021 segmented + checkpoint + load + grow "
                                "!= one device.run (counters, live rows or "
                                "telemetry)")
check(seg_out.prmu.shape[1] == 1 << 23, "ta021 segmented: grown capacity")
LAUNCH_FROM.update(dict.fromkeys(("lb2_sweep", "fused_expand"), counts))
saves = REG.histogram("tts_checkpoint_save_seconds").snapshot()
nbytes = REG.histogram("tts_checkpoint_bytes").snapshot()
segs = REG.histogram("tts_segment_seconds").snapshot()
gaps = REG.histogram("tts_segment_gap_seconds").snapshot()
check(saves["count"] * SEG_EVERY == SEG_END // SEG_ITERS == segs["count"],
      f"ta021 segmented: {saves['count']} saves, {segs['count']} segments")
mem_after = torch.cuda.memory_allocated(DEV)
res_after = torch.cuda.memory_reserved(DEV)
graphs = len(device._GRAPHS)
device.clear_graphs()
torch.cuda.empty_cache()
say("ta021 segmented vs one run (telemetry on)", equal=True,
    segments=segs["count"], segment_iters=SEG_ITERS, steps=SEG_END,
    size=rc_.size, tree=rc_.tree, seconds=secs,
    segment_seconds_mean=segs["sum"] / segs["count"],
    segment_ms_per_step=1e3 * segs["sum"] / SEG_END,
    plain_run_ms_per_step=plain_ms,
    plain_run_ms_per_step_telemetry_off=plain_off_ms,
    saves=saves["count"], save_seconds_mean=saves["sum"] / saves["count"],
    save_bytes_mean=nbytes["sum"] / nbytes["count"],
    gap_seconds_mean=gaps["sum"] / max(gaps["count"], 1),
    gaps=gaps["count"], load_seconds=load_s, grow_seconds=grow_s,
    loaded_rows=device.counters(seg_loaded).size,
    peak_memory_bytes=seg_peak, allocated_at_start=base_mem,
    peak_over_start_bytes=seg_peak - base_mem, allocated_after=mem_after,
    reserved_after=res_after, graphs_cached=graphs,
    allocated_after_clear_graphs=torch.cuda.memory_allocated(DEV),
    reserved_after_clear_graphs=torch.cuda.memory_reserved(DEV),
    launches=counts, in_graph=in_graph)
del seg_loaded

# save and load of the 512-step pool, timed alone; the device copy that
# makes a retry safe, at its live rows and at the pool's whole usable
# height
live = device.counters(seg_out).size
ck = SEG_DIR / "alone.npz"
t = time.perf_counter()
checkpoint.save(ck, seg_out)
save_s = time.perf_counter() - t
t = time.perf_counter()
back, _ = checkpoint.load(ck, device=DEV)
torch.cuda.synchronize()
load1_s = time.perf_counter() - t
check(same_state(back, seg_out), "ta021 save + load != the state saved")
del back
limit21 = device.row_limit(1 << 22, CHUNK, 20)
copy_ms = {n: cuda_ms(lambda n=n: checkpoint._segment_copy(seg_out, n), 10)
           for n in (live, limit21)}
saved = checkpoint._segment_copy(seg_out, live)
restore_ms = cuda_ms(lambda: checkpoint._restore(seg_out, saved), 10)
check(same_state(seg_out, ref), "ta021: the restore changed the state")
row_bytes = 2 * 20 + 2 + 2 * 20
say("ta021 checkpoint of the 512-step pool", live_rows=live,
    live_bytes=live * row_bytes, file_bytes=ck.stat().st_size,
    save_seconds=save_s, load_seconds=load1_s,
    device_copy_ms=copy_ms[live], device_copy_bytes=live * row_bytes,
    restore_ms=restore_ms, device_copy_ms_row_limit=copy_ms[limit21],
    row_limit=limit21, device_copy_bytes_row_limit=limit21 * row_bytes)
del saved


def retry_drill():
    """64-step segments to SEG_END; segment 3 runs (in place) and then
    raises an injected fault once: run_segmented copies the state it kept
    back into the same tensors and retries, replaying the same graph."""
    failed = []

    def flaky(state, target):
        out = run21(state, target)
        if target == 3 * SEG_ITERS and not failed:
            failed.append(device.counters(out).iters)
            raise faults.InjectedFault("injected after segment 3 stepped")
        return out

    out = checkpoint.run_segmented(flaky, clone(s0), segment_iters=SEG_ITERS,
                                   max_total_iters=SEG_END, heartbeat=None,
                                   retry_attempts=2, retry_base_s=0.0)
    return out, failed


(r_out, failed), counts, secs = path_run("ta021 segment retry",
                                         ("fused_expand", "lb2_sweep"),
                                         retry_drill)
check(failed == [3 * SEG_ITERS], f"ta021 retry drill: failed at {failed}")
check(same_state(r_out, ref), "ta021 retried segment != one device.run")
say("ta021 segment retried after it stepped in place", equal=True,
    failed_at_iters=failed[0], seconds=secs, launches=counts)
del r_out, seg_out, ref
device.clear_graphs()

# the CLI's drills (ta014 LB2, dense): the golden capacity (2^20) and chunk
T14 = ["pfsp", "-i", "14", "-l", "2", "-u", "1", "--chunk", "4096",
       "--segment-iters", "8"]
GOLDEN14 = ("Size of the explored tree: 144639",
            "Number of explored solutions: 0", "Optimal makespan: 1377")


def cli_run(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def cli_golden(label, rc, text):
    check(rc == 0, f"{label}: exit code {rc}")
    for want in GOLDEN14:
        check(want in text, f"{label}: output lacks {want!r}")


def stop_and_resume():
    ck = str(SEG_DIR / "t14.npz")
    args = T14 + ["--capacity", "1048576", "--checkpoint", ck]
    first = cli_run(args + ["--max-iters", "16"])
    return first, cli_run(args)


(first, second), counts, secs = path_run(
    "ta014 cli stop/resume", ("expand_fronts", "lb2_sweep"), stop_and_resume)
check(first[0] == 0 and "truncated run" in first[1]
      and "[segment 2] iters=16 " in first[1], "ta014 cli stop at 16")
check("Resumed from" in second[1] and "(segment 2, iters 16," in second[1],
      "ta014 cli resume")
cli_golden("ta014 cli resume", second[0], second[1])
say("ta014 lb2 cli: stop at 16 steps, resume", golden=True, seconds=secs,
    launches=counts, segment_lines=[ln for ln in (first[1] + second[1])
                                    .splitlines() if ln.startswith("[")])

ck = str(SEG_DIR / "t14c.npz")
args = T14 + ["--capacity", "1048576", "--checkpoint", ck]
rc, _, _ = cli_run(args + ["--max-iters", "16", "--faults",
                           "corrupt_checkpoint=2"])
check(rc == 0 and faults.active() is None, "ta014 cli corrupt drill")
rc, text, err = cli_run(args)
check("(segment 1, iters 8," in text and "last-good" in err,
      "ta014 cli: no rollback to the last-good snapshot")
cli_golden("ta014 cli rollback", rc, text)
say("ta014 lb2 cli: snapshot corrupted at segment 2, rolled back", golden=True)

ck = str(SEG_DIR / "t14o.npz")
rc, _, err = cli_run(T14 + ["--capacity", "86016", "--checkpoint", ck])
check(rc == 1 and "error: pool overflow" in err, f"ta014 cli overflow: {rc}")
rc, text, _ = cli_run(T14 + ["--capacity", "86016", "--checkpoint", ck,
                             "--grow-capacity", "1048576"])
cli_golden("ta014 cli grow", rc, text)
say("ta014 lb2 cli: overflow (exit 1), then --grow-capacity", golden=True)
shutil.rmtree(SEG_DIR)

# every kernel launched inside a captured graph on some phase
for k in ("expand_bounds", "expand_emit", "expand_fronts", "lb2_sweep",
          "lb2_sweep_bigj", "fused_expand"):
    check(IN_GRAPHS[k] > 0, f"kernel {k} never launched in a graph replay")
say("launches in graph replays", **IN_GRAPHS)

# --- phase 8: each kernel against its plain version -----------------------
RESULTS = []


def bound(nbytes, nops, ops_per_s=INT32_OPS_PER_S):
    """(bound_ms, bound_by): the least time the card could take, from the
    bytes moved and the operations done."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * nops / ops_per_s
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def record(name, replaces, source, launches_key, err, ms, plain_ms,
           nbytes, nops, shape, ops_per_s=INT32_OPS_PER_S):
    bound_ms, bound_by = bound(nbytes, nops, ops_per_s)
    RESULTS.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": LAUNCH_FROM[launches_key][launches_key],
        "launches_key": launches_key,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "shape": shape})


def max_err(x, y, where=None):
    d = (x.long() - y.long()).abs()
    if where is not None:
        d = torch.where(where, d, 0)
    return int(d.max().item())


def popcount_cols(words: torch.Tensor) -> torch.Tensor:
    w = words.long() & 0xFFFFFFFF
    return sum(((w >> k) & 1).sum(dim=0) for k in range(32))


def garbage_past(prmu_T, depth2, front_T, n_valid: int, seed: int):
    """The chunk with its columns past `n_valid` replaced by garbage, as a
    pool holds past its popped count: job ids anywhere in [0, J) (repeats
    too), depths anywhere in [0, J], any front."""
    J, B = prmu_T.shape
    n = B - n_valid
    g = torch.Generator(device=DEV).manual_seed(seed)
    prmu_T, depth2, front_T = prmu_T.clone(), depth2.clone(), front_T.clone()
    prmu_T[:, n_valid:] = torch.randint(0, J, (J, n), generator=g,
                                        device=DEV, dtype=torch.int16)
    depth2[:, n_valid:] = torch.randint(0, J + 1, (1, n), generator=g,
                                        device=DEV, dtype=torch.int32)
    front_T[:, n_valid:] = torch.randint(0, 5000, (front_T.shape[0], n),
                                         generator=g, device=DEV,
                                         dtype=torch.int32)
    return prmu_T, depth2, front_T


MODES = ("bounds", "emit", "fronts")


def expand_case(label, tables, prmu_T, depth2, front_T, lb, reps,
                tile=None, modes=("bounds", "emit")):
    """The expand kernel against its plain version on one chunk, in each
    of `modes`: bounds-only (compared at the real child slots), emit (every
    output, every column) and the dense route's fronts-only launch (LB1
    only; fronts and words, every column). Timed when reps > 0. Returns
    {mode: (err, ms, plain_ms, nbytes, nops)}."""
    J, B = prmu_T.shape
    M = front_T.shape[0]
    SW = ex.sched_words(J)
    if tile is None:
        tile = ex.effective_tile(J, B, 1024, lb, machines=M)
    G = B // tile
    real = columns.child_masks(depth2, torch.ones(B, dtype=torch.bool,
                                                  device=DEV), G, J, tile)[1]
    n_real = int(real.sum().item())
    nin = J * B * 2 + B * 4 + M * B * 4 + (M * J + M) * 4
    remain_ops = int((J - depth2).clamp(min=0).sum().item()) * M
    args = (tables, prmu_T, depth2, front_T)
    out = {}
    for mode in modes:
        if mode == "emit":
            launch = lambda: kernels.expand_bound(  # noqa: E731
                *args, lb, tile, True)
            plain = lambda: ex.expand_plain(*args, lb, tile)  # noqa: E731
            err = max(max_err(x, y) for x, y in zip(launch(), plain()))
            nbytes = nin + B * J * (4 + 2 * J + 4 * (M + 1))
            nops = remain_ops + B * J * 7 * M
        elif mode == "bounds":
            launch = lambda: kernels.expand_bound(  # noqa: E731
                *args, lb, tile, False)
            plain = lambda: ex.expand_bounds_plain(  # noqa: E731
                *args, lb, tile)
            err = max_err(launch()[2], plain(), real)
            nbytes = nin + B * J * 4
            nops = remain_ops + n_real * (7 if lb == 1 else 5) * M
        else:
            check(lb == 1, "the fronts-only launch runs LB1's chain")
            launch = lambda: kernels.expand_fronts(  # noqa: E731
                *args, tile)
            plain = lambda: ex.expand_fronts_plain(  # noqa: E731
                *args, tile)
            err = max(max_err(x, y) for x, y in zip(launch(), plain()))
            # the prefix words of each parent, then the front chain (a max
            # and an add a machine) and one word operation per child
            nbytes = nin - M * 4 + B * J * 4 * (M + SW)
            nops = (int(depth2.clamp(0, J).sum().item())
                    + B * J * (2 * M + SW))
        check(err == 0, f"expand_bound {label} lb{lb} {mode}: max abs err "
                        f"{err}")
        ms = event_ms = plain_ms = None
        if reps:
            ms = kernel_ms(launch, reps)
            event_ms = cuda_ms(launch, reps)
            plain_ms = cuda_ms(plain, max(2, reps // 10))
        out[mode] = (err, ms, plain_ms, nbytes, nops)
        say(f"expand_bound {label} lb{lb} {mode}", J=J, B=B, tile=tile,
            max_abs_err=err, ms=ms, event_ms=event_ms, plain_ms=plain_ms,
            bound_ms=bound(nbytes, nops)[0] if reps else None)
    return out


def lb2_case(label, tables, cf, sched, reps, live=None):
    """The sweep kernel against its plain version on (M, n) columns, with
    `live` (None: n) counting the live leading ones, read by the kernel
    from device memory; timed when reps > 0. Bytes and operations are
    the live columns' (each reads its fronts and words and writes its
    bound) plus one write of each dead column."""
    M, n = cf.shape
    P, J = tables.js.shape
    lv = None if live is None else torch.full((), live, dtype=torch.int32,
                                              device=DEV)
    k = kernels.lb2_sweep(tables, cf, sched, lv)
    pl = ex.mask_live(ex.lb2_plain(tables, sched, cf), lv)
    err = max_err(k, pl)
    check(err == 0, f"lb2_sweep {label}: max abs err {err}")
    ms = event_ms = plain_ms = None
    if reps:
        ms = kernel_ms(lambda: kernels.lb2_sweep(tables, cf, sched, lv),
                       reps)
        event_ms = cuda_ms(lambda: kernels.lb2_sweep(tables, cf, sched, lv),
                           reps)
        plain_ms = cuda_ms(lambda: ex.mask_live(
            ex.lb2_plain(tables, sched, cf), lv), 2)
    nl = n if live is None else max(0, min(live, n))
    unsched = int((J - popcount_cols(sched[:, :nl])).sum().item())
    nbytes = (nl * (M * 4 + sched.shape[0] * 4 + 4) + (n - nl) * 4
              + P * J * 16 + P * 16)
    nops = P * unsched * 4 + P * nl * 4
    say(f"lb2_sweep {label}", J=J, P=P, n=n, live=live, max_abs_err=err,
        ms=ms, event_ms=event_ms, plain_ms=plain_ms)
    return err, ms, plain_ms, nbytes, nops


SRC_E = "tpu_tree_search_torch/csrc/expand_bound.cu"
SRC_L = "tpu_tree_search_torch/csrc/lb2_sweep.cu"
PE = "tpu_tree_search/ops/pallas_expand.py"

# a realistic popped chunk: the top of the ta021 pool after the bench run
pp, pd, pa, n_pop, _, _ = device.pop_chunk(s21, CHUNK, 20)
check(int(n_pop) == CHUNK, "ta021 pool holds a full chunk")
BEST21 = device.counters(s21).best
pa = pa.to(torch.int32).contiguous()
main_shape = {}
for lb in (1, 0):
    main_shape[lb] = expand_case("ta021", t21, pp, pd, pa, lb, 50,
                                 modes=MODES if lb == 1 else MODES[:2])
expand_case("ta021, garbage past the popped count", t21,
            *garbage_past(pp, pd, pa, CHUNK - 12345, 21), 1, 0, modes=MODES)
for J, M, B, inst in ((50, 20, 16384, 51), (100, 10, 8192, 71),
                      (200, 10, 4096, 91)):
    p = taillard.processing_times(inst)
    tb = batched.make_tables(p, device=DEV)
    expand_case(f"ta{inst:03d}", tb, *random_chunk(p, B, inst, DEV), 1, 10)
# the J > 64 LB2 pre-prune at its route's tile, on the chunk its path pops
# after 3 steps from the root (kernel_times.py's); and J = 500 at TB 32,
# where a warp holds a whole tile
for inst in BIGJ:
    tb, *chunk_, tile = pool_chunk(inst, 4096, 3, DEV)
    expand_case(f"ta{inst:03d} prefilter chunk 4096", tb, *chunk_, 1, 20,
                tile, modes=MODES)
    expand_case(f"ta{inst:03d} prefilter chunk 4096, garbage", tb,
                *garbage_past(*chunk_, 2862, inst), 1, 0, tile, modes=MODES)
p111 = taillard.processing_times(111)
t111 = batched.make_tables(p111, device=DEV)
c111 = random_chunk(p111, 1024, 111, DEV)
for lb in (1, 0):
    expand_case("ta111", t111, *c111, lb, 0, 32,
                modes=MODES if lb == 1 else MODES[:2])
expand_case("ta111, garbage", t111, *garbage_past(*c111, 700, 111), 1, 0, 32,
            modes=MODES)

err, ms, plain_ms, nb, no = main_shape[1]["bounds"]
record("expand_bound (bounds-only)", f"{PE}:81", SRC_E, "expand_bounds",
       err, ms, plain_ms, nb, no, f"ta021 chunk {CHUNK}, LB1")
# the dense route's chunks, popped from the states its parity run began at:
# the expand kernel at the route's tile (LB1, feeding the pair sweep), and
# the sweep of every pair over the whole child grid
for inst, (p, tb, s, chunk) in DENSE.items():
    M = p.shape[0]
    tile = device.lb2_route(20, M, int(tb.ma0.shape[0]), chunk)[1]
    dp, dd, da, n_pop, _, _ = device.pop_chunk(s, chunk, M)
    check(int(n_pop) == chunk, f"ta{inst:03d} pool holds a full chunk")
    da = da.to(torch.int32).contiguous()
    for lb in (1, 0):
        res = expand_case(f"ta{inst:03d} dense", tb, dp, dd, da, lb, 50,
                          tile, modes=MODES if lb == 1 else MODES[:2])
        if inst == 14 and lb == 1:
            dense_emit = res["emit"]
    expand_case(f"ta{inst:03d} dense, garbage", tb,
                *garbage_past(dp, dd, da, chunk - 100, inst), 1, 0, tile,
                modes=MODES)
    cf = ex.expand_plain(tb, dp, dd, da, 1, tile)[1][:M]
    lb2_case(f"ta{inst:03d} dense", tb, cf, ex.sched_mask_cols(dp, dd, tile),
             20)
err, ms, plain_ms, nb, no = dense_emit
record("expand_bound (emit)", f"{PE}:73", SRC_E, "expand_emit", err, ms,
       plain_ms, nb, no, "ta014 dense route, chunk 4096, LB1, every output")
# the dense route at its widest: ta041's next chunk (N = 3,276,800)
tile41 = device.lb2_route(50, 10, 45, CHUNK)[1]
c41 = device.pop_chunk(s41, CHUNK, 10)
check(int(c41[3]) == CHUNK, "ta041 pool holds a full chunk")
c41 = (c41[0], c41[1], c41[2].to(torch.int32).contiguous())
res41 = expand_case("ta041 dense", t41, *c41, 1, 20, tile41, modes=MODES)
expand_case("ta041 dense, garbage", t41, *garbage_past(*c41, CHUNK - 4321, 41),
            1, 0, tile41, modes=MODES)
err, ms, plain_ms, nb, no = res41["fronts"]
record("expand_bound (fronts-only)", f"{PE}:73", SRC_E, "expand_fronts", err,
       ms, plain_ms, nb, no, f"ta041 dense route, chunk {CHUNK}, TB "
                             f"{tile41}: the child fronts and words only")

# ta021 sweeps on the chunk's real child columns: the 24-pair head and
# 166-pair tail over the N/4 frame the prefilter route sweeps in its steady
# state, and all 190 pairs over the whole grid as a further parity check
aux21 = ex.expand_plain(t21, pp, pd, pa, 1, 1024)[1][:20]
sched21 = ex.sched_mask_cols(pp, pd, 1024)
head, tail = batched.pair_split(t21, batched.PAIR_PREFILTER)
lb2_case("ta021 190 pairs", t21, aux21, sched21, 20)
W4 = aux21.shape[1] // 4
lb2_case("ta021 24-pair head", head, aux21[:, :W4], sched21[:, :W4], 20)
lb2_case("ta021 166-pair tail", tail, aux21[:, :W4], sched21[:, :W4], 20)
# the main path's launch: the whole frame N, the live count on the device
# (here N/4, the prefix swept above)
tail_r = lb2_case("ta021 166-pair tail, frame N, live N/4", tail, aux21,
                  sched21, 20, live=W4)
for live in (0, 1, 4321, W4 - 37, N21, N21 + 5):
    lb2_case(f"ta021 24-pair head, frame N, live {live}", head, aux21,
             sched21, 0, live=live)
# edges: one column, widths that are no multiple of a block's columns,
# and column prefixes of the wider frame (row strides > n), head and tail
for n in (1, 1000, 12345, W4 - 37):
    lb2_case(f"ta021 24-pair head n={n}", head, aux21[:, :n],
             sched21[:, :n], 3)
    lb2_case(f"ta021 166-pair tail n={n}", tail, aux21[:, :n],
             sched21[:, :n], 3)
err, ms, plain_ms, nb, no = tail_r
record("lb2_sweep (J <= 64)", f"{PE}:488", SRC_L, "lb2_sweep", err, ms,
       plain_ms, nb, no, f"ta021 166-pair tail over a frame of {N21} child "
                         f"columns, {W4} of them live", FP32_OPS_PER_S)
big = None
for inst, B in ((51, 4096), (71, 2048), (91, 1024), (111, 512)):
    p = taillard.processing_times(inst)
    tb = batched.make_tables(p, device=DEV)
    prmu_T, depth2, front_T = random_chunk(p, B, inst, DEV)
    cf = ex.expand_plain(tb, prmu_T, depth2, front_T, 1, B)[1][:p.shape[0]]
    sched = ex.sched_mask_cols(prmu_T, depth2, B)
    r = lb2_case(f"ta{inst:03d}", tb, cf, sched, 5)
    for n in (1, cf.shape[1] // 3 + 1):
        lb2_case(f"ta{inst:03d} n={n}", tb, cf[:, :n], sched[:, :n], 3)
        lb2_case(f"ta{inst:03d} live {n}", tb, cf, sched, 0, live=n)
    if inst == 71:
        big = r
err, ms, plain_ms, nb, no = big
record("lb2_sweep (J > 64)", f"{PE}:639", SRC_L, "lb2_sweep_bigj", err, ms,
       plain_ms, nb, no, "ta071 45 pairs over 204800 child columns",
       FP32_OPS_PER_S)


def fused_err(label, k, want, width) -> int:
    """Largest difference between two fused outputs over the survivors
    [0, min(n_surv, W)), the histogram and the count."""
    n_surv = int(want[4].item())
    check(int(k[4].item()) == n_surv, f"fused {label}: n_surv "
                                      f"{int(k[4].item())} != {n_surv}")
    n = min(n_surv, width)
    err = 0
    for x, y in zip(k[:4], want[:4]):
        check((x is None) == (y is None) and (x is None or x.dtype ==
                                              y.dtype), f"fused {label}")
        if x is not None and n:
            err = max(err, max_err(x[:, :n], y[:, :n]))
    if want[5] is not None:
        err = max(err, max_err(k[5], want[5]))
    return err


def fused_case(label, tables, prmu_T, depth2, front_T, cap, tile, width,
               with_sched, bins, with_bounds, aux_i16, reps, n_valid=None):
    """The fused kernel against its plain version on one chunk: every
    output over the survivors, the count and the histogram; then the same
    launch again, whose outputs must equal the first's."""
    J, B = prmu_T.shape
    M = front_T.shape[0]
    n_valid = B if n_valid is None else n_valid
    capt = torch.full((), cap, dtype=torch.int32, device=DEV)
    args = (tables, prmu_T, depth2, front_T, n_valid, capt, tile, width,
            with_sched, bins, with_bounds, aux_i16)
    k = kernels.fused_expand(*args)
    pl = fz.fused_expand_plain(tables, prmu_T, depth2, front_T, n_valid,
                               capt, 1, tile, width, with_sched, bins,
                               with_bounds, aux_i16)
    n_surv = int(pl[4].item())
    err = fused_err(label, k, pl, width)
    check(err == 0, f"fused {label}: max abs err {err}")
    check(fused_err(label, kernels.fused_expand(*args), k, width) == 0,
          f"fused {label}: a second launch differs from the first")
    ms = kernel_ms(lambda: kernels.fused_expand(*args), reps)
    event_ms = cuda_ms(lambda: kernels.fused_expand(*args), reps)
    plain_ms = cuda_ms(lambda: fz.fused_expand_plain(
        tables, prmu_T, depth2, front_T, n_valid, capt, 1, tile, width,
        with_sched, bins, with_bounds, aux_i16), 2)
    # bytes: every input read once, the survivor frame written once;
    # operations: the remain sums and the LB1 chain of every real child
    valid = torch.arange(B, device=DEV) < n_valid
    real = columns.child_masks(depth2, valid, B // tile, J, tile)[1]
    n_real = int(real.sum().item())
    n = min(n_surv, width)
    per_col = (J * 2 + (M + 1) * (2 if aux_i16 else 4)
               + 4 * with_bounds + 4 * ex.sched_words(J) * with_sched)
    nbytes = (J * B * 2 + B * 4 + M * B * 4 + (M * J + M + 1) * 4
              + n * per_col + 4 + 8 * bins)
    nops = int((J - depth2).sum().item()) * M + n_real * 7 * M
    say(f"fused_expand {label}", J=J, M=M, B=B, tile=tile, W=width,
        n_valid=n_valid, n_surv=n_surv, max_abs_err=err, twice_equal=True,
        ms=ms, event_ms=event_ms, plain_ms=plain_ms,
        bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S,
                           nops / INT32_OPS_PER_S))
    return err, ms, plain_ms, nbytes, nops


SRC_F = "tpu_tree_search_torch/csrc/fused_expand.cu"
PF = "tpu_tree_search/ops/pallas_fused.py"
# the main-path row: the popped ta021 chunk at the fused LB2 route's shape
# (TB 512, frame N, scheduled-set words, telemetry off), pruned at the
# incumbent
tb21 = device.lb2_route(20, 20, 190, CHUNK)[1]
fused_main = fused_case("ta021 prefilter", t21, pp, pd, pa, BEST21, tb21,
                        N21, True, 0, False, False, 20)
for inst, B, lb, sched, bins, bounds, i16 in (
        (7, 4096, 1, False, 8, True, True),      # LB1 with telemetry
        (51, 16384, 2, True, 0, False, False),   # two scheduled-set words
        (91, 4096, 1, False, 0, False, True)):   # J = 200, TB 128
    p = taillard.processing_times(inst)
    M, J = p.shape
    tb = batched.make_tables(p, device=DEV)
    tile = (device.lb2_route(J, M, M * (M - 1) // 2, B)[1] if lb == 2
            else 128 if J == 200 else
            ex.effective_tile(J, B, 1024, lb, machines=M))
    width = B * J // 4 if lb == 2 else B * J
    fused_case(f"ta{inst:03d}", tb, *random_chunk(p, B, inst, DEV),
               taillard.optimal_makespan(inst), tile, width, sched, bins,
               bounds, i16, 10)
# edges: part of the chunk valid; no incumbent, so the survivors outgrow
# the N/4 frame (n_surv exact past W, stores stop there); three chunks
# launched back to back on one stream, each against its plain version
W21 = CHUNK * 20 // 4
fused_case("ta021 n_valid < B", t21, pp, pd, pa, BEST21, tb21, W21, True,
           8, True, False, 5, n_valid=CHUNK - 12345)
fused_case("ta021 spill", t21, pp, pd, pa, 10 ** 6, tb21, W21, True, 8,
           False, True, 5)
chunks = [random_chunk(p21, CHUNK, seed, DEV) for seed in (1, 2, 3)]
capt = torch.full((), BEST21, dtype=torch.int32, device=DEV)
outs = [kernels.fused_expand(t21, *c, CHUNK, capt, tb21, W21, True, 8, False,
                             False) for c in chunks]
for seed, c, o in zip((1, 2, 3), chunks, outs):
    err = fused_err(f"back to back {seed}", o, fz.fused_expand_plain(
        t21, *c, CHUNK, capt, 1, tb21, W21, True, 8, False, False), W21)
    check(err == 0, f"fused back to back {seed}: max abs err {err}")
say("fused_expand ta021 three chunks back to back", equal_to_plain=True,
    n_surv=[int(o[4].item()) for o in outs])

err, ms, plain_ms, nb, no = fused_main
record("fused_expand", f"{PF}:165", SRC_F, "fused_expand", err, ms,
       plain_ms, nb, no, f"ta021 chunk {CHUNK}, TB {tb21}, W = N, "
                         "scheduled-set words")

# --- phase 9: the problem-plugin engine -----------------------------------
device.clear_graphs()
CARD = smi.splitlines()[0]
PLUGIN_MS = {}


def plugin_solve(label, name, table, lb, chunk, capacity, want=None,
                 argv=None):
    """One `device.solve` on the card (through the command `argv` when
    given), its launches read around it; a generic plugin launches none
    of the five kernels. Reports wall time, steps, ms per step (growth
    and captures included) and peak memory."""
    torch.cuda.reset_peak_memory_stats(DEV)
    with recording(device, "solve") as got:
        if argv is None:
            _, counts, secs = path_run(label, (), lambda: device.solve(
                name, table, lb_kind=lb, chunk=chunk, capacity=capacity,
                device=DEV))
        else:
            (rc, text, _), counts, secs = path_run(
                label, (), lambda: cli_run(argv))
            check(rc == 0, f"{label}: exit code {rc}")
    res = got[-1]
    check(res.complete and not res.overflow, f"{label}: incomplete")
    if name != "pfsp":
        check(not any(counts.values()), f"{label}: kernels {counts}")
    if want is not None:
        check(res[:len(want)] == want, f"{label}: {res[:3]} != {want}")
    say(label, tree=res.explored_tree, sol=res.explored_sol, best=res.best,
        steps=res.iters, seconds=secs, ms_per_step=1e3 * secs / res.iters,
        peak_memory_bytes=torch.cuda.max_memory_allocated(DEV), card=CARD,
        launches=counts)
    return res


def plugin_graph_vs_eager(label, name, table, lb, chunk, capacity,
                          warm=4, steps=2 * device.GRAPH_STEPS):
    """From the root: `warm` steps through `run_problem` (one replay of its
    capture), then up to `steps` more timed (graph replays, no capture;
    fewer where the search ends), against the same
    steps taken eagerly from the warm state; then one step with every
    synchronizing CUDA call an error. Returns the graph loop's ms per
    step."""
    prob = problems.get(name)
    tb = prob.make_tables(table, device=DEV)
    p0, d0 = prob.root(table)
    s = device.init_state(prob.slots(table), capacity, None, prmu0=p0,
                          depth0=d0, aux0=prob.seed_aux(table, p0, d0),
                          aux_dtype=prob.aux_dtype(table), device=DEV)
    torch.cuda.synchronize()
    t = time.perf_counter()
    s = device.run_problem(prob, tb, s, lb, chunk, max_iters=warm)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    e = clone(s)
    k0 = device.counters(s)
    torch.cuda.synchronize()
    t = time.perf_counter()
    g = device.run_problem(prob, tb, s, lb, chunk, max_iters=warm + steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    kg = device.counters(g)
    fn = prob.make_step(tb, lb, chunk, 1024, None)
    for _ in range(kg.iters - k0.iters):
        e = fn(e)
    check(not kg.overflow and kg.iters > k0.iters,
          f"{label}: overflow or no step")
    check(same_state(g, e), f"{label}: graph run != eager steps")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(clone(g))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ms = 1e3 * secs / (kg.iters - k0.iters)
    PLUGIN_MS[label] = ms
    say(f"{label}: graph vs eager", equal=True, steps=kg.iters - k0.iters,
        graph_ms_per_step=ms, capture_and_first_replay_seconds=capture_s,
        size=kg.size, tree=kg.tree, syncs=0, card=CARD)
    device.clear_graphs()
    return ms


# N-Queens: N = 15 through the command (the published count, OEIS A000170,
# and the JAX package's recorded tree, BENCHMARKS.md), N = 10 on the card
# against the plain run on the host
NQ15 = (171_129_071, 2_279_184)
plugin_solve("nqueens N=15 g=1 chunk 65536 (cli)", "nqueens", None, 0, None,
             None, want=NQ15, argv=["nqueens", "-N", "15", "--chunk",
                                    "65536"])
plugin_graph_vs_eager("nqueens N=15 chunk 65536", "nqueens",
                      nqueens.table(15), 0, 65536, 1 << 22)
on_cpu = device.solve("nqueens", nqueens.table(10), chunk=256,
                      capacity=1 << 16, device="cpu")
oracle = sequential.nqueens_search(10)
plugin_solve("nqueens N=10 chunk 256", "nqueens", nqueens.table(10), 0,
             256, 1 << 16, want=(oracle.explored_tree, 724))
check(on_cpu[:2] == (oracle.explored_tree, 724), "nqueens 10 on the host")

# knapsack: 1000 items, both bounds, against the DP optimum
KS = knapsack.KnapsackInstance.synthetic(1000, seed=0)
KS_OPT = KS.optimum()
for lb in (1, 2):
    res = plugin_solve(f"knapsack n=1000 lb{lb} chunk 4096", "knapsack",
                       KS.table, lb, 4096, 1 << 20)
    check(res.best == -KS_OPT, f"knapsack lb{lb}: {-res.best} != {KS_OPT}")
    plugin_graph_vs_eager(f"knapsack n=1000 lb{lb} chunk 4096", "knapsack",
                          KS.table, lb, 4096, 1 << 20)

# TSP: n = 10 at both bounds against brute force; TSP_N, the largest n whose
# LB2 solve ends within about 10 s on the card (`solve --problem tsp
# --size n -l 2` swept over n; PERF.md), at LB2; and TSP_AGREE, the largest
# n whose LB1 solve ends within about 10 s, at both bounds (equal optima;
# LB1's tree grows some tenfold every two cities past it)
TSP10 = tsp.TSPInstance.synthetic(10, seed=0)
TSP10_OPT = TSP10.brute_force_optimum()
for lb in (1, 2):
    res = plugin_solve(f"tsp n=10 lb{lb} chunk 4096", "tsp", TSP10.d, lb,
                       4096, 1 << 20)
    check(res.best == TSP10_OPT, f"tsp 10 lb{lb}: {res.best}")
TSP_N, TSP_CHUNK = 36, 4096
TSP_AGREE, AGREE_CHUNK = 24, {1: 65536, 2: 4096}
TSPN = tsp.TSPInstance.synthetic(TSP_N, seed=0)
plugin_solve(f"tsp n={TSP_N} lb2 chunk {TSP_CHUNK}", "tsp", TSPN.d, 2,
             TSP_CHUNK, 1 << 22)
plugin_graph_vs_eager(f"tsp n={TSP_N} lb2 chunk {TSP_CHUNK}", "tsp", TSPN.d,
                      2, TSP_CHUNK, 1 << 22)
TSPA = tsp.TSPInstance.synthetic(TSP_AGREE, seed=0)
best = {}
for lb, chunk in AGREE_CHUNK.items():
    best[lb] = plugin_solve(f"tsp n={TSP_AGREE} lb{lb} chunk {chunk}", "tsp",
                            TSPA.d, lb, chunk, 1 << 22).best
    # the chunk-65536 LB1 pool passes 2^22 rows within these steps
    plugin_graph_vs_eager(f"tsp n={TSP_AGREE} lb{lb} chunk {chunk}", "tsp",
                          TSPA.d, lb, chunk, 1 << 24)
check(best[1] == best[2], f"tsp n={TSP_AGREE}: lb1 {best[1]} != lb2 "
      f"{best[2]}")

# PFSP through the plugin: ta014's golden through `solve`, at the command's
# default chunk (64: the fused `prefilter` route on the card) and at 4096
# (the dense route, the phase 3 golden's), each against the `pfsp` command
# at that chunk
G14 = next(json.loads(l) for l in (ROOT / "tests" / "golden" /
                                   "pfsp_lb2_ub1.jsonl").read_text()
           .splitlines() if json.loads(l)["inst"] == 14)
for chunk, route, expect in (
        (64, "prefilter", ("lb2_sweep",)),
        (4096, "dense", ("expand_emit", "expand_fronts", "lb2_sweep"))):
    check(device.lb2_route(20, 10, 45, chunk)[0] == route,
          f"ta014 route at chunk {chunk}")
    argv = ["solve", "--problem", "pfsp", "-i", "14", "-l", "2", "-u",
            "1377"] + ([] if chunk == 64 else ["--chunk", str(chunk)])
    (rc, text, _), counts, secs = path_run(
        f"ta014 solve chunk {chunk} (plugin)", expect,
        lambda: cli_run(argv))
    out = json.loads(text.strip().splitlines()[-1])
    check(rc == 0 and (out["explored_tree"], out["explored_sol"],
                       out["best"]) == (G14["tree"], G14["sol"], G14["best"])
          and out["complete"], f"{' '.join(argv)}: {out}")
    if route == "dense":
        check(counts["fused_expand"] == 0 and counts["expand_bounds"] == 0
              and counts["expand_fronts"] == counts["expand_emit"],
              f"ta014 solve dense: launches {counts}")
    else:
        check(counts["fused_expand"] + counts["expand_bounds"] > 0,
              f"ta014 solve prefilter: launches {counts}")
    rc, text, _ = cli_run(["pfsp", "-i", "14", "-l", "2", "-u", "1",
                           "--chunk", str(chunk)])
    check(rc == 0 and f"Size of the explored tree: {G14['tree']}" in text
          and "Optimal makespan: 1377" in text, f"pfsp -i 14 --chunk {chunk}")
    say(f"ta014 lb2 solve --problem pfsp ({route}, chunk {chunk})",
        tree=G14["tree"], sol=G14["sol"], best=G14["best"], seconds=secs,
        launches=counts, same_as_pfsp_command=True, card=CARD)
plugin_graph_vs_eager("ta014 lb2 pfsp plugin chunk 4096", "pfsp",
                      taillard.processing_times(14), 2, 4096, 1 << 20)

# --- phase 10: the multi-worker search ------------------------------------
device.clear_graphs()
W4 = mesh.worker_devices(devices=[DEV] * 4)
W2 = mesh.worker_devices(devices=[DEV] * 2)
P14 = taillard.processing_times(14)
# the golden's chunk (dense route) and capacity; a surplus of 512 rows
# donates, so the rounds move nodes on this small tree
DIST14 = dict(lb_kind=2, init_ub=1377, chunk=4096, capacity=1 << 20,
              min_transfer=512)
DENSE = ("expand_emit", "expand_fronts", "lb2_sweep")
DIST_FIELDS = ("tree", "sol", "evals", "iters", "steals", "sent", "recv")
DIST_FROM: dict[str, dict] = {}
t_phase10 = time.perf_counter()


def dist_golden(label, res, want):
    got = (res.explored_tree, res.explored_sol, res.best)
    check(got == want and res.complete, f"{label}: {got} != {want}")


# (a) ta014 LB2 ub=opt, dense, on four workers
res_a, counts, secs = path_run("dist ta014 D=4", DENSE, lambda: (
    distributed.search(P14, devices=W4, **DIST14)))
dist_golden("dist ta014 D=4", res_a, (144639, 0, 1377))
check(int(res_a.per_device["sent"].sum()) > 0,
      "dist ta014: no balance round moved nodes")
check(counts["fused_expand"] == 0 and counts["expand_bounds"] == 0
      and counts["expand_fronts"] == counts["expand_emit"],
      f"dist ta014 dense: launches {counts}")
DIST_FROM.update(dict.fromkeys(DENSE, counts))
say("dist ta014 lb2 D=4 (dense, chunk 4096)",
    explored_tree=res_a.explored_tree, seconds=secs, launches=counts,
    card=CARD, **{f: res_a.per_device[f].tolist() for f in DIST_FIELDS})

# (b) ta007 LB1_d ub=opt at the golden's chunk
res_b, counts, secs = path_run("dist ta007 lb1_d D=4", ("expand_bounds",),
                               lambda: distributed.search(
    taillard.processing_times(7), lb_kind=0, init_ub=1234, devices=W4,
    chunk=4096, capacity=1 << 20))
dist_golden("dist ta007 lb1_d D=4", res_b, (271602, 28447, 1234))
DIST_FROM["expand_bounds"] = counts
say("dist ta007 lb1_d D=4 (chunk 4096)", tree=res_b.explored_tree,
    seconds=secs, launches=counts, card=CARD,
    sent=res_b.per_device["sent"].tolist())

# (c) case (a) through the plain versions: every worker's counters equal
with plain_kernels():
    res_c, counts, secs_c = path_run("dist ta014 D=4 plain", (), lambda: (
        distributed.search(P14, devices=W4, **DIST14)))
check(not any(counts.values()), f"dist ta014 plain: launches {counts}")
for f in DIST_FIELDS:
    check(np.array_equal(res_c.per_device[f], res_a.per_device[f]),
          f"dist ta014: per-worker {f} differs under the plain versions")
say("dist ta014 lb2 D=4: kernels vs plain versions", equal=True,
    plain_seconds=secs_c)

# (d) ta021 LB2 ub=opt at the bench shape: 2 macro-iterations against the
# plain versions, then 64 timed
P21 = taillard.processing_times(21)
PF = problems.get("pfsp")
C21, CAP21, BP21 = BENCH_CHUNK_DEFAULT, 1 << 22, 4
TC21 = distributed.default_transfer_cap(C21, 20, 20, 4, aux_itemsize=2)
DRV21 = distributed._problem_driver(PF, W4, P21, 2, C21, BP21, TC21,
                                    2 * C21, fused="hw")
FR21 = PF.warmup(P21, 2, taillard.optimal_makespan(21), target=32 * 4)
FR21.aux = PF.seed_aux(P21, FR21.prmu, FR21.depth)


def seed21():
    return DRV21.seed(FR21, CAP21, 20,
                      min(FR21.best, taillard.optimal_makespan(21)))


def same_workers(label, xs, ys):
    cx, cy = distributed.worker_counters(xs), distributed.worker_counters(ys)
    for f in device.COUNTER_DTYPES:
        check(np.array_equal(cx[f], cy[f]), f"{label}: worker {f} differs")
    for x, y, n in zip(xs, ys, cx["size"]):
        check(torch.equal(x.prmu[:, :n], y.prmu[:, :n])
              and torch.equal(x.depth[:n], y.depth[:n])
              and torch.equal(x.aux[:, :n], y.aux[:, :n]),
              f"{label}: live rows differ")


with plain_kernels():
    plain21, _, _ = path_run("dist ta021 plain", (),
                             lambda: DRV21.run(seed21(), max_iters=2 * BP21))
s21, counts, secs = path_run("dist ta021 2 macro-iterations",
                             ("fused_expand", "lb2_sweep"),
                             lambda: DRV21.run(seed21(), max_iters=2 * BP21))
same_workers("dist ta021 after 2 macro-iterations", s21, plain21)
del plain21
# the same 2 macro-iterations taken eagerly (no graph) on the kernels
eager21 = seed21()
body21 = DRV21.body(CAP21)
ceiling21 = torch.full((), 2 * BP21, dtype=torch.int64, device=DEV)
for _ in range(2):
    eager21 = body21(eager21, distributed._loop_cond(eager21, ceiling21))
same_workers("dist ta021 graph vs eager", s21, eager21)
del eager21
say("dist ta021 D=4: 2 macro-iterations, graph vs eager vs plain versions",
    equal=True, seconds_with_capture=secs, launches=counts)
torch.cuda.reset_peak_memory_stats(DEV)
reads0, macros0 = DRV21.host_reads, DRV21.macro_iters
c0 = distributed.worker_counters(s21)
s21, counts, secs = path_run("dist ta021 64 macro-iterations",
                             ("fused_expand", "lb2_sweep"),
                             lambda: DRV21.run(s21,
                                               max_iters=(2 + 64) * BP21))
c1 = distributed.worker_counters(s21)
reads, macros = DRV21.host_reads - reads0, DRV21.macro_iters - macros0
check(macros >= 64 and reads <= macros and int(c1["iters"][0]) == 66 * BP21,
      f"dist ta021: {macros} macro-iterations, {reads} reads")
DIST_FROM.update(dict.fromkeys(("fused_expand", "lb2_sweep"), counts))
peak = torch.cuda.max_memory_allocated(DEV)
clones = [s._replace(prmu=s.prmu.clone(), depth=s.depth.clone(),
                     aux=s.aux.clone()) for s in s21]
ACT = torch.ones((), dtype=torch.bool, device=DEV)
balance_ms = graph_ms(lambda: distributed._balance_round(
    clones, TC21, 2 * C21, DRV21.limit(CAP21), ACT), 20)
del clones
say("dist ta021 lb2 D=4 (fused, chunk 65536, capacity 2^22 per worker, "
    "balance period 4)", macro_iterations=macros, seconds=secs,
    ms_per_macro_iteration=1e3 * secs / macros,
    evals_per_s=float(c1["evals"].sum() - c0["evals"].sum()) / secs,
    host_reads_per_macro_iteration=reads / macros,
    balance_round_device_ms=balance_ms, transfer_cap=TC21,
    sizes=c1["size"].tolist(), steals=c1["steals"].tolist(),
    sent=c1["sent"].tolist(), peak_memory_bytes=peak, launches=counts,
    card=CARD)
del s21
device.clear_graphs()

# (e) N-Queens 15 on four workers (no incumbent: the counts hold for any D)
res_e, counts, secs = path_run("dist nqueens 15", (), lambda: (
    nqueens.search_distributed(15, chunk=65536, capacity=1 << 22,
                               devices=W4)))
check((res_e.explored_tree, res_e.explored_sol) == NQ15 and res_e.complete,
      f"dist nqueens 15: {res_e.explored_tree}, {res_e.explored_sol}")
check(not any(counts.values()), f"dist nqueens 15: kernels {counts}")
say("dist nqueens N=15 D=4 (chunk 65536)", tree=res_e.explored_tree,
    sol=res_e.explored_sol, seconds=secs, card=CARD,
    sent=res_e.per_device["sent"].tolist())
device.clear_graphs()

# (f) case (a) stopped after two segments, resumed on two workers
SEG10 = Path(tempfile.mkdtemp(prefix="tts_chip_smoke_dist_"))
ck10 = str(SEG10 / "d14.npz")
part, counts, _ = path_run("dist ta014 2 segments", DENSE, lambda: (
    distributed.search(P14, devices=W4, segment_iters=BP21,
                       checkpoint_path=ck10,
                       should_stop=lambda rep: rep.segment >= 2, **DIST14)))
check(not part.complete, "dist ta014: ended within two segments")
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    res_f, counts, secs = path_run("dist ta014 resumed on D=2", DENSE,
                                   lambda: distributed.search(
        P14, devices=W2, segment_iters=64, checkpoint_path=ck10, **DIST14))
check(any("resharding" in str(w.message) for w in caught),
      "dist ta014: no elastic reshard on the resume")
dist_golden("dist ta014 resumed on D=2", res_f, (res_a.explored_tree,
                                                 res_a.explored_sol,
                                                 res_a.best))
shutil.rmtree(SEG10)
say("dist ta014: stacked checkpoint after 2 segments on D=4, resumed on "
    "D=2", tree=res_f.explored_tree, seconds=secs, launches=counts)

# (g) -D 4 through the command on this machine
rc, out, err = cli_run(["pfsp", "-i", "14", "-l", "2", "-u", "1", "-D", "4"])
if torch.cuda.device_count() < 4:
    check(rc != 0 and "need 4 devices, have "
          f"{torch.cuda.device_count()}" in err and "explored" not in out,
          f"pfsp -D 4 on {torch.cuda.device_count()} card(s): {rc} {err}")
else:
    cli_golden("pfsp -D 4", rc, out)
say("pfsp -i 14 -l 2 -u 1 -D 4 (command)", exit_code=rc,
    stderr=err.strip(), cards=torch.cuda.device_count())
say("phase 10 seconds", seconds=time.perf_counter() - t_phase10)

# --- phase 11: the -C host tier -------------------------------------------
device.clear_graphs()
t_phase11 = time.perf_counter()
HYB = dict.fromkeys(kernels.LAUNCHES, 0)
HOST_KEYS = ("host_tree", "host_sol", "host_expanded", "host_drained",
             "exchanges", "host_improved", "dev_improved")
CSV11 = Path(tempfile.mkdtemp(prefix="tts_chip_smoke_hybrid_"))


def counts_of(text: str) -> tuple:
    return tuple(int(ln.rsplit(": ", 1)[1]) for ln in text.splitlines()
                 if ln.startswith(("Size of the explored tree",
                                   "Number of explored solutions",
                                   "Optimal makespan")))


STAGES = {}


def hybrid_cli(label, argv, expect=()):
    """One `pfsp -C 1` command as a path run; returns (counts, the
    `hybrid.search` result it made, or None, launches, seconds,
    stderr). STAGES[label] keeps the seconds of hybrid.search's stage
    spans (warm-up, seeding, device loop, drain, join)."""
    prev = tracelog.install(tracelog.TraceLog(capacity=1024))
    try:
        with recording(hybrid, "search") as made:
            (rc, text, err), counts, secs = path_run(label, expect,
                                                     lambda: cli_run(argv))
    finally:
        STAGES[label] = {r["name"]: r["dur"]
                         for r in tracelog.install(prev).records()
                         if r["kind"] == "span"
                         and r["name"].startswith("hybrid.")}
    check(rc == 0, f"{label}: exit code {rc}: {err}")
    for k, v in counts.items():
        HYB[k] += v
    return counts_of(text), (made[0] if made else None), counts, secs, err


def host_fields(res) -> dict:
    return {k: int(res.per_device[k][0]) for k in HOST_KEYS}


# (a) ta008 LB2 ub=opt at the bench chunk, the dense route, with -C and
# without; the session searched its share and merged at least once
A8 = ["pfsp", "-i", "8", "-l", "2", "-u", "1", "--chunk", "65536"]
A8_GOLD = (13_940_189, 0, 1206)
check(device.lb2_route(20, 5, 10, 65536)[0] == "dense", "ta008 route")
csv_a = str(CSV11 / "a.csv")
got, res, counts_a, secs_c, err = hybrid_cli(
    "ta008 -C 1", A8 + ["-C", "1", "--csv", csv_a], DENSE)
check(got == A8_GOLD, f"ta008 -C 1: {got}")
check(res.per_device["host_expanded"][0] > 0
      and res.per_device["exchanges"][0] >= 1, f"ta008 -C 1: {res.per_device}")
check("phase profiling failed" not in err, f"ta008 --csv: {err}")
(rc, text, _), _, secs_plain = path_run("ta008 without -C", DENSE,
                                        lambda: cli_run(A8))
check(rc == 0 and counts_of(text) == got, "ta008 without -C differs")
say("ta008 lb2 -C 1 (dense, chunk 65536)", tree=got[0], sol=got[1],
    best=got[2], seconds=secs_c, seconds_without_C=secs_plain,
    stage_seconds=STAGES["ta008 -C 1"], launches=counts_a, card=CARD,
    **host_fields(res),
    dev_tree=int(res.per_device["tree"][0]),
    iters=int(res.per_device["iters"][0]))

# (b) ta016 LB2 ub=opt at the bench chunk (20x10: its route recorded)
route16 = device.lb2_route(20, 10, 45, 65536)[0]
got, res, counts, secs, _ = hybrid_cli(
    "ta016 -C 1", ["pfsp", "-i", "16", "-l", "2", "-u", "1", "--chunk",
                   "65536", "-C", "1"], ("lb2_sweep",))
check(got == (2_646_205, 0, 1397), f"ta016 -C 1: {got}")
check(res.per_device["host_expanded"][0] > 0, "ta016: no host work")
mode16 = "fused" if counts["fused_expand"] else "unfused"
say("ta016 lb2 -C 1 (chunk 65536)", tree=got[0], route=route16, mode=mode16,
    seconds=secs, stage_seconds=STAGES["ta016 -C 1"], launches=counts,
    card=CARD, **host_fields(res))

# (c) ta007 LB1_d ub=opt: the bounds-only kernel beside the host tier
got, res, counts, secs, _ = hybrid_cli(
    "ta007 lb1_d -C 1", ["pfsp", "-i", "7", "-l", "0", "-u", "1", "--chunk",
                         "4096", "-C", "1"], ("expand_bounds",))
check(got == (271_602, 28_447, 1234), f"ta007 lb1_d -C 1: {got}")
say("ta007 lb1_d -C 1 (chunk 4096)", tree=got[0], sol=got[1], seconds=secs,
    launches=counts, card=CARD, **host_fields(res))

# (d) ta014 LB2 ub=inf: a live incumbent, exchanged both ways
got, res, counts, secs, _ = hybrid_cli(
    "ta014 ub=inf -C 1", ["pfsp", "-i", "14", "-l", "2", "-u", "0", "--chunk",
                          "4096", "-C", "1"], DENSE)
check(got[2] == 1377 and got[0] >= 144_639, f"ta014 ub=inf -C 1: {got}")
say("ta014 lb2 ub=inf -C 1 (dense, chunk 4096)", tree=got[0], best=got[2],
    seconds=secs, launches=counts, card=CARD, **host_fields(res))

# (e) ta014 segmented with -C, stopped at 8 steps; one copy resumed with
# -C (the session from the saved share), the other without (the share
# pushed back into the pool)
E14 = ["pfsp", "-i", "14", "-l", "2", "-u", "1", "--chunk", "4096",
       "--capacity", "1048576", "--segment-iters", "4", "--checkpoint"]
for resume_c in (["-C", "1"], []):
    shutil.rmtree(CSV11 / "e", ignore_errors=True)
    (CSV11 / "e").mkdir()
    ck_e = str(CSV11 / "e" / "e.npz")
    got, _, counts, secs, _ = hybrid_cli(
        "ta014 -C 1 stopped", E14 + [ck_e, "-C", "1", "--max-iters", "8"])
    with np.load(ck_e) as z:
        held = len(z["meta_host_depth"])
    check(held > 0, "ta014 -C checkpoint holds no host share")
    got, _, counts, secs, _ = hybrid_cli(
        f"ta014 resumed {'with' if resume_c else 'without'} -C",
        E14 + [ck_e] + resume_c, DENSE)
    check(got == (144_639, 0, 1377), f"ta014 resumed {resume_c}: {got}")
    say(f"ta014 lb2 -C 1 segmented, stopped at 8 steps, resumed "
        f"{'with' if resume_c else 'without'} -C", tree=got[0],
        host_share_rows=held, seconds=secs, launches=counts)

# (f) four workers on the card with the host tier (-D 4 -C 1's call)
threads_f = max(1, (os.cpu_count() or 1) // 4)
res_f, counts, secs_f = path_run("dist ta014 D=4 -C 1", DENSE, lambda: (
    distributed.search(P14, devices=W4, host_fraction=8,
                       host_threads=threads_f, **DIST14)))
for k, v in counts.items():
    HYB[k] += v
dist_golden("dist ta014 D=4 -C 1", res_f, (144639, 0, 1377))
check(res_f.per_device["host_expanded"][0] > 0
      and res_f.per_device["exchanges"][0] >= 1, "dist -C: no host work")
say("dist ta014 lb2 D=4 -C 1 (dense, chunk 4096)", seconds=secs_f,
    launches=counts, card=CARD, host_threads=threads_f,
    **{f: np.asarray(res_f.per_device[f]).tolist()
       for f in DIST_FIELDS + HOST_KEYS if f in res_f.per_device})

# (g) the CSV rows of (a) and (f): the JAX CLI's headers, measured timing
# columns within the elapsed time
csv_f = str(CSV11 / "f.csv")
args_f = cli.build_parser().parse_args(
    ["pfsp", "-i", "14", "-l", "2", "-u", "1", "-D", "4", "-C", "1",
     "--chunk", "4096", "--capacity", "1048576", "--csv", csv_f])
err_f = io.StringIO()
with contextlib.redirect_stderr(err_f):
    phase_timing.write_csv_with_phases(
        args_f, P14, 1377, W4, secs_f, res_f.explored_tree,
        res_f.explored_sol, res_f.best,
        {k: list(v) for k, v in res_f.per_device.items()})
check("phase profiling failed" not in err_f.getvalue(),
      f"dist --csv: {err_f.getvalue()}")
rows = {}
for name, path, header in (("a", csv_a, csv_stats.SINGLE_HEADER),
                           ("f", csv_f, csv_stats.MULTI_HEADER)):
    lines = Path(path).read_text().splitlines()
    check(len(lines) == 2 and lines[0] == header, f"csv {name}: {lines[:1]}")
    rows[name] = dict(zip(header.split(","),
                          next(__import__("csv").reader(lines[1:]))))
ka = float(rows["a"]["gpu_kernel_time"])
check(0 < ka <= float(rows["a"]["total_time"]), f"csv a: {rows['a']}")
kf = [float(x) for x in rows["f"]["gpu_kernel_time"].strip("[]").split(",")]
check(all(0 < k <= float(rows["f"]["total_time"]) for k in kf),
      f"csv f: {rows['f']}")
say("--csv rows of (a) and (f)", single=rows["a"], multi=rows["f"])
shutil.rmtree(CSV11)
say("phase 11 seconds", seconds=time.perf_counter() - t_phase11)

# --- phase 12: the chunk ladder and the board -----------------------------
device.clear_graphs()
t_phase12 = time.perf_counter()
LAD = dict.fromkeys(kernels.LAUNCHES, 0)
SEG12 = Path(tempfile.mkdtemp(prefix="tts_chip_smoke_ladder_"))


def lad_run(label, expect, fn):
    """A path run of this phase (graphs dropped first, so that each case
    captures its own); its launches join LAD."""
    device.clear_graphs()
    out, counts, secs = path_run(label, expect, fn)
    for k, v in counts.items():
        LAD[k] += v
    return out, counts, secs


@contextlib.contextmanager
def ladder_trace():
    """The rung drivers `_ladder_plan` builds, one row per segment (each
    `_DistDriver.run` call: its rung, milliseconds with the device
    synchronized, captures made and kernel launches), and the ladder and
    tuner events of the flight recorder."""
    rows, events = [], []
    orig = distributed._DistDriver.run
    prev = tracelog.install(tracelog.TraceLog(capacity=1 << 14))

    def run(self, states, max_iters=None):
        before = dict(kernels.LAUNCHES)
        caps = sum(self.captures.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(self, states, max_iters)
        torch.cuda.synchronize()
        rows.append({
            # a PFSP `_DistDriver` is keyed (jobs, machines, lb_kind,
            # chunk, fused mode)
            "rung": self.key[3], "ms": 1e3 * (time.perf_counter() - t0),
            "captures": sum(self.captures.values()) - caps,
            "launches": {k: kernels.LAUNCHES[k] - before[k]
                         for k in before if kernels.LAUNCHES[k] > before[k]}})
        return out

    distributed._DistDriver.run = run
    try:
        with recording(distributed, "_ladder_plan") as plans:
            yield rows, plans, events
    finally:
        distributed._DistDriver.run = orig
        events += [r for r in tracelog.install(prev).records()
                   if r["name"].startswith(("ladder.", "tuner."))]


def rung_table(rows) -> dict:
    """Per rung: its segments, captures, graph ms per segment (a capture
    included where one was made) and launches."""
    out = {}
    for r in rows:
        t = out.setdefault(r["rung"], {"segments": 0, "captures": 0,
                                       "ms": [], "launches": {}})
        t["segments"] += 1
        t["captures"] += r["captures"]
        t["ms"].append(round(r["ms"], 4))
        for k, v in r["launches"].items():
            t["launches"][k] = t["launches"].get(k, 0) + v
    return out


def switches(events) -> list:
    return [(e["frm"], e["to"], e["segment"]) for e in events
            if e["name"] == "ladder.switch"]


def accounting(frontier: int):
    """A heartbeat holding the node accounting exact at every segment
    boundary (the state carries telemetry; a failed identity raises under
    TTS_AUDIT_HARD=1): every branched node is in the tree, every
    evaluated child is branched, pruned or a leaf, every transferred node
    arrived, and the pools hold the seeded frontier plus the branched less
    the popped."""
    def hb(rep):
        t = rep.telemetry
        branched, pruned = sum(t["branched"]), sum(t["pruned"])
        for name, ok in (
                ("branched_is_tree", branched == rep.tree),
                ("children_conservation",
                 branched + pruned + rep.sol == rep.evals),
                ("steal_flow", t["steal_sent"] == t["steal_recv"]),
                ("pool_conservation",
                 rep.pool_size == frontier + branched - sum(t["popped"]))):
            audit.record(name, ok, segment=rep.segment, tree=rep.tree,
                         pool=rep.pool_size)
            check(ok, f"segment {rep.segment}: {name}")
    return hb


# (1) ta021 at full width from the root, four workers on the card: LB2
# ub=opt at chunk 65536 (rungs 4096, 16384, 65536), capacity 2^22 a
# worker, period 4, 8-step segments, telemetry on, under
# TTS_AUDIT_HARD=1. The default warm-up (32 nodes a worker) starts on
# 4096; a warm-up of 8192 nodes a worker (`pfsp -D 4 -m 8192`) starts on
# 16384. The first boundary's pool (some 80,000 nodes a worker after one
# macro-iteration) covers only the top rung, so each leg climbs to it.
L21 = dict(lb_kind=2, init_ub=taillard.optimal_makespan(21), chunk=C21,
           capacity=CAP21, balance_period=BP21, segment_iters=8,
           max_rounds=12, telemetry=True)
RUNGS21 = (4096, 16384, 65536)
os.environ["TTS_AUDIT_HARD"] = "1"
LEGS = {}
try:
    for seed_nodes, start in ((32, 4096), (8192, 16384)):
        fr = PF.warmup(P21, 2, L21["init_ub"], target=seed_nodes * 4)
        torch.cuda.reset_peak_memory_stats(DEV)
        with ladder_trace() as (rows, plans, events):
            res, counts, secs = lad_run(
                f"ladder ta021 from {start}", ("fused_expand", "lb2_sweep"),
                lambda: distributed.search(
                    P21, devices=W4, min_seed=seed_nodes, ladder=True,
                    heartbeat=accounting(len(fr.depth)), **L21))
        peak = torch.cuda.max_memory_allocated(DEV)
        (rungs, drivers), = plans
        check(tuple(rungs) == RUNGS21, f"ta021 rungs {rungs}")
        check(events[0]["source"] == "occupancy"
              and events[0]["rung"] == start, f"ta021 start {events[0]}")
        check(rows[-1]["rung"] == C21, f"ta021 never reached {C21}")
        table = rung_table(rows)
        for r in rows:
            check(sum(r["launches"].values()) > 0,
                  f"ta021 rung {r['rung']}: a segment launched no kernel")
        for c, d in drivers.items():
            check(all(v == 1 for v in d.captures.values())
                  and (c not in table or d.captures),
                  f"ta021 rung {c}: captures {d.captures}")
        LEGS[start] = table
        say(f"ladder ta021 lb2 D=4 from the root, start rung {start} "
            "(chunk 65536, capacity 2^22 a worker, period 4, 8-step "
            "segments)", rung_per_segment=[r["rung"] for r in rows],
            switches=switches(events), per_rung=table, seconds=secs,
            tree=res.explored_tree, complete=res.complete,
            peak_memory_bytes=peak, launches=counts, card=CARD)
finally:
    del os.environ["TTS_AUDIT_HARD"]
ran = set().union(*LEGS.values())
check(ran == set(RUNGS21), f"ta021: rungs run {ran}")
# the same segments on the fixed top chunk, for the peak memory
torch.cuda.reset_peak_memory_stats(DEV)
with ladder_trace() as (rows, _, _):
    res_off, counts, secs = lad_run(
        "ta021 ladder off", ("fused_expand", "lb2_sweep"),
        lambda: distributed.search(P21, devices=W4, ladder=False, **L21))
say("ladder off: ta021 lb2 D=4, the same segments at chunk 65536",
    per_rung=rung_table(rows), seconds=secs, tree=res_off.explored_tree,
    peak_memory_bytes=torch.cuda.max_memory_allocated(DEV), card=CARD)

# (2) ta008 to completion at chunk 65536 (dense), the ladder on and off
A8D = dict(lb_kind=2, init_ub=1206, chunk=65536, capacity=CAP21,
           segment_iters=8)
with ladder_trace() as (rows8, _, events8):
    res_on, _, secs_on = lad_run(
        "ladder ta008 on", DENSE, lambda: distributed.search(
            taillard.processing_times(8), devices=W4, ladder=True, **A8D))
res_off, _, secs_off = lad_run(
    "ladder ta008 off", DENSE, lambda: distributed.search(
        taillard.processing_times(8), devices=W4, ladder=False, **A8D))
for res in (res_on, res_off):
    dist_golden("ladder ta008", res, A8_GOLD)
say("ladder ta008 lb2 D=4 (dense, chunk 65536, 8-step segments) to "
    "completion", seconds_ladder_on=secs_on, seconds_ladder_off=secs_off,
    rung_per_segment=[r["rung"] for r in rows8],
    switches=switches(events8), per_rung=rung_table(rows8), card=CARD)

# (3) ta014 at chunk 4096 (rungs 256, 1024, 4096), 4-step segments: up and
# down; cut after two segments, resumed with the ladder (on its recorded
# rung) and, from a copy, without
L14 = dict(DIST14, segment_iters=4)
with ladder_trace() as (rows14, _, events14):
    full14, _, secs14 = lad_run("ladder ta014", DENSE, lambda: (
        distributed.search(P14, devices=W4, ladder=True, **L14)))
dist_golden("ladder ta014", full14, (144639, 0, 1377))
dirs = {e["direction"] for e in events14 if e["name"] == "ladder.switch"}
check(dirs == {"up", "down"}, f"ladder ta014 switched {dirs}")
ck14 = SEG12 / "l14.npz"
lad_run("ladder ta014 cut", (), lambda: distributed.search(
    P14, devices=W4, ladder=True, checkpoint_path=str(ck14),
    should_stop=lambda rep: rep.segment >= 2, **L14))
with np.load(ck14) as z:
    rung14 = int(z["meta_ladder_rung"])
shutil.copy(ck14, SEG12 / "l14_plain.npz")
with ladder_trace() as (_, _, ev_res):
    res_l, _, _ = lad_run("ladder ta014 resumed", DENSE, lambda: (
        distributed.search(P14, devices=W4, ladder=True,
                           checkpoint_path=str(ck14), **L14)))
start14 = [e for e in ev_res if e["name"] == "ladder.start"][0]
check(start14["source"] == "meta" and start14["rung"] == rung14,
      f"ta014 resume started {start14}")
res_p, _, _ = lad_run("ladder ta014 resumed plain", DENSE, lambda: (
    distributed.search(P14, devices=W4, ladder=False,
                       checkpoint_path=str(SEG12 / "l14_plain.npz"),
                       **L14)))
for res in (res_l, res_p):
    dist_golden("ladder ta014 resumed", res, (144639, 0, 1377))
say("ladder ta014 lb2 D=4 (chunk 4096, 4-step segments)", seconds=secs14,
    rung_per_segment=[r["rung"] for r in rows14],
    switches=switches(events14), per_rung=rung_table(rows14),
    cut_rung=rung14, resumed_with_ladder=res_l.explored_tree,
    resumed_without=res_p.explored_tree, card=CARD)

# (4) the board: ta014 ub=inf (the incumbent moves) with no board, with a
# lone client (bit-identical), then a second search on that board, which
# folds the first's best before its first dispatch
B14 = dict(DIST14, init_ub=None, segment_iters=8)
solo, _, secs_solo = lad_run("board ta014 solo", DENSE, lambda: (
    distributed.search(P14, devices=W4, **B14)))
board = incumbent.IncumbentBoard()
lone, _, _ = lad_run("board ta014 lone", DENSE, lambda: (
    distributed.search(P14, devices=W4, incumbent_board=board, **B14)))
for f in DIST_FIELDS + ("final_size",):
    check(np.array_equal(lone.per_device[f], solo.per_device[f]),
          f"board: a lone client changed per-worker {f}")
folds = obs_metrics.default().counter("tts_incumbent_folds_total")
in0 = folds.value(direction="in")
second, _, secs_2 = lad_run("board ta014 second", DENSE, lambda: (
    distributed.search(P14, devices=W4, incumbent_board=board, **B14)))
folded = folds.value(direction="in") - in0
check(folded >= 1, "board: the second search folded nothing")
check(solo.best == lone.best == second.best == 1377
      and second.complete and second.explored_tree <= solo.explored_tree,
      f"board: {solo.best} {second.best} {second.explored_tree}")
say("board ta014 lb2 ub=inf D=4 (chunk 4096)", solo_tree=solo.explored_tree,
    second_tree=second.explored_tree, folds_in=folded,
    seconds_solo=secs_solo, seconds_second=secs_2, board=board.snapshot(),
    card=CARD)

# (5) chunk=None and balance_period=None: the serving defaults
with ladder_trace() as (_, _, ev_none):
    res_n, _, secs_n = lad_run("chunk=None ta014", (), lambda: (
        distributed.search(P14, devices=W4, lb_kind=2, init_ub=1377,
                           chunk=None, balance_period=None,
                           capacity=1 << 20)))
dist_golden("chunk=None ta014", res_n, (144639, 0, 1377))
params = tune_defaults.params_for("serving", 20, 10)
resolved = [e for e in ev_none if e["name"] == "tuner.resolve"]
check(len(resolved) == 1 and resolved[0]["chunk"] == params.chunk
      and resolved[0]["balance_period"] == params.balance_period
      and resolved[0]["source"] == "default", f"tuner.resolve {resolved}")
say("chunk=None ta014 lb2 D=4: params_for('serving')",
    params=dataclasses.asdict(params), seconds=secs_n, card=CARD)
shutil.rmtree(SEG12)
say("phase 12 seconds", seconds=time.perf_counter() - t_phase12)

# --- phase 13: the tuner on the card -------------------------------------
device.clear_graphs()
t_phase13 = time.perf_counter()
TUNE = dict.fromkeys(kernels.LAUNCHES, 0)
TUNE_DIR = Path(tempfile.mkdtemp(prefix="tts_chip_smoke_tune_"))
check(not any(k.startswith("TTS_TUNE") for k in os.environ),
      "a TTS_TUNE* variable would change the sweep")


def tune_run(label, expect, fn):
    """A path run of this phase's probes; their launches join TUNE."""
    out, counts, secs = path_run(label, expect, fn)
    for k, v in counts.items():
        TUNE[k] += v
    return out, counts, secs


@contextlib.contextmanager
def probe_calls():
    """Every timed call of a probe's driver (`_DistDriver._drive`): its
    chunk, period and fused mode, and its evals and iterations as device
    tensors, read after the sweep (no read inside a timed window)."""
    rows = []
    orig = distributed._DistDriver._drive

    def drive(self, states, ceiling, capacity):
        out, status = orig(self, states, ceiling, capacity)
        rows.append((self.key[3], self.balance_period, self.key[4],
                     out[0].evals, out[0].iters))
        return out, status

    distributed._DistDriver._drive = drive
    try:
        yield rows
    finally:
        distributed._DistDriver._drive = orig


def same_repeats(label, rows):
    """Each candidate's calls (the capture and both repeats) from the same
    state counted the same evals and iterations."""
    by = {}
    for chunk, period, fused, ev, it in rows:
        by.setdefault((chunk, period, fused), []).append(
            (int(ev.item()), int(it.item())))
    for cand, counts in by.items():
        check(len(counts) == 3 and len(set(counts)) == 1,
              f"{label} {cand}: calls counted {counts}")
    return len(by)


def probe_rows(tuner):
    return [{k: r[k] for k in ("chunk", "balance_period", "fused",
                               "evals_per_s", "ms_per_iter", "pool_start",
                               "underfilled")} for r in tuner.ledger]


# (1) the sweep: ta021 LB2 with the default candidates (chunks 256 ...
# 65536 on both pipelines at period 4, periods 1, 4, 16 at the winner,
# the winner's rungs), window 24, warm-up 200 steps, 2 repeats
T21 = tune_tuner.Autotuner(cache_dir=TUNE_DIR / "ta021")
check(T21.chunks == tune_tuner.CHUNK_CANDIDATES_DEFAULT
      and T21.periods == tune_tuner.PERIOD_CANDIDATES_DEFAULT
      and (T21.window_iters, T21.warm_iters, T21.repeats) == (24, 200, 2),
      "ta021 sweep: not the default candidates")
torch.cuda.reset_peak_memory_stats(DEV)
prev_log = tracelog.install(tracelog.TraceLog(capacity=1 << 14))
try:
    with probe_calls() as calls21:
        params21, counts, secs21 = tune_run(
            "tuner ta021 sweep", ("fused_expand", "lb2_sweep",
                                  "expand_bounds"),
            lambda: T21.resolve(20, 20, 2, allow_probe=True, p_times=P21))
finally:
    ev21 = [r for r in tracelog.install(prev_log).records()
            if r["name"].startswith("tuner")]
peak21 = torch.cuda.max_memory_allocated(DEV)
dropped = [e for e in ev21 if e["name"] == "tuner.candidate_dropped"]
check(params21.source == "probe", f"ta021 sweep: {params21}")
check(not [e for e in dropped if e.get("chunk") == max(T21.chunks)],
      f"ta021 sweep: a top-of-ladder candidate was dropped: {dropped}")
probed = {(r["chunk"], r["fused"]) for r in T21.ledger}
check({(max(T21.chunks), "off"), (max(T21.chunks), "hw")} <= probed,
      f"ta021 sweep: top chunk not probed on both pipelines: {probed}")
check(all(r["evals"] > 0 for r in T21.ledger),
      f"ta021 sweep: a probe counted no evals {T21.ledger}")
n_cands = same_repeats("ta021 sweep", calls21)
check(n_cands == T21.probes_run, f"ta021: {n_cands} != {T21.probes_run}")
for row in probe_rows(T21):
    say("tuner ta021 probe", **row)
say("tuner ta021 lb2 sweep: the winner", chunk=params21.chunk,
    balance_period=params21.balance_period,
    evals_per_s=params21.evals_per_s, rung_modes=params21.rung_modes,
    probes=T21.probes_run, dropped=dropped, sweep_seconds=secs21,
    peak_memory_bytes=peak21, launches=counts, card=CARD)

# (2) the warm replay: a second tuner on the same directory, zero probes
T21b = tune_tuner.Autotuner(cache_dir=TUNE_DIR / "ta021")
params21b = T21b.resolve(20, 20, 2, allow_probe=True, p_times=P21)
check(T21b.probes_run == 0 and params21b.source == "cache"
      and (params21b.chunk, params21b.balance_period, params21b.rung_modes)
      == (params21.chunk, params21.balance_period, params21.rung_modes),
      f"ta021 warm replay: {params21b}, {T21b.probes_run} probes")
say("tuner ta021 warm replay", source=params21b.source, probes=0,
    cache=T21b.cache.snapshot())

# (3) a search that consumes an entry: ta014 probed at chunks 1024 and
# 4096 for four workers, then `search(chunk=None, tuner=...)` from a
# fresh tuner on that directory, plain and on the ladder over 16-step
# segments (a multiple of every period candidate: a segment shorter than
# the period would run no macro-iteration)
TK14 = dict(cache_dir=TUNE_DIR / "ta014", chunks=(1024, 4096),
            capacity=1 << 22)
T14 = tune_tuner.Autotuner(**TK14)
params14, counts, secs = tune_run(
    "tuner ta014 sweep", DENSE, lambda: T14.resolve(
        20, 10, 2, n_workers=4, allow_probe=True, p_times=P14))
check(params14.source == "probe" and params14.chunk in (1024, 4096),
      f"ta014 sweep: {params14}")
say("tuner ta014 lb2 sweep (chunks 1024, 4096; n_workers 4)",
    chunk=params14.chunk, balance_period=params14.balance_period,
    evals_per_s=params14.evals_per_s, rung_modes=params14.rung_modes,
    probes=probe_rows(T14), seconds=secs, launches=counts, card=CARD)
S14 = dict(lb_kind=2, init_ub=1377, chunk=None, balance_period=None,
           capacity=1 << 20)
for lad in (False, True):
    if lad:
        os.environ["TTS_LADDER"] = "1"
    tuner14 = tune_tuner.Autotuner(cache_dir=TK14["cache_dir"])
    try:
        with ladder_trace() as (rows_t, plans_t, ev_t), \
                recording(ladder, "rungs_from_profile") as profiled:
            res_t, counts, secs = path_run(
                f"search tuner=ta014 ladder={lad}", DENSE,
                lambda: distributed.search(
                    P14, devices=W4, tuner=tuner14,
                    segment_iters=16 if lad else None, **S14))
    finally:
        os.environ.pop("TTS_LADDER", None)
    dist_golden(f"search tuner=ta014 ladder={lad}", res_t,
                (144639, 0, 1377))
    resolved = [e for e in ev_t if e["name"] == "tuner.resolve"]
    check(len(resolved) == 1 and resolved[0]["source"] == "cache"
          and resolved[0]["chunk"] == params14.chunk
          and resolved[0]["balance_period"] == params14.balance_period
          and tuner14.probes_run == 0, f"tuner.resolve {resolved}")
    if lad:
        (rungs, _), = plans_t
        check(bool(profiled) and profiled[0] is not None
              and tuple(rungs) == tuple(profiled[0]),
              f"rung_profile did not reach _ladder_plan: {profiled}")
    say(f"search ta014 lb2 D=4 chunk=None tuner=<cache> ladder={lad}",
        resolved=resolved[0], rungs=list(plans_t[0][0]) if lad else None,
        rung_per_segment=[r["rung"] for r in rows_t], seconds=secs,
        launches=counts, card=CARD)

# (4) a damaged entry: truncated, then quarantined and probed again
entry14 = T14.cache.path_for(tune_tuner.Autotuner.key(20, 10, 2, 4))
blob = entry14.read_bytes()
entry14.write_bytes(blob[:len(blob) // 2])
T14d = tune_tuner.Autotuner(**TK14)
params14d, counts, secs = tune_run(
    "tuner ta014 re-probe", DENSE, lambda: T14d.resolve(
        20, 10, 2, n_workers=4, allow_probe=True, p_times=P14))
snap = T14d.cache.snapshot()
corrupt = sorted(p.name for p in entry14.parent.glob("*.corrupt"))
check(params14d.source == "probe" and T14d.probes_run > 0
      and snap["quarantined"] == 1 and snap["errors"] == 1
      and len(corrupt) == 1 and entry14.exists(),
      f"damaged entry: {snap} {corrupt}")
say("tuner ta014 truncated entry", quarantined_to=corrupt, cache=snap,
    reprobes=T14d.probes_run, seconds=secs, launches=counts)

# (5) the debug tap, in a subprocess with TTS_DEBUG_STEP=1
t_tap = time.perf_counter()
tap = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                      "--debug-tap"], capture_output=True, text=True,
                     timeout=600, cwd=ROOT,
                     env=dict(os.environ, TTS_DEBUG_STEP="1"))
check(tap.returncode == 0, f"debug tap: rc {tap.returncode}\n"
      f"{tap.stdout[-4000:]}\n{tap.stderr[-4000:]}")
say("debug tap ta021 lb2 (sent, recv, steals a step; kernels == plain "
    "versions, graph == eager)", seconds=time.perf_counter() - t_tap,
    **json.loads(tap.stdout.strip().splitlines()[-1]))
shutil.rmtree(TUNE_DIR)
say("phase 13 seconds", seconds=time.perf_counter() - t_phase13,
    tune_launches=TUNE)

# --- phase 14: the overlapped segment driver and multi-process runs ----
device.clear_graphs()
t_phase14 = time.perf_counter()
OVL = dict.fromkeys(kernels.LAUNCHES, 0)
MPL = dict.fromkeys(kernels.LAUNCHES, 0)
SEG14 = Path(tempfile.mkdtemp(prefix="tts_chip_smoke_overlap_"))


def ovl_run(label, expect, fn):
    """A path run of this phase's single-process searches (graphs dropped
    first); its launches join OVL."""
    device.clear_graphs()
    out, counts, secs = path_run(label, expect, fn)
    for k, v in counts.items():
        OVL[k] += v
    return out, counts, secs


@contextlib.contextmanager
def flight():
    """A fresh flight recorder for the block; its records at exit."""
    recs = []
    prev = tracelog.install(tracelog.TraceLog(capacity=1 << 14))
    try:
        yield recs
    finally:
        recs += tracelog.install(prev).records()


def stats(xs) -> dict:
    xs = sorted(xs)
    return {"count": len(xs), "sum": float(sum(xs)),
            "p50": xs[len(xs) // 2] if xs else None,
            "max": xs[-1] if xs else None}


def gaps(recs, every: int) -> dict:
    """The device-idle gaps between consecutive `segment` spans (the next
    dispatch minus this segment's results-ready, clamped at 0; a
    synchronous segment's save falls in its gap), split by whether the
    earlier segment saved."""
    segs = sorted((r for r in recs if r["name"] == "segment"),
                  key=lambda r: r["segment"])
    split = {"after_checkpoint": [], "others": []}
    for a, b in zip(segs, segs[1:]):
        split["after_checkpoint" if a["segment"] % every == 0
              else "others"].append(max(0.0, b["ts"] - a["ts"] - a["dur"]))
    return {k: stats(v) for k, v in split.items()}


def report_rows(reps) -> list:
    return [{**dataclasses.asdict(r), "elapsed": None} for r in reps]


def same_files(label, a, b):
    """Two checkpoints hold the same counters and live rows, worker by
    worker."""
    (x, _), (y, _) = (checkpoint.load(p, device="cpu") for p in (a, b))
    for f in device.COUNTER_DTYPES:
        check(torch.equal(getattr(x, f), getattr(y, f)),
              f"{label}: worker {f} differs")
    for d, n in enumerate(x.size.tolist()):
        check(all(torch.equal(getattr(x, f)[d, ..., :n],
                              getattr(y, f)[d, ..., :n])
                  for f in checkpoint.POOL_FIELDS),
              f"{label}: worker {d}'s live rows differ")


# (1) ta021 LB2 ub=opt at the bench shape on four workers, a save after
# every one-step segment (balance period 1), S14 segments from the same
# seeded state (max_rounds: neither driver runs past them): overlap off,
# on, and on with a save every second segment. The pools grow some 16
# times a step from the warm-up's 32 nodes a worker, and a save of a
# 4-step pool (1.15 M rows a worker) took 38-43 s, so the run stops
# after three steps, its last save some 600,000 rows
S14 = 3
OV21 = dict(lb_kind=2, init_ub=taillard.optimal_makespan(21), chunk=C21,
            capacity=CAP21, balance_period=1, segment_iters=1,
            max_rounds=S14, devices=W4)
OV = {}
for label, overlap, every in (("off", False, 1), ("on", True, 1),
                              ("on, save every 2", True, 2)):
    reps, ck = [], SEG14 / f"ov21_{len(OV)}.npz"
    with flight() as recs:
        res, counts, secs = ovl_run(
            f"ta021 overlap {label}", ("fused_expand", "lb2_sweep"),
            lambda: distributed.search(
                P21, overlap=overlap, checkpoint_path=str(ck),
                checkpoint_every=every, heartbeat=reps.append, **OV21))
    spans = [r for r in recs if r["name"] == "segment"]
    check(len(spans) == S14 and all(bool(r.get("overlapped")) == overlap
                                    for r in spans),
          f"ta021 overlap {label}: segment spans {len(spans)}")
    writer = [r for r in recs if r["name"] == "checkpoint.writer"]
    OV[label] = dict(reps=report_rows(reps), file=ck, res=res)
    say(f"ta021 lb2 D=4 overlap {label} ({S14} one-step segments, a save "
        f"every {every})", wall_seconds=secs,
        gaps=gaps(recs, every),
        segment_ms=[round(1e3 * r["dur"], 3) for r in spans],
        save_seconds=[(round(r["dur"], 4), r["thread"]) for r in recs
                      if r["name"] == "checkpoint.save"],
        save_bytes=[r.get("bytes") for r in recs
                    if r["name"] == "checkpoint.save"],
        # the writer's tasks queued or being written, at most
        peak_pending=writer[0]["peak_pending"] if writer else None,
        pool=reps[-1].pool_size, tree=reps[-1].tree, launches=counts,
        card=CARD)
for label in ("on", "on, save every 2"):
    check(OV[label]["reps"] == OV["off"]["reps"],
          f"ta021 overlap {label}: a segment report differs from overlap "
          "off")
    same_files(f"ta021 overlap {label}", OV[label]["file"],
               OV["off"]["file"])
# the trailing no-op macro-iteration (of a drained or unaligned segment):
# one replay of phase 10's ta021 graph (period 4) past its ceiling,
# against an active one (phase 10's ms a macro-iteration)
NOOP = distributed._problem_driver(PF, W4, P21, 2, C21, BP21, TC21,
                                   2 * C21, fused="hw")
noop_states = NOOP.seed(FR21, CAP21, 20, min(FR21.best,
                                             taillard.optimal_makespan(21)))
noop_graph = NOOP._graph(noop_states, CAP21, 0)
noop_ms = cuda_ms(noop_graph.graph.replay, 10)
check(distributed.worker_counters(NOOP._graph_out(noop_states, noop_graph))
      ["iters"].max() == 0, "ta021: a replay past the ceiling stepped")
del NOOP, noop_states, noop_graph
device.clear_graphs()
say("ta021 lb2 D=4 period 4: one macro-iteration replay past its "
    "ceiling (no-op)", device_ms=noop_ms, card=CARD)

# (2) ta014 LB2 ub=opt on four workers, overlap on, a save after every
# 4-step segment, to the golden
ck14 = SEG14 / "ov14.npz"
res, counts, secs = ovl_run("ta014 overlap", DENSE, lambda: (
    distributed.search(P14, devices=W4, overlap=True, segment_iters=4,
                       checkpoint_path=str(ck14), **DIST14)))
dist_golden("ta014 overlap", res, (144639, 0, 1377))
check(counts["fused_expand"] == 0 and counts["expand_bounds"] == 0,
      f"ta014 overlap dense: launches {counts}")
say("dist ta014 lb2 D=4 overlap (dense, 4-step segments, a save each)",
    seconds=secs, launches=counts, card=CARD)

# (3) a stop under overlap after two segments; the checkpoint resumed once
# with overlap off and once with it on, both to the golden
ev14 = threading.Event()
stopped = []


def stop_after_two(rep):
    stopped.append(rep.segment)
    if rep.segment >= 2:
        ev14.set()


ck_stop = SEG14 / "stop14.npz"
part, _, _ = ovl_run("ta014 overlap stopped", DENSE, lambda: (
    distributed.search(P14, devices=W4, overlap=True, segment_iters=4,
                       checkpoint_path=str(ck_stop), stop_event=ev14,
                       heartbeat=stop_after_two, **DIST14)))
check(not part.complete and stopped[-1] <= 3,
      f"ta014 overlap stop: segments {stopped}")
for overlap in (False, True):
    ck_copy = SEG14 / f"stop14_{int(overlap)}.npz"
    shutil.copy(ck_stop, ck_copy)
    res, counts, secs = ovl_run(
        f"ta014 resumed, overlap {overlap}", DENSE, lambda: (
            distributed.search(P14, devices=W4, overlap=overlap,
                               segment_iters=64,
                               checkpoint_path=str(ck_copy), **DIST14)))
    dist_golden(f"ta014 resumed, overlap {overlap}", res,
                (144639, 0, 1377))
    say(f"dist ta014 stopped under overlap at segment {stopped[-1]}, "
        f"resumed with overlap {'on' if overlap else 'off'}",
        seconds=secs, launches=counts)

# (4) two ranks sharing the card (`--multihost`, gloo): ta014 LB2 ub=opt,
# -D 4 (two workers a rank), the golden's chunk and capacity, 4-step
# segments: a run truncated after two macro-iterations, resumed by two
# processes and, from a copy, by one


def mp_job(label, argv, expect=DENSE, timeout=240):
    """`python -m torch.distributed.run --nproc-per-node 2 chip_smoke.py
    --mp-rank DIR argv`: both ranks must exit 0; returns their reports,
    their launches joining MPL (each kernel of `expect` launched)."""
    out = Path(tempfile.mkdtemp(prefix="tts_chip_smoke_mp_"))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t = time.perf_counter()
    # its own process group, so a timeout stops the ranks with torchrun
    job = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "localhost", "--master-port", str(port),
         str(Path(__file__).resolve()), "--mp-rank", str(out), *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        start_new_session=True)
    try:
        stdout, stderr = job.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(job.pid, signal.SIGKILL)
        stdout, stderr = job.communicate()
    secs = time.perf_counter() - t
    check(job.returncode == 0, f"{label}: rc {job.returncode}\n"
          f"{stdout[-3000:]}\n{stderr[-3000:]}")
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    shutil.rmtree(out)
    total = {k: sum(r["launches"][k] for r in ranks) for k in MPL}
    for k, v in total.items():
        MPL[k] += v
    for k in expect:
        check(total[k] > 0, f"{label}: kernel {k} never launched")
    for r in ranks:
        check(r["rc"] == 0 and r["world"] == 2,
              f"{label}: rank {r['rank']} rc {r['rc']}")
        say(f"{label}: rank {r['rank']}", seconds=r["seconds"],
            macro_iterations=r["macro_iterations"],
            round_host_ms_per_macro_iteration=r[
                "round_host_ms_per_macro_iteration"],
            writes=r["writes"], launches=r["launches"], card=CARD)
    return ranks, secs


MP14 = ["--multihost", "pfsp", "-i", "14", "-l", "2", "-u", "1", "-D", "4",
        "--chunk", "4096", "--capacity", str(1 << 20), "--segment-iters",
        "4"]
# a truncated two-process run with a checkpoint (rank 0 alone writes)
ck_mp = SEG14 / "mp14.npz"
ranks, secs = mp_job("multihost ta014 D=4 truncated",
                     MP14 + ["--checkpoint", str(ck_mp), "--max-iters", "2"])
check(ranks[0]["writes"] > 0 and ranks[1]["writes"] == 0,
      f"multihost checkpoint writes {[r['writes'] for r in ranks]}")
check(all("truncated run" in r["stdout"] for r in ranks),
      "multihost truncated: a rank did not stop")
shutil.copy(ck_mp, SEG14 / "mp14_one.npz")
say("multihost ta014 D=4 truncated (2 ranks sharing the card)",
    seconds=secs, card=CARD)
# resumed by the two processes: both print the golden, and rank 0's CSV row
# (the `dist` schema) holds the per-worker trees of one process driving the
# same four workers uninterrupted
csv14 = SEG14 / "mp.csv"
ranks, secs = mp_job("multihost ta014 D=4 resumed",
                     MP14 + ["--checkpoint", str(ck_mp), "--csv", str(csv14)])
for r in ranks:
    cli_golden(f"multihost resume rank {r['rank']}", r["rc"], r["stdout"])
one = distributed.search(P14, lb_kind=2, init_ub=1377, devices=W4,
                         chunk=4096, capacity=1 << 20, balance_period=4,
                         min_seed=25)
dist_golden("one process, the command's ta014 D=4", one, (144639, 0, 1377))
row = csv14.read_text().splitlines()
check(row[0] == csv_stats.DIST_HEADER and len(row) == 2,
      f"multihost csv: {row[:1]} ({len(row)} lines)")
trees = json.loads(next(csv.reader([row[1]]))[13])
check(trees == one.per_device["tree"].tolist(),
      f"multihost per-worker tree {trees} != one process's "
      f"{one.per_device['tree'].tolist()}")
say("multihost ta014 D=4 resumed (2 ranks sharing the card)", seconds=secs,
    per_worker_tree=trees, card=CARD)
# the two-process checkpoint resumed by one process
res, counts, _ = path_run("ta014 two-process checkpoint, one process",
                          DENSE, lambda: distributed.search(
    P14, lb_kind=2, init_ub=1377, devices=W4, chunk=4096,
    capacity=1 << 20, balance_period=4, min_seed=25, segment_iters=64,
    checkpoint_path=str(SEG14 / "mp14_one.npz")))
for k, v in counts.items():
    MPL[k] += v
dist_golden("two-process checkpoint resumed in one process", res,
            (144639, 0, 1377))
shutil.rmtree(SEG14)
say("phase 14 seconds", seconds=time.perf_counter() - t_phase14,
    overlap_launches=OVL, mp_launches=MPL)

# --- phase 15: request megabatching --------------------------------------
device.clear_graphs()
t_phase15 = time.perf_counter()
MB = dict.fromkeys(kernels.LAUNCHES, 0)
SEG15 = Path(tempfile.mkdtemp(prefix="tts_chip_smoke_mb_"))
W1 = [DEV]
# every 20x5 instance with an LB2 ub=opt golden
GOLD_LB2 = {r["inst"]: (r["tree"], r["sol"], r["best"]) for r in map(
    json.loads, (ROOT / "tests" / "golden" / "pfsp_lb2_ub1.jsonl")
    .read_text().splitlines())}
I20X5 = (1, 2, 3, 4, 7, 8, 9, 10)
BIG, STOPPED = 8, 10       # the largest tree; the member stopped in (3)
MB5 = dict(problem="pfsp", lb_kind=2, devices=W1, chunk=16384,
           capacity=1 << 21, balance_period=4, segment_iters=64)
DENSE_MB = ("expand_emit", "expand_fronts", "lb2_sweep")


def mb_specs(insts, **kw):
    return [megabatch.MemberSpec(table=taillard.processing_times(i),
                                 init_ub=taillard.optimal_makespan(i), **kw)
            for i in insts]


def mb_run(label, expect, **kw):
    """One `serve_batch` (graphs dropped first), its launches joining MB;
    returns (results, launches, seconds, driver)."""
    device.clear_graphs()
    with recording(megabatch, "BatchedDriver") as drv:
        res, counts, secs = path_run(label, expect,
                                     lambda: megabatch.serve_batch(**kw))
    for k, v in counts.items():
        MB[k] += v
    return res, counts, secs, drv[0]


def mb_golden(label, insts, res):
    for i, r in zip(insts, res):
        dist_golden(f"{label} ta{i:03d}", r, GOLD_LB2[i])


def last_graph(kind: str):
    return next(g for k, g in reversed(device._GRAPHS.items())
                if k[0] == kind)


def per_replay(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


# (1) the whole 20x5 class in one batch, one worker a member
beats: dict[int, int] = {}
done_at: list = []
torch.cuda.reset_peak_memory_stats(DEV)
res1, counts, secs1, drv1 = mb_run(
    "megabatch 20x5 B=8", DENSE_MB, specs=mb_specs(I20X5),
    heartbeat=lambda b, rep: beats.__setitem__(b, rep.segment),
    on_member_done=lambda b, r: done_at.append((I20X5[b], beats[b])), **MB5)
peak1 = torch.cuda.max_memory_allocated(DEV)
mb_golden("megabatch 20x5", I20X5, res1)
check(counts["fused_expand"] == 0 and counts["expand_bounds"] == 0
      and counts["expand_fronts"] == counts["expand_emit"],
      f"megabatch 20x5: launches {counts}")
seg_big = dict(done_at)[BIG]
check(done_at[-1][0] == BIG
      and all(s < seg_big for i, s in done_at if i != BIG),
      f"megabatch 20x5: members drained at {done_at}")
g1 = last_graph("batch")
mb_replay = per_replay(g1.launches)
# every member drained: a replay is a no-op for all eight
frozen_ms = cuda_ms(g1.graph.replay, 10)
del g1
device.clear_graphs()
solo_secs, solo_ms = {}, {}
for i in I20X5:
    p = taillard.processing_times(i)
    with recording(distributed, "_DistDriver") as sd:
        r, c, s = path_run(f"solo ta{i:03d}", DENSE_MB if GOLD_LB2[i][0]
                           else (), lambda: distributed.search(
            p, init_ub=taillard.optimal_makespan(i),
            **{k: v for k, v in MB5.items() if k != "problem"}))
    dist_golden(f"solo ta{i:03d}", r, GOLD_LB2[i])
    solo_secs[i] = s
    if i == BIG:
        gs = last_graph("dist")
        solo_replay = per_replay(gs.launches)
        solo_frozen_ms = cuda_ms(gs.graph.replay, 10)
        solo_ms[BIG] = 1e3 * s / max(sd[0].macro_iters, 1)
        del gs
    device.clear_graphs()
check(mb_replay == {k: len(I20X5) * v for k, v in solo_replay.items()},
      f"megabatch 20x5: a replay launches {mb_replay}, solo {solo_replay}")
say("megabatch 20x5 B=8 (ta001-ta010 with goldens, LB2 ub=opt, chunk "
    "16384 a member, capacity 2^21, 64-step segments, one worker each)",
    batch_seconds=secs1, solo_seconds_sum=sum(solo_secs.values()),
    solo_seconds=solo_secs, macro_iterations=drv1.macro_iters,
    ms_per_macro_iteration=1e3 * secs1 / drv1.macro_iters,
    solo_big_ms_per_macro_iteration=solo_ms[BIG],
    frozen_batch_replay_device_ms=frozen_ms,
    frozen_solo_replay_device_ms=solo_frozen_ms,
    captures=drv1.captures,
    host_reads_per_replay=drv1.host_reads / drv1.macro_iters,
    launches_per_replay=mb_replay, solo_launches_per_replay=solo_replay,
    drained_at_segment=done_at, peak_memory_bytes=peak1, launches=counts,
    card=CARD)

# (2) the unfused prefilter route, bounded: ta021-ta024, stopped by
# stop_event after two 8-step segments, each member against a solo
# `_DistDriver.run(max_iters=16)` from the same seeded state
I20X20 = (21, 22, 23, 24)
ev15 = threading.Event()
res2, counts, secs2, drv2 = mb_run(
    "megabatch 20x20 B=4", ("expand_bounds", "lb2_sweep"),
    specs=mb_specs(I20X20), stop_event=ev15,
    heartbeat=lambda b, rep: rep.segment >= 1 and ev15.set(),
    problem="pfsp", lb_kind=2, devices=W1, chunk=65536, capacity=1 << 22,
    balance_period=4, segment_iters=8)
check(counts["fused_expand"] == 0 and counts["expand_emit"] == 0,
      f"megabatch 20x20: launches {counts}")
for i, r in zip(I20X20, res2):
    p = taillard.processing_times(i)
    tc = distributed.default_transfer_cap(
        65536, 20, PF.aux_rows(p), 1, aux_itemsize=PF.aux_dtype(p).itemsize)
    check(not r.complete and r.per_device["iters"].tolist() == [16],
          f"megabatch ta{i:03d}: iters {r.per_device['iters']}")
    drv = distributed._problem_driver(PF, W1, p, 2, 65536, 4, tc,
                                      2 * 65536, fused="off")
    fr = PF.warmup(p, 2, taillard.optimal_makespan(i), target=32)
    fr.aux = PF.seed_aux(p, fr.prmu, fr.depth)
    solo = distributed.worker_counters(drv.run(
        drv.seed(fr, 1 << 22, 20, min(fr.best, taillard.optimal_makespan(i))),
        max_iters=16))
    for f in DIST_FIELDS:
        check(np.array_equal(r.per_device[f], solo[f]),
              f"megabatch ta{i:03d}: worker {f} differs from solo")
    check(np.array_equal(r.per_device["final_size"], solo["size"])
          and r.best == int(solo["best"].min()),
          f"megabatch ta{i:03d}: pool or best differs from solo")
    device.clear_graphs()
say("megabatch 20x20 B=4 (ta021-ta024, LB2 ub=opt, unfused prefilter, chunk "
    "65536, capacity 2^22, stopped after two 8-step segments)",
    equal_to_solo=True, seconds=secs2, macro_iterations=drv2.macro_iters,
    ms_per_macro_iteration=1e3 * secs2 / drv2.macro_iters,
    captures=drv2.captures, trees=[r.explored_tree for r in res2],
    launches=counts, card=CARD)

# (3) stop and resume: leg (1)'s batch without ta008, ta010 stopped at
# segment 2 with a checkpoint that the solo search resumes to the golden
I7 = tuple(i for i in I20X5 if i != BIG)
ck15 = SEG15 / "stopped.npz"
specs3 = mb_specs(I7)
specs3[I7.index(STOPPED)].checkpoint_path = str(ck15)
stopped15 = []
res3, counts, secs3, _ = mb_run(
    "megabatch 20x5 stop", DENSE_MB, specs=specs3,
    member_stop=lambda b, rep: I7[b] == STOPPED and rep.segment == 2,
    on_member_stopped=lambda b, r: stopped15.append(I7[b]), **MB5)
check(stopped15 == [STOPPED] and not res3[I7.index(STOPPED)].complete,
      f"megabatch stop: stopped {stopped15}")
mb_golden("megabatch stop batchmates", [i for i in I7 if i != STOPPED],
          [r for i, r in zip(I7, res3) if i != STOPPED])
device.clear_graphs()
res_st, _, secs_st = path_run("stopped member resumed solo", DENSE_MB,
                              lambda: distributed.search(
    taillard.processing_times(STOPPED),
    init_ub=taillard.optimal_makespan(STOPPED), checkpoint_path=str(ck15),
    **{k: v for k, v in MB5.items() if k != "problem"}))
dist_golden(f"ta{STOPPED:03d} stopped in a batch, resumed solo", res_st,
            GOLD_LB2[STOPPED])
say(f"megabatch 20x5 B={len(I7)}: ta{STOPPED:03d} stopped at segment 2, "
    "resumed solo", batch_seconds=secs3, resume_seconds=secs_st,
    stopped_tree=res3[I7.index(STOPPED)].explored_tree, launches=counts,
    card=CARD)

# (4a) per-member balance rounds on the card: ta003 and ta004, two workers
# a member, to the goldens and to each member's solo search
MB4 = dict(MB5, devices=W2, min_transfer=512)
res4, counts, secs4, drv4 = mb_run("megabatch 20x5 B=2 D=2", DENSE_MB,
                                   specs=mb_specs((3, 4)), **MB4)
mb_golden("megabatch D=2", (3, 4), res4)
check(int(res4[0].per_device["sent"].sum()) > 0,
      "megabatch D=2: no balance round moved nodes")
for i, r in zip((3, 4), res4):
    device.clear_graphs()
    solo = distributed.search(taillard.processing_times(i),
                              init_ub=taillard.optimal_makespan(i),
                              **{k: v for k, v in MB4.items()
                                 if k != "problem"})
    for f in DIST_FIELDS:
        check(np.array_equal(r.per_device[f], solo.per_device[f]),
              f"megabatch D=2 ta{i:03d}: worker {f} differs from solo")
say("megabatch 20x5 B=2 D=2 (ta003, ta004, two workers a member)",
    seconds=secs4, sent=[r.per_device["sent"].tolist() for r in res4],
    captures=drv4.captures, launches=counts, card=CARD)

# (4b) J > 64: ta071 and ta072, chunk 8192, capacity 2^21, stopped after
# two 4-step segments, against solo at the same ceiling
I100 = (71, 72)
ev15b = threading.Event()
res5, counts, secs5, _ = mb_run(
    "megabatch 100x10 B=2", ("expand_bounds", "lb2_sweep_bigj"),
    specs=mb_specs(I100), stop_event=ev15b,
    heartbeat=lambda b, rep: rep.segment >= 1 and ev15b.set(),
    problem="pfsp", lb_kind=2, devices=W1, chunk=8192, capacity=1 << 21,
    balance_period=4, segment_iters=4)
for i, r in zip(I100, res5):
    p = taillard.processing_times(i)
    tc = distributed.default_transfer_cap(
        8192, 100, PF.aux_rows(p), 1, aux_itemsize=PF.aux_dtype(p).itemsize)
    check(r.per_device["iters"].tolist() == [8],
          f"megabatch ta{i:03d}: iters {r.per_device['iters']}")
    drv = distributed._problem_driver(PF, W1, p, 2, 8192, 4, tc,
                                      2 * 8192, fused="off")
    fr = PF.warmup(p, 2, taillard.optimal_makespan(i), target=32)
    fr.aux = PF.seed_aux(p, fr.prmu, fr.depth)
    solo = distributed.worker_counters(drv.run(
        drv.seed(fr, 1 << 21, 100, min(fr.best,
                                       taillard.optimal_makespan(i))),
        max_iters=8))
    for f in DIST_FIELDS:
        check(np.array_equal(r.per_device[f], solo[f]),
              f"megabatch ta{i:03d}: worker {f} differs from solo")
    device.clear_graphs()
say("megabatch 100x10 B=2 (ta071, ta072, LB2 ub=opt, chunk 8192, capacity "
    "2^21, stopped after two 4-step segments)", equal_to_solo=True,
    seconds=secs5, trees=[r.explored_tree for r in res5], launches=counts,
    card=CARD)
shutil.rmtree(SEG15)
say("phase 15 seconds", seconds=time.perf_counter() - t_phase15,
    mb_launches=MB)

for r in RESULTS:
    check(r["launches"] > 0, f"{r['name']}: no launch on its main path")
    key = r.pop("launches_key")
    r["dist_launches"] = DIST_FROM[key][key] if key in DIST_FROM else 0
    r["hybrid_launches"] = HYB[key]
    r["ladder_launches"] = LAD[key]
    r["tune_launches"] = TUNE[key]
    r["overlap_launches"] = OVL[key]
    r["mp_launches"] = MPL[key]
    r["mb_launches"] = MB[key]
print(json.dumps({"kernels": RESULTS}), flush=True)
print(json.dumps({"ok": True, "device": {
    "platform": "gpu", "kind": torch.cuda.get_device_name(0),
    "count": torch.cuda.device_count()}}), flush=True)
