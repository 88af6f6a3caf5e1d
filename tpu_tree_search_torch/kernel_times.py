"""Time the Hopper kernels at the main path's shapes, two ways.

    python -m tpu_tree_search_torch.kernel_times [--label NAME] [--generic-m]

Needs one CUDA card. Each row is one kernel at one shape, on the same
inputs `chip_smoke.py` uses: the chunk popped from the ta021 pool after
250 LB2 steps at chunk 65536 (the fused kernel at the fused LB2 route's
shape, the 166-pair tail sweep over the N/4 frame, the bounds-only expand
kernel), seeded random chunks of ta007, ta071 and ta091, and the expand
kernel's rows of `expand_rows` (the LB2 pre-prune at J = 100 and 200,
the dense route at ta014 and ta041). For every row it prints one JSON line
with

- `ms`: device time per call, the calls run back to back behind a spin
  kernel that holds the stream while the host queues them (`kernel_ms`);
- `event_ms`: CUDA-event time per call of back-to-back calls queued as
  they come (`cuda_ms`), which the host's own work per call can exceed;
- `host_ms`: the host's time to queue one call.

`--generic-m` also times the fused rows with a library built from
`csrc/fused_expand.cu` less its instances with M fixed at compile time
(M = 5, 10, 20 then run the generic instances), to show what the fixed-M
instances are worth. The script uses only the package's public pieces
that every version of the port has, so a copy of it can time an earlier
checkout's kernels on the same card: run parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import shutil
import subprocess
import time

import numpy as np
import torch

from .engine import device
from .ops import batched, expand as ex, kernels
from .problems import taillard
from .tune.defaults import BENCH_CHUNK_DEFAULT


def cuda_ms(fn, reps: int) -> float:
    """Mean time of fn() over `reps` back-to-back calls by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def kernel_ms(fn, reps: int, host: list | None = None) -> float:
    """Device time of fn() per call, the calls run back to back: a spin
    kernel holds the stream while the host queues them, so unlike
    `cuda_ms` the time leaves out the device's waits for the host, which
    a wrapper's Python work can outlast on a kernel this short. Appends
    the host's ms per queued call to `host`. Raises if the spin ended
    before the host had queued every call."""
    fn()
    torch.cuda.synchronize()
    spin = 1 << 26                   # clock cycles, some 35 ms at 1.98 GHz
    for _ in range(4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        b.record()
        queued_in_time = not a.query()
        torch.cuda.synchronize()
        if queued_in_time:
            if host is not None:
                host.append(1e3 * (t1 - t0) / reps)
            return a.elapsed_time(b) / reps
        spin *= 4
    raise RuntimeError("the host could not queue the timed calls ahead of "
                       "the device")


def random_chunk(p: np.ndarray, B: int, seed: int, dev: torch.device):
    """B random parents of instance p on the card: permutation, depth and
    the front of the scheduled prefix."""
    M, J = p.shape
    g = torch.Generator(device=dev).manual_seed(seed)
    prmu = torch.argsort(torch.rand((B, J), generator=g, device=dev), dim=1)
    depth = torch.randint(0, J, (B,), generator=g, device=dev)
    pt = torch.as_tensor(p.T.copy(), device=dev)
    front = torch.zeros((B, M), dtype=torch.int32, device=dev)
    for q in range(J):
        pj = pt[prmu[:, q]]
        c = [front[:, 0] + pj[:, 0]]
        for k in range(1, M):
            c.append(torch.maximum(c[-1], front[:, k]) + pj[:, k])
        front = torch.where((q < depth)[:, None], torch.stack(c, 1), front)
    return (prmu.T.to(torch.int16).contiguous(),
            depth.to(torch.int32)[None, :].contiguous(),
            front.T.contiguous())


@contextlib.contextmanager
def generic_m_library():
    """The fused kernel's library built from its source less the lines
    that pick an instance with M fixed at compile time."""
    src = (kernels.CSRC / "fused_expand.cu").read_text()
    fixed = re.compile(r"^\s*if \(M == \d+\) return .*launch<(\d+), \1>")
    kept = [ln for ln in src.splitlines(keepends=True)
            if not fixed.match(ln)]
    if len(kept) != len(src.splitlines()) - 3:
        raise RuntimeError("fused_expand.cu: expected three fixed-M lines")
    root = kernels.BUILD_DIR / "generic_m"
    csrc = root / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for h in kernels.CSRC.glob("*.cuh"):
        shutil.copy(h, csrc / h.name)
    (csrc / "fused_expand.cu").write_text("".join(kept))
    saved = kernels.CSRC, kernels.BUILD_DIR, kernels._libs.pop(
        "fused_expand", None)
    kernels.CSRC, kernels.BUILD_DIR = csrc, root
    try:
        kernels.build(["fused_expand"])
        yield
    finally:
        kernels._libs.pop("fused_expand", None)
        kernels.CSRC, kernels.BUILD_DIR = saved[:2]
        if saved[2] is not None:
            kernels._libs["fused_expand"] = saved[2]


def rows(dev: torch.device):
    """(name, kernel, launch) for every timed row, inputs built here."""
    chunk = BENCH_CHUNK_DEFAULT
    p21 = taillard.processing_times(21)
    t21 = batched.make_tables(p21, device=dev)
    s = device.init_state(20, 1 << 22, taillard.optimal_makespan(21),
                          p_times=p21, device=dev)
    s = device.run_growing(t21, s, 2, chunk, 250, fused="hw")
    pp, pd, pa, n_pop, _, _ = device.pop_chunk(s, chunk, 20)
    if n_pop != chunk or s.best != 2297:
        raise RuntimeError(f"ta021: popped {n_pop}, best {s.best}")
    pa = pa.to(torch.int32).contiguous()
    tb21 = device.lb2_route(20, 20, 190, chunk)[1]
    cap21 = torch.full((), s.best, dtype=torch.int32, device=dev)
    out = [("fused ta021 prefilter", "fused", lambda: kernels.fused_expand(
        t21, pp, pd, pa, chunk, cap21, tb21, chunk * 20 // 4, True, 0,
        False, False))]
    for inst, B, tile, bins, bounds, i16 in ((7, 4096, None, 8, True, True),
                                             (91, 4096, 128, 0, False,
                                              True)):
        p = taillard.processing_times(inst)
        M, J = p.shape
        tb = batched.make_tables(p, device=dev)
        tile = tile or ex.effective_tile(J, B, 1024, 1, machines=M)
        args = (tb, *random_chunk(p, B, inst, dev), B,
                torch.full((), taillard.optimal_makespan(inst),
                           dtype=torch.int32, device=dev),
                tile, B * J, False, bins, bounds, i16)
        out.append((f"fused ta{inst:03d} lb1", "fused",
                    lambda a=args: kernels.fused_expand(*a)))
    cf21 = ex.expand_plain(t21, pp, pd, pa, 1, 1024)[1][:20]
    sched21 = ex.sched_mask_cols(pp, pd, 1024)
    w4 = cf21.shape[1] // 4
    tail = batched.pair_split(t21, batched.PAIR_PREFILTER)[1]
    cf_t, sc_t = cf21[:, :w4], sched21[:, :w4]
    out.append(("sweep ta021 166-pair tail", "sweep",
                lambda: kernels.lb2_sweep(tail, cf_t, sc_t)))
    p71 = taillard.processing_times(71)
    t71 = batched.make_tables(p71, device=dev)
    prmu, depth2, front = random_chunk(p71, 2048, 71, dev)
    cf71 = ex.expand_plain(t71, prmu, depth2, front, 1, 2048)[1][:10]
    sc71 = ex.sched_mask_cols(prmu, depth2, 2048)
    out.append(("sweep ta071 (J > 64)", "sweep",
                lambda: kernels.lb2_sweep(t71, cf71, sc71)))
    out.append(("expand bounds ta021 lb1", "expand",
                lambda: kernels.expand_bound(t21, pp, pd, pa, 1, 1024,
                                             False)))
    out += expand_rows(dev)
    return out


def pool_chunk(inst: int, chunk: int, steps: int, dev: torch.device,
               ub: int | None = None):
    """The tables, the chunk popped after `steps` LB2 steps of Taillard
    instance `inst` from the root (unfused), and the LB2 route's tile."""
    p = taillard.processing_times(inst)
    M, J = p.shape
    tb = batched.make_tables(p, device=dev)
    s = device.init_state(J, 1 << 21, ub, p_times=p, device=dev)
    s = device.run_growing(tb, s, 2, chunk, steps, fused="off")
    prmu, depth2, front, n_pop, _, _ = device.pop_chunk(s, chunk, M)
    if n_pop != chunk:
        raise RuntimeError(f"ta{inst:03d}: popped {n_pop} < {chunk}")
    tile = device.lb2_route(J, M, M * (M - 1) // 2, chunk)[1]
    return tb, prmu, depth2, front.to(torch.int32).contiguous(), tile


def expand_rows(dev: torch.device):
    """The expand kernel's rows: bounds-only at the J = 100 and J = 200
    LB2 pre-prune (chunk 4096, popped after 3 steps from the root with no
    incumbent), full emit at ta014's dense shape (chunk 4096, popped after
    8 steps with ub=opt), and ta041's dense stage (chunk 65536, a random
    chunk): the full emit launch, the full emit launch with
    `sched_mask_cols` (what a checkout without the fronts-only launch
    runs there) and, where the checkout has it, the fronts-only launch."""
    out = []
    for inst in (71, 91):
        tb, prmu, depth2, front, tile = pool_chunk(inst, 4096, 3, dev)
        out.append((f"expand bounds ta{inst:03d} chunk 4096 tile {tile} "
                    "lb1", "expand",
                    lambda a=(tb, prmu, depth2, front, 1, tile, False):
                    kernels.expand_bound(*a)))
    tb, prmu, depth2, front, tile = pool_chunk(
        14, 4096, 8, dev, taillard.optimal_makespan(14))
    out.append((f"expand emit ta014 dense chunk 4096 tile {tile}", "expand",
                lambda a=(tb, prmu, depth2, front, 1, tile, True):
                kernels.expand_bound(*a)))
    p41 = taillard.processing_times(41)
    t41 = batched.make_tables(p41, device=dev)
    chunk = BENCH_CHUNK_DEFAULT
    tile = device.lb2_route(50, 10, 45, chunk)[1]
    c41 = random_chunk(p41, chunk, 41, dev)

    def emit_and_words():
        kernels.expand_bound(t41, *c41, 1, tile, True)
        ex.sched_mask_cols(c41[0], c41[1], tile)

    out.append((f"dense stage ta041 chunk {chunk} tile {tile}: emit",
                "expand",
                lambda: kernels.expand_bound(t41, *c41, 1, tile, True)))
    # "ops": a kernel with torch operations around it, timed over fewer
    # calls, so that its launches fit the stream's queue behind the spin
    out.append((f"dense stage ta041 chunk {chunk} tile {tile}: emit + "
                "sched_mask_cols", "ops", emit_and_words))
    if hasattr(kernels, "expand_fronts"):
        out.append((f"dense stage ta041 chunk {chunk} tile {tile}: "
                    "fronts-only", "expand",
                    lambda: kernels.expand_fronts(t41, *c41, tile)))
    return out


def time_row(fn, kind: str) -> dict:
    reps = 3 if kind == "ops" else 20
    host: list[float] = []
    ms = kernel_ms(fn, reps, host)
    return {"ms": ms, "event_ms": cuda_ms(fn, reps), "host_ms": host[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--generic-m", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: torch finds no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    kernels.build()
    timed = rows(dev)
    for name, kind, fn in timed:
        rec = {"label": args.label, "row": name, "card": smi,
               **time_row(fn, kind)}
        print(json.dumps(rec), flush=True)
    if args.generic_m:
        with generic_m_library():
            for name, kind, fn in timed:
                if kind == "fused":
                    rec = {"label": args.label + ", generic M", "row": name,
                           "card": smi, **time_row(fn, kind)}
                    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
