"""Build, bind and launch the port's Hopper kernels.

Three CUDA C++ sources under `tpu_tree_search_torch/csrc/` replace the
five Pallas kernels of `tpu_tree_search/ops/pallas_expand.py` and
`tpu_tree_search/ops/pallas_fused.py`:

- `expand_bound.cu` (`_expand_kernel` in emit mode, `_bounds_kernel`
  bounds-only; an emit launch may write any set of its outputs, and the
  dense LB2 route writes only the child fronts and scheduled-set words);
- `lb2_sweep.cu` (`_lb2_kernel` for J <= 64, `_lb2_bigj_kernel` for
  J > 64);
- `fused_expand.cu` (`_fused_kernel`).

`expand_bound.cu` and `fused_expand.cu` share the bound chain of
`lb1_chain.cuh`. Each source is compiled at first use by `nvcc` for
`sm_90a` into a shared library with a plain C interface (`_build/`,
listed in `.gitignore`; the file name carries a hash of the source, the
shared headers and the flags, so an edit rebuilds),
loaded with ctypes, and launched on PyTorch's current stream. A wrapper
checks device, dtype and shape, allocates its outputs with `torch.empty`,
raises when the launch returns an error, and adds one to its entry of
`LAUNCHES` per launch. A launch made while the stream is captured into a
CUDA graph runs only when the graph is replayed: it counts in `CAPTURED`,
and `replay` adds the graph's launches to `LAUNCHES` at each replay.
Nothing here runs on the CPU: the dispatchers in `ops/expand.py` and
`ops/fused.py` call these wrappers for CUDA tensors only.

No wrapper reads a value back to the host: counts the kernels depend on
(the fused kernel's popped count, the sweep's live columns) are passed
as device scalars, so a captured graph reads them at each replay.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .batched import BoundTables

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# source stem -> {C symbol: (argtypes, restype)}
_SOURCES = {
    "expand_bound": {"tts_expand_bound": (
        [_vp] * 5 + [_i32] * 7 + [_vp] * 6 + [_i64, _vp], _i32)},
    "lb2_sweep": {"tts_lb2_sweep": (
        [_vp, _i64, _vp, _i64, _i32, _vp, _i32, _i32] + [_vp] * 4, _i32)},
    "fused_expand": {
        "tts_fused_expand": (
            [_vp] * 7 + [_i32] * 8 + [_vp] * 7 + [_i64, _vp], _i32),
        "tts_fused_scratch_words": ([_i32] * 5, _i64)},
}

# launches per kernel entry, counted where each wrapper launches
# (an emit launch that writes only the fronts and the scheduled-set words,
# the dense LB2 route's, counts under "expand_fronts" too)
LAUNCHES = {"expand_emit": 0, "expand_fronts": 0, "expand_bounds": 0,
            "lb2_sweep": 0, "lb2_sweep_bigj": 0, "fused_expand": 0}
# the part of LAUNCHES made by replays of captured graphs
REPLAYED = dict.fromkeys(LAUNCHES, 0)
# launches recorded into a CUDA graph under capture, not yet taken by
# `take_captured`
CAPTURED = dict.fromkeys(LAUNCHES, 0)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# the counts are bumped from every thread that launches or replays (the
# search server's executor threads)
_count_lock = threading.Lock()
# nvcc seconds of the builds each thread made at first use
_builds = threading.local()


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = REPLAYED[k] = 0


def build_seconds() -> float:
    """The nvcc seconds of the library builds this thread has made at a
    kernel's first use (0 where every library was already built)."""
    return getattr(_builds, "seconds", 0.0)


def _count(key: str) -> None:
    """One launch of `key`: now, or at each replay of the graph the
    current stream is being captured into."""
    with _count_lock:
        if torch.cuda.is_current_stream_capturing():
            CAPTURED[key] += 1
        else:
            LAUNCHES[key] += 1


def take_captured() -> dict:
    """The launches recorded under capture since the last call, and
    clear them."""
    with _count_lock:
        out = {k: v for k, v in CAPTURED.items() if v}
        for k in CAPTURED:
            CAPTURED[k] = 0
    return out


def replay(graph: torch.cuda.CUDAGraph, launches: dict) -> None:
    """Replay a captured graph; its kernels launch now, so `launches`
    (its `take_captured` at capture) count now."""
    graph.replay()
    with _count_lock:
        for k, v in launches.items():
            LAUNCHES[k] += v
            REPLAYED[k] += v


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def library_path(stem: str) -> Path:
    src = (CSRC / f"{stem}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{stem}-{tag[:12]}.so"


def build(stems=None) -> dict:
    """Compile every missing library, one `nvcc` per source, all started
    together; the compiler's output is kept beside each library (`.log`),
    and a library without it is built again. Returns {stem: (seconds,
    compiler output)}, seconds 0 for a library already built, whose log
    is the one of the build that made it; raises on a failed build."""
    stems = list(_SOURCES if stems is None else stems)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for stem in stems:
        out = library_path(stem)
        if out.exists() and out.with_suffix(".log").exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[stem] = (tmp, out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    result = {stem: (0.0, library_path(stem).with_suffix(".log").read_text())
              for stem in stems if stem not in procs}
    for stem, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {stem}.cu:\n{log}")
        tmp_log = tmp.with_suffix(".log.tmp")
        tmp_log.write_text(log)
        os.replace(tmp, out)
        os.replace(tmp_log, out.with_suffix(".log"))
        result[stem] = (time.perf_counter() - t0, log)
    return result


def _lib(stem: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            path = library_path(stem)
            if not path.exists():
                t0 = time.perf_counter()
                build([stem])
                _builds.seconds = (build_seconds()
                                   + time.perf_counter() - t0)
            lib = ctypes.CDLL(str(path))
            for sym, (argtypes, restype) in _SOURCES[stem].items():
                getattr(lib, sym).argtypes = argtypes
                getattr(lib, sym).restype = restype
            _libs[stem] = lib
        return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _need(x: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# what an emit launch of the expand kernel can write
EMIT_OUTPUTS = frozenset(("children", "fronts", "depth", "bounds", "sched"))
_FULL_EMIT = frozenset(("children", "fronts", "depth", "bounds"))
_FRONTS = frozenset(("fronts", "sched"))


def expand_scratch_words(J: int, M: int, B: int, tile: int, lb_kind: int,
                         outputs) -> int:
    """Checks one launch of the expand kernel before anything is
    allocated, and returns its int32 scratch words, (M + SW) * B (the
    parents' remain, then their prefix scheduled-set words; SW = ceil(J /
    32) when the words are an output, else 0). `outputs` is None for the
    bounds-only mode, or a non-empty subset of `EMIT_OUTPUTS`."""
    if outputs is not None and (not outputs
                                or not EMIT_OUTPUTS.issuperset(outputs)):
        raise ValueError(f"expand kernel: outputs {sorted(outputs)} are "
                         f"not a non-empty subset of {sorted(EMIT_OUTPUTS)}")
    if lb_kind not in (0, 1):
        raise ValueError(f"expand kernel bounds LB1/LB1_d, not {lb_kind}")
    if tile <= 0 or B % tile != 0 or not 1 <= M <= 32 or J < 1 \
            or B * J >= 2**31:
        raise ValueError(f"expand kernel: B={B} tile={tile} M={M} J={J}")
    return (M + _sched_rows(J, outputs)) * B


def _sched_rows(J: int, outputs) -> int:
    return (J + 31) // 32 if outputs is not None and "sched" in outputs else 0


def expand_launch(tables: BoundTables, prmu_T: torch.Tensor,
                  depth2: torch.Tensor, front_T: torch.Tensor, lb_kind: int,
                  tile: int, outputs=None):
    """One launch of the expand kernel on (J, B) parents in tiles of
    `tile` (a pre-pass and the main pass, one C call). `outputs`: None for
    bounds-only (the bound of every child slot, I32_MAX below the
    parent's depth), or the emit outputs to write, a subset of
    `EMIT_OUTPUTS` (every slot computed). Returns (children (J, N) int16,
    aux, bounds (1, N) int32, sched (SW, N) int32), None for what is not
    written; aux (int32) holds the child fronts (M rows) when asked for,
    then the depth+1 row when asked for. N = B*J."""
    J, B = prmu_T.shape
    M = front_T.shape[0]
    words = expand_scratch_words(J, M, B, tile, lb_kind, outputs)
    _need(prmu_T, torch.int16, "prmu_T")
    _need(depth2, torch.int32, "depth2")
    _need(front_T, torch.int32, "front_T")
    _need(tables.p, torch.int32, "tables.p")
    if (depth2.numel() != B or front_T.shape[1] != B
            or tables.p.shape != (M, J)):
        raise ValueError("expand kernel: inconsistent shapes "
                         f"{tuple(prmu_T.shape)} {tuple(depth2.shape)} "
                         f"{tuple(front_T.shape)} {tuple(tables.p.shape)}")
    dev = prmu_T.device
    N = B * J
    emit = outputs is not None
    want = outputs if emit else frozenset(("bounds",))
    children = (torch.empty((J, N), dtype=torch.int16, device=dev)
                if "children" in want else None)
    rows = M * ("fronts" in want) + ("depth" in want)
    aux = torch.empty((rows, N), dtype=torch.int32, device=dev) if rows \
        else None
    bounds = (torch.empty((1, N), dtype=torch.int32, device=dev)
              if "bounds" in want else None)
    SW = _sched_rows(J, outputs)
    sched = (torch.empty((SW, N), dtype=torch.int32, device=dev)
             if "sched" in want else None)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    # inputs held in names until the launch is queued: a temporary's
    # memory could be handed to the next allocation before the kernel
    # reads it
    ins = [x.contiguous() for x in (tables.p, tables.min_tails, prmu_T,
                                    depth2.reshape(B), front_T)]
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    fronts = aux if "fronts" in want else None
    depth_row = aux[rows - 1] if "depth" in want else None
    rc = _lib("expand_bound").tts_expand_bound(
        *(x.data_ptr() for x in ins), J, M, B, tile, lb_kind, int(emit), SW,
        ptr(children), ptr(fronts), ptr(depth_row), ptr(bounds), ptr(sched),
        scratch.data_ptr(), words, _stream(dev))
    _check(rc, "expand_bound")
    if B:
        if not emit:
            _count("expand_bounds")
        else:
            _count("expand_emit")
            if outputs == _FRONTS:
                _count("expand_fronts")
    return children, aux, bounds, sched


def expand_bound(tables: BoundTables, prmu_T: torch.Tensor,
                 depth2: torch.Tensor, front_T: torch.Tensor, lb_kind: int,
                 tile: int, emit: bool):
    """The expand kernel's full contract: bounds (1, N) int32 and, with
    `emit`, children (J, N) int16 and aux (M+1, N) int32 = [child front |
    depth+1], N = B*J. Returns the three outputs (None for the two not
    emitted)."""
    return expand_launch(tables, prmu_T, depth2, front_T, lb_kind, tile,
                         _FULL_EMIT if emit else None)[:3]


def expand_fronts(tables: BoundTables, prmu_T: torch.Tensor,
                  depth2: torch.Tensor, front_T: torch.Tensor, tile: int):
    """The dense LB2 route's launch: only the child fronts (M, N) int32
    and the child's scheduled-set words (W, N) int32, W = ceil(J / 32)
    (`ops/expand.expand_fronts_plain`)."""
    _, fronts, _, sched = expand_launch(tables, prmu_T, depth2, front_T, 1,
                                        tile, _FRONTS)
    return fronts, sched


def lb2_sweep(tables: BoundTables, child_front_cols: torch.Tensor,
              sched_mask: torch.Tensor,
              live: torch.Tensor | None = None) -> torch.Tensor:
    """The pair-sweep kernel: child_front_cols (M, n), sched_mask (W, n)
    int32 (either may be a column prefix of a wider frame) -> (1, n)
    int32. `live`, a scalar tensor on the device (None: n), is read by
    the kernel: columns at or past it are not swept and read I32_MAX
    (`expand.mask_live`)."""
    M, n = child_front_cols.shape
    P, J = tables.js.shape
    W = (J + 31) // 32
    _need(sched_mask, torch.int32, "sched_mask")
    _need(tables.js, torch.int32, "tables.js")
    if sched_mask.shape != (W, n) or M != tables.p.shape[0] or W > 16:
        raise ValueError(f"lb2 sweep: cf {tuple(child_front_cols.shape)}, "
                         f"mask {tuple(sched_mask.shape)}, J={J}")
    cf = child_front_cols.to(torch.int32)
    _need(cf, torch.int32, "child_front_cols")
    dev = cf.device
    if sched_mask.device != dev or tables.js.device != dev:
        raise ValueError("lb2 sweep: inputs lie on different devices")
    if n and cf.stride(1) != 1:
        cf = cf.contiguous()
    if n and sched_mask.stride(1) != 1:
        sched_mask = sched_mask.contiguous()
    steps, pairs = tables.sweep_steps, tables.sweep_pairs
    if (steps.shape != (P, J, 4) or pairs.shape != (P, 4)
            or not (steps.is_contiguous() and pairs.is_contiguous())):
        raise ValueError("lb2 sweep: packed pair tables "
                         f"{tuple(steps.shape)} {tuple(pairs.shape)} do not "
                         f"match P={P}, J={J} or are not contiguous")
    if live is not None:
        if live.device != dev or live.numel() != 1:
            raise ValueError(f"lb2 sweep: live count {tuple(live.shape)} on "
                             f"{live.device}, not one value on {dev}")
        # held in a name until the launch is queued
        live = live.to(torch.int32).reshape(())
    out = torch.empty((1, n), dtype=torch.int32, device=dev)
    rc = _lib("lb2_sweep").tts_lb2_sweep(
        cf.data_ptr(), cf.stride(0), sched_mask.data_ptr(),
        sched_mask.stride(0), n, None if live is None else live.data_ptr(),
        J, P, steps.data_ptr(), pairs.data_ptr(), out.data_ptr(),
        _stream(dev))
    _check(rc, "lb2_sweep")
    if n:
        _count("lb2_sweep" if J <= 64 else "lb2_sweep_bigj")
    return out


@functools.lru_cache(maxsize=64)
def _fused_scratch_words(B: int, tile: int, J: int, M: int, SW: int) -> int:
    """int32 scratch of the fused kernel, from `fused_expand.cu` itself
    (look-back status words, remain and prefix words); raises for a shape
    the kernel does not take."""
    words = _lib("fused_expand").tts_fused_scratch_words(B, tile, J, M, SW)
    if words < 0:
        raise ValueError(f"fused kernel: B={B} tile={tile} J={J} M={M} "
                         "is not a shape it takes")
    return words


def fused_expand(tables: BoundTables, prmu_T: torch.Tensor,
                 depth2: torch.Tensor, front_T: torch.Tensor, n_valid,
                 bound_cap, tile: int, cap_width: int, with_sched: bool,
                 tele_bins: int, with_bounds: bool, aux_i16: bool):
    """The fused kernel on (J, B) parents in tiles of `tile`: the
    survivors of the LB1 prune against `bound_cap` among the first
    `n_valid` parents, compacted into a `cap_width`-wide frame. Both
    are int32 scalar tensors on the device that the kernel reads (an int
    is put on the device first); the kernel clamps `n_valid` to [0, B].
    Returns (children, caux, bounds | None, sched | None, n_surv,
    hist | None) as `ops/fused.fused_expand` documents."""
    J, B = prmu_T.shape
    M = front_T.shape[0]
    W = cap_width
    _need(prmu_T, torch.int16, "prmu_T")
    _need(depth2, torch.int32, "depth2")
    _need(front_T, torch.int32, "front_T")
    _need(tables.p, torch.int32, "tables.p")
    dev = prmu_T.device
    if not isinstance(bound_cap, torch.Tensor):
        bound_cap = torch.full((), int(bound_cap), dtype=torch.int32,
                               device=dev)
    if not isinstance(n_valid, torch.Tensor):
        n_valid = torch.full((), int(n_valid), dtype=torch.int32,
                             device=dev)
    _need(bound_cap, torch.int32, "bound_cap")
    _need(n_valid, torch.int32, "n_valid")
    if (depth2.numel() != B or front_T.shape[1] != B
            or tables.p.shape != (M, J) or bound_cap.numel() != 1
            or n_valid.numel() != 1
            or len({x.device for x in (prmu_T, depth2, front_T, tables.p,
                                       bound_cap, n_valid)}) != 1):
        raise ValueError("fused kernel: inconsistent inputs "
                         f"{tuple(prmu_T.shape)} {tuple(depth2.shape)} "
                         f"{tuple(front_T.shape)} {tuple(tables.p.shape)}")
    if (tile <= 0 or B % tile != 0 or not 1 <= M <= 32 or B * J >= 2**31
            or not 1 <= W <= B * J or not 0 <= tele_bins <= 64):
        raise ValueError(f"fused kernel: B={B} tile={tile} M={M} J={J} "
                         f"W={W} bins={tele_bins}")
    SW = (J + 31) // 32 if with_sched else 0
    children = torch.empty((J, W), dtype=torch.int16, device=dev)
    caux = torch.empty((M + 1, W), device=dev,
                       dtype=torch.int16 if aux_i16 else torch.int32)
    bounds = (torch.empty((1, W), dtype=torch.int32, device=dev)
              if with_bounds else None)
    sched = (torch.empty((SW, W), dtype=torch.int32, device=dev)
             if SW else None)
    n_surv = torch.empty((), dtype=torch.int32, device=dev)
    hist = (torch.empty((tele_bins,), dtype=torch.int64, device=dev)
            if tele_bins else None)
    scratch = torch.empty(_fused_scratch_words(B, tile, J, M, SW),
                          dtype=torch.int32, device=dev)
    # inputs held in names until the launch is queued: a temporary's
    # memory could be handed to the next allocation before the kernel
    # reads it
    ins = [x.contiguous() for x in (tables.p, tables.min_tails, prmu_T,
                                    depth2.reshape(B), front_T, bound_cap,
                                    n_valid)]
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    rc = _lib("fused_expand").tts_fused_expand(
        *(x.data_ptr() for x in ins),
        J, M, B, tile, W, SW, tele_bins,
        int(aux_i16), children.data_ptr(), caux.data_ptr(), ptr(bounds),
        ptr(sched), n_surv.data_ptr(), ptr(hist), scratch.data_ptr(),
        scratch.numel(), _stream(dev))
    _check(rc, "fused_expand")
    _count("fused_expand")
    return children, caux, bounds, sched, n_surv, hist
