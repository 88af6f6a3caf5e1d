"""ctypes binding to the native host runtime (libtreesearch_host).

Reproduces `tpu_tree_search/native/__init__.py`: `build`, `lib`,
`processing_times`, `optimal_makespan`, `search`, `search_from`,
`bfs_frontier`, the `async_*` session calls and `nqueens`, over
`src/treesearch_host.cpp`, a byte copy of the JAX package's source (the
Taillard generator, the sequential DFS oracle, the breadth-first warm-up
that seeds the multi-worker search, a multi-threaded DFS from a seed
set, and N-Queens backtracking), compiled with the system `g++`.

The library is built at first use into `tpu_tree_search_torch/_build/`
(not beside its source), under a name that carries a hash of the
source, the flags and the host's platform string, so a checkout copied
to another machine builds its own. Every C function has its `argtypes`
and `restype` declared.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import threading

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "src" / "treesearch_host.cpp"
BUILD_DIR = _DIR.parent / "_build"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_c_int_p = ctypes.POINTER(ctypes.c_int)
_c_i16_p = ctypes.POINTER(ctypes.c_int16)
_c_u64_p = ctypes.POINTER(ctypes.c_ulonglong)
_ll = ctypes.c_longlong
_i = ctypes.c_int

# every exported symbol: (argtypes, restype)
_SIGNATURES = {
    "tts_nb_jobs": ([_i], _i),
    "tts_nb_machines": ([_i], _i),
    "tts_optimal_makespan": ([_i], _i),
    "tts_processing_times": ([_i, _c_int_p], None),
    "tts_search": ([_c_int_p, _i, _i, _i, _i, _ll, _c_u64_p, _c_u64_p,
                    _c_int_p], _ll),
    "tts_bfs_frontier": ([_c_int_p, _i, _i, _i, _i, _ll, _ll, _c_i16_p,
                          _c_i16_p, _c_u64_p, _c_u64_p, _c_int_p], _ll),
    "tts_search_from": ([_c_int_p, _i, _i, _i, _i, _c_i16_p, _c_i16_p, _ll,
                         _i, _c_u64_p, _c_u64_p, _c_int_p], _ll),
    "tts_async_start": ([_c_int_p, _i, _i, _i, _i, _c_i16_p, _c_i16_p, _ll,
                         _i], ctypes.c_void_p),
    "tts_async_best": ([ctypes.c_void_p], _i),
    "tts_async_offer": ([ctypes.c_void_p, _i], None),
    "tts_async_done": ([ctypes.c_void_p], _i),
    "tts_async_join": ([ctypes.c_void_p, _c_u64_p, _c_u64_p, _c_int_p], _ll),
    "tts_nqueens": ([_i, _i, _c_u64_p, _c_u64_p], _ll),
}

_lock = threading.Lock()
_lib = None


def library_path() -> pathlib.Path:
    """The library's path in `_build/`, named by a hash of the source, the
    compiler flags and the host's platform string."""
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(FLAGS).encode()
                         + platform.platform().encode()).hexdigest()
    return BUILD_DIR / f"libtreesearch_host-{tag[:12]}.so"


def build(force: bool = False) -> pathlib.Path:
    """Compile the library with `g++` unless it is built already; raises
    with the compiler's output on a failed build."""
    out = library_path()
    if out.exists() and not force:
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native host runtime is "
                           "built from source at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for sym, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, sym)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = handle
        return _lib


def _table(p_times: np.ndarray) -> tuple[np.ndarray, int, int]:
    p = np.ascontiguousarray(p_times, dtype=np.int32)
    if p.ndim != 2:
        raise ValueError(f"p_times must be (machines, jobs), got {p.shape}")
    return p, p.shape[1], p.shape[0]


def _seeds(prmu: np.ndarray, depth: np.ndarray, jobs: int):
    prmu = np.ascontiguousarray(prmu, dtype=np.int16).reshape(-1, jobs)
    depth = np.ascontiguousarray(depth, dtype=np.int16).reshape(-1)
    if len(depth) != prmu.shape[0]:
        raise ValueError(f"{prmu.shape[0]} seed rows but {len(depth)} "
                         "depths")
    return prmu, depth


def _threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else max(1, (os.cpu_count() or 2) - 1)


def _ub(init_ub: int | None) -> int:
    return 0 if init_ub is None else int(init_ub)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def processing_times(inst: int) -> np.ndarray:
    """Taillard instance `inst`'s (machines, jobs) int32 table."""
    h = lib()
    out = np.zeros((h.tts_nb_machines(inst), h.tts_nb_jobs(inst)), np.int32)
    h.tts_processing_times(inst, _ptr(out, ctypes.c_int))
    return out


def optimal_makespan(inst: int) -> int:
    return int(lib().tts_optimal_makespan(inst))


def search(p_times: np.ndarray, lb_kind: int = 1, init_ub: int | None = None,
           max_nodes: int = 0):
    """Sequential DFS oracle. Returns (tree, sol, best, expanded)."""
    p, n, m = _table(p_times)
    tree, sol, best = ctypes.c_ulonglong(), ctypes.c_ulonglong(), _i()
    expanded = lib().tts_search(
        _ptr(p, ctypes.c_int), n, m, lb_kind, _ub(init_ub), max_nodes,
        ctypes.byref(tree), ctypes.byref(sol), ctypes.byref(best))
    return int(tree.value), int(sol.value), int(best.value), int(expanded)


def search_from(p_times: np.ndarray, prmu: np.ndarray, depth: np.ndarray,
                lb_kind: int = 1, init_ub: int | None = None,
                n_threads: int = 0):
    """Multi-threaded DFS from a seed set. Returns (tree, sol, best,
    expanded)."""
    p, n, m = _table(p_times)
    prmu, depth = _seeds(prmu, depth, n)
    tree, sol, best = ctypes.c_ulonglong(), ctypes.c_ulonglong(), _i()
    expanded = lib().tts_search_from(
        _ptr(p, ctypes.c_int), n, m, lb_kind, _ub(init_ub),
        _ptr(prmu, ctypes.c_int16), _ptr(depth, ctypes.c_int16),
        prmu.shape[0], _threads(n_threads), ctypes.byref(tree),
        ctypes.byref(sol), ctypes.byref(best))
    return int(tree.value), int(sol.value), int(best.value), int(expanded)


def bfs_frontier(p_times: np.ndarray, lb_kind: int, init_ub: int | None,
                 target: int, cap: int = 1 << 22):
    """Breadth-first warm-up until the frontier holds >= `target` nodes (or
    the tree is exhausted). Returns (prmu (n, jobs) int16, depth (n,)
    int16, tree, sol, best)."""
    p, n, m = _table(p_times)
    prmu = np.zeros((cap, n), np.int16)
    depth = np.zeros(cap, np.int16)
    tree, sol, best = ctypes.c_ulonglong(), ctypes.c_ulonglong(), _i()
    got = lib().tts_bfs_frontier(
        _ptr(p, ctypes.c_int), n, m, lb_kind, _ub(init_ub), target, cap,
        _ptr(prmu, ctypes.c_int16), _ptr(depth, ctypes.c_int16),
        ctypes.byref(tree), ctypes.byref(sol), ctypes.byref(best))
    if got < 0:
        raise RuntimeError(f"warm-up frontier exceeded {cap} rows")
    return (prmu[:got].copy(), depth[:got].copy(), int(tree.value),
            int(sol.value), int(best.value))


def async_start(p_times: np.ndarray, prmu: np.ndarray, depth: np.ndarray,
                lb_kind: int = 1, init_ub: int | None = None,
                n_threads: int = 0):
    """Start a background multi-threaded DFS over a seed set and return its
    session handle; incumbents merge through `async_best`/`async_offer`.
    The native side copies every input before it returns."""
    p, n, m = _table(p_times)
    prmu, depth = _seeds(prmu, depth, n)
    return lib().tts_async_start(
        _ptr(p, ctypes.c_int), n, m, lb_kind, _ub(init_ub),
        _ptr(prmu, ctypes.c_int16), _ptr(depth, ctypes.c_int16),
        prmu.shape[0], _threads(n_threads))


def async_best(handle) -> int:
    """The session's shared incumbent."""
    return int(lib().tts_async_best(handle))


def async_offer(handle, best: int) -> None:
    """Merge an incumbent found elsewhere into the session (CAS min)."""
    lib().tts_async_offer(handle, int(best))


def async_done(handle) -> bool:
    """True when every session thread has drained its pool."""
    return bool(lib().tts_async_done(handle))


def async_join(handle):
    """Join the session and free it. Returns (tree, sol, best,
    expanded)."""
    tree, sol, best = ctypes.c_ulonglong(), ctypes.c_ulonglong(), _i()
    expanded = lib().tts_async_join(handle, ctypes.byref(tree),
                                    ctypes.byref(sol), ctypes.byref(best))
    return int(tree.value), int(sol.value), int(best.value), int(expanded)


def nqueens(n: int, g: int = 1):
    """N-Queens backtracking. Returns (tree, sol, expanded)."""
    tree, sol = ctypes.c_ulonglong(), ctypes.c_ulonglong()
    expanded = lib().tts_nqueens(n, g, ctypes.byref(tree), ctypes.byref(sol))
    return int(tree.value), int(sol.value), int(expanded)
