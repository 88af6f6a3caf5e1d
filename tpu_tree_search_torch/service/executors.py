"""The executor cache of the search server, with its cost ledger.

Reproduces `tpu_tree_search/service/executors.py` (`ExecutorCache`:
`get_or_build`, `hits`, `misses`, `compiles`, `planned_compiles`,
`storm_signal`, `snapshot`, `ledger_snapshot` and the
`tts_executor_cache_*` and `tts_compile_seconds` series) on the port's
loops.

JAX caches the compiled search loop, keyed by what its trace specializes
on (problem, jobs, the table's leading dimension, lb, chunk, aux dtype, the
fused suffix, the submesh's devices, the capacity and the balance knobs),
never by the instance: the tables are runtime arguments, so every instance
of a class at one bound on one submesh shares one compile. Here the cached
object under the same key is an `engine/distributed._Loop` (under
megabatching, one over every member's tables): the macro-iteration over
tables of its own and, on a card, the CUDA graph captured over pools of
its own. A request that hits the cache copies its tables and pools into
the loop's in place and replays that graph: serve many, capture once. The
hit and miss counters ride the server's status snapshot.

Unlike an XLA executable, a graph holds device memory, and so do the pools
it was captured over. The cache keeps every key's loop, but at most
`engine/device._GRAPH_CACHE` loops that no search holds keep their graphs
and pools on the card (`device.keep_resident`, least recently used first
to go); a hit on a loop that let them go captures again, and the ledger
counts that capture under its key.

The ledger records one entry a key: `build_s` (building the loop),
`compile_s` (the capture's seconds, the first-use `nvcc` build left out;
0.0 where the loop runs eagerly, on the CPU), `nvcc_s` (the kernel
libraries built at that capture, when any was), `captures` (graphs
captured under the key, one a telemetry width), `method` ("capture" on a
card, "eager" on the CPU) and `source` ("capture"). A capture has no
counterpart of XLA's `cost_analysis` or `memory_analysis`: `flops`,
`bytes_accessed` and `temp_bytes` stay None, and `trace_s` and
`deserialize_s` stay as JAX has them with nothing traced or loaded (0.0
and None). The disk tier (`aot_cache`) is ROADMAP A9d.
"""

from __future__ import annotations

import threading
import time

from ..obs import tracelog


class _Entry:
    """One cached loop (`fn`, what the engine built for the key) and its
    cost record, booked by the engine at the loop's first use (`book`) or
    by a pre-warm (`warm`)."""

    __slots__ = ("fn", "record", "_lock", "_measured", "_on_measured",
                 "_via")

    def __init__(self, fn, record: dict, on_measured):
        self.fn = fn
        self.record = record
        self._lock = threading.RLock()
        self._measured = False       # guarded-by: self._lock
        self._on_measured = on_measured
        self._via = None             # guarded-by: self._lock

    def book(self, seconds: float, method: str,
             nvcc_s: float | None = None) -> None:
        """The loop's first use: its capture seconds (`method` "capture")
        or an eager start ("eager", nothing captured). Every capture
        counts in `captures`; the first use alone is the compile the
        record, the histogram and the storm signal see."""
        with self._lock:
            rec = self.record
            if method == "capture":
                rec["captures"] += 1
            if self._measured:
                return
            rec.update(trace_s=0.0, compile_s=round(seconds, 6),
                       method=method, source="capture",
                       nvcc_s=round(nvcc_s, 6) if nvcc_s else None)
            if self._via:
                rec["via"] = self._via
            self._measured = True
        tracelog.event("executor.compile", key=rec["key"],
                       trace_s=rec["trace_s"], compile_s=rec["compile_s"],
                       method=rec["method"], source=rec["source"],
                       deserialize_s=rec["deserialize_s"],
                       flops=rec["flops"])
        self._on_measured(rec)

    def warm(self, ready, via: str = "prewarm") -> str:
        """Ready the loop without a search (the boot pre-warm hook):
        `ready()` captures its graph (or books it eager). Returns "warm"
        when it was ready already, else "compile". `via` labels the record
        ("prewarm", "ladder"): a planned capture, which the compile_storm
        signal leaves out."""
        with self._lock:
            if self._measured:
                return "warm"
            self._via = via
            try:
                ready()
            finally:
                self._via = None
            return "compile"


class ExecutorCache:
    """Thread-safe get-or-build cache of the engine's loops.

    `get_or_build(key, build)` is the whole interface
    (`engine/distributed._DistDriver` and `megabatch.BatchedDriver`
    consult it when a `loop_cache` is given): an entry with the built loop
    as `fn`. Builds run under the lock, so two requests racing for one key
    build it once. `compiles` counts the entries' first uses and
    `planned_compiles` those a pre-warm made; `storm_signal` is their
    difference, the compile_storm rule's input (`obs/health`)."""

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        self._fns: dict[tuple, _Entry] = {}   # guarded-by: self._lock
        self.hits = 0                # guarded-by: self._lock
        self.misses = 0              # guarded-by: self._lock
        self.compiles = 0            # guarded-by: self._lock
        self.planned_compiles = 0    # guarded-by: self._lock
        # the metrics mirror (obs/metrics.Registry): the server passes its
        # registry so /metrics shows the counts the snapshot reports
        self._hits_c = self._misses_c = self._entries_g = None
        self._compile_h = None
        if registry is not None:
            self._hits_c = registry.counter(
                "tts_executor_cache_hits_total",
                "requests served from an already-compiled loop")
            self._misses_c = registry.counter(
                "tts_executor_cache_misses_total",
                "compiled-loop builds (traces/compiles paid)")
            self._entries_g = registry.gauge(
                "tts_executor_cache_entries",
                "distinct compiled loops held")
            self._entries_g.set_fn(lambda: len(self))
            self._compile_h = registry.histogram(
                "tts_compile_seconds",
                "trace+compile wall seconds per new executable")

    def _measured(self, record: dict) -> None:
        with self._lock:
            self.compiles += 1
            if record.get("via"):
                self.planned_compiles += 1
        if self._compile_h is not None:
            self._compile_h.observe(record["trace_s"] + record["compile_s"])

    def storm_signal(self) -> int:
        """Fresh unplanned compiles so far (pre-warm captures left out)."""
        with self._lock:
            return self.compiles - self.planned_compiles

    def get_or_build(self, key: tuple, build) -> _Entry:
        with self._lock:
            entry = self._fns.get(key)
            if entry is not None:
                self.hits += 1
                if self._hits_c is not None:
                    self._hits_c.inc()
                return entry
            self.misses += 1
            if self._misses_c is not None:
                self._misses_c.inc()
            t0 = time.perf_counter()
            fn = build()
            record = {
                "key": _key_repr(key),
                "build_s": round(time.perf_counter() - t0, 6),
                "trace_s": None, "compile_s": None, "method": None,
                "source": None, "deserialize_s": None,
                "flops": None, "bytes_accessed": None, "temp_bytes": None,
                "nvcc_s": None, "captures": 0,
                "created_unix": time.time(),
            }
            entry = self._fns[key] = _Entry(fn, record, self._measured)
            return entry

    def __len__(self) -> int:
        with self._lock:
            return len(self._fns)

    def snapshot(self) -> dict:
        """JSON-safe counts for the status API (JAX's schema)."""
        with self._lock:
            return {"entries": len(self._fns), "hits": self.hits,
                    "misses": self.misses}

    def ledger_snapshot(self) -> list[dict]:
        """Per-entry cost records, oldest first; `compile_s` is None until
        the entry's first use."""
        with self._lock:
            entries = list(self._fns.values())
        return sorted((dict(e.record) for e in entries),
                      key=lambda r: r["created_unix"])


def _key_repr(key: tuple) -> str:
    """A stable readable form of a cache key (JAX's: "/"-joined)."""
    return "/".join(str(k) for k in key)
