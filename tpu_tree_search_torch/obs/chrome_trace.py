"""Chrome ``trace_event`` JSON: the flight recorder's timeline export and
the parsing of the traces ``torch.profiler`` writes.

Reproduces `tpu_tree_search/obs/chrome_trace.py`. Two halves, one file
format:

- **Export** (:func:`to_chrome`, :func:`write_chrome`, :func:`read_jsonl`),
  copied as it is: the flight recorder's span and event records
  (obs/tracelog) become a Chrome trace, so a whole serve session
  (dispatches, preemptions, checkpoint I/O) opens as a timeline in
  Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``. One lane per
  submesh (the executor threads' records carry a ``submesh`` attribute),
  one per remaining thread, counter lanes for the search telemetry and the
  memory sampler, retrospective lane-state slices and one lifeline lane
  per request. Given the same records it gives JAX's document.

- **Import** (:func:`load_profile_trace`, :func:`self_times`): JAX's
  ``load_xla_trace`` read what ``jax.profiler`` wrote; the port's profiler
  is ``torch.profiler``, whose ``export_chrome_trace`` writes the same
  Chrome format. ``obs/profiler`` stores it in JAX's artifact layout,
  ``<capture>/plugins/profile/<run>/<host>.trace.json.gz``, so the tools
  that glob JAX's layout read the port's too. :func:`self_times` reads
  the card's lane: the events whose ``cat`` is ``kernel``, ``gpu_memcpy``
  or ``gpu_memset``, as JAX's reads its ``"XLA Ops"`` lane, each charged
  its own duration (kernels never contain one another, but a replayed
  graph's branches overlap in one stream's lane); on a trace with no
  device activity it reads the CPU op events (``cpu_op``, one lane per
  thread) with JAX's nesting algorithm (a duration minus its directly
  contained children's), as JAX's falls back to the CPU backend's
  executor lanes. :func:`bucketed_self_times` folds the ops into JAX's phase
  buckets, by substrings of the port's kernel names and of PyTorch's own.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import pathlib

__all__ = ["to_chrome", "write_chrome", "read_jsonl",
           "load_profile_trace", "self_times", "bucket_of",
           "bucketed_self_times", "SELF_TIME_BUCKETS", "DEVICE_CATS"]


# ------------------------------------------------------------------ export

def _track_of(rec: dict) -> str:
    """The timeline lane for a record: submesh-grouped when the record
    carries one (the per-submesh view of the flight recorder: which
    request ran WHERE), else the emitting thread."""
    if "submesh" in rec and rec["submesh"] is not None:
        return f"submesh-{rec['submesh']}"
    return str(rec.get("thread", "main"))


# per-segment search-telemetry events (engine/checkpoint.run_segmented)
# additionally render as Perfetto COUNTER tracks — one lane per counter
# per submesh, next to the span lanes: the pruning-rate / frontier-depth
# / pool-fill time series the compiled loop was a black box for
COUNTER_EVENT = "search.telemetry"
COUNTER_KEYS = ("pruning_rate", "frontier_depth", "pool",
                "steal_sent", "steal_recv")

# resource-sampler sweeps (obs/resource) render as memory COUNTER lanes
# beside the search counters: host RSS plus one in-use/peak pair per
# device, so an HBM ramp lines up with the pool growth that caused it
RESOURCE_EVENT = "resource.sample"

# lane-state transitions (obs/capacity.LaneLedger) render as
# RETROSPECTIVE state slices on a dedicated per-lane track: the event
# fires when a state is LEFT and carries the full duration just spent
# in it, so the slice is drawn backwards from the transition timestamp
LANE_STATE_EVENT = "lane.state"


def _lane_state_slice(rec: dict) -> dict | None:
    """The ``X`` slice a ``lane.state`` transition contributes to its
    ``lane-<submesh>-state`` track: name = the state being left,
    spanning [ts − seconds, ts]. Zero-duration flickers are kept (dur
    0) — Perfetto renders them as ticks, and dropping them would hide
    real scheduler churn."""
    if rec.get("name") != LANE_STATE_EVENT or rec.get("submesh") is None:
        return None
    try:
        dur = max(float(rec.get("seconds", 0.0)), 0.0)
        ts = float(rec.get("ts", 0.0))
    except (TypeError, ValueError):
        return None
    return {"name": str(rec.get("prev", "?")),
            "ts": round((ts - dur) * 1e6, 3),
            "dur": round(dur * 1e6, 3),
            "track": f"lane-{rec['submesh']}-state"}


def _lifeline_of(rec: dict) -> str | None:
    """The per-request LIFELINE lane a record also lands on: every
    ``request.*`` lifecycle event repeats as an instant on one
    ``request-<tag or id>`` track, so a single request's whole story —
    admit, dispatches, preemptions, adoption, terminal — reads as one
    horizontal line instead of being scattered across the submesh lanes
    it actually ran on. Keyed by tag when the record carries one (the
    tag is the identity that SURVIVES a failover re-admission under a
    fresh rid, so both lifetimes land on the same lane)."""
    name = str(rec.get("name", ""))
    if not name.startswith("request."):
        return None
    ident = rec.get("tag") or rec.get("request_id")
    if ident is None:
        return None
    return f"request-{ident}"


def _counter_samples(rec: dict) -> list[tuple[str, float]]:
    """(counter_name, value) pairs a record contributes to Perfetto
    counter tracks; empty for non-counter events."""
    name = rec.get("name")
    if name == COUNTER_EVENT:
        return [(k, rec[k]) for k in COUNTER_KEYS if k in rec]
    if name == RESOURCE_EVENT:
        out = []
        if rec.get("host_rss_bytes") is not None:
            out.append(("host_rss_bytes", rec["host_rss_bytes"]))
        for d in rec.get("devices") or ():
            if not isinstance(d, dict) or d.get("bytes_in_use") is None:
                continue
            out.append((f"device{d.get('id', '?')} bytes_in_use",
                        d["bytes_in_use"]))
            if d.get("peak_bytes_in_use") is not None:
                out.append((f"device{d.get('id', '?')} bytes_peak",
                            d["peak_bytes_in_use"]))
        return out
    return []


def to_chrome(records: list[dict]) -> dict:
    """Convert tracelog records (ring snapshot or JSONL lines) to a
    Chrome trace dict: spans -> complete ``X`` events, point events ->
    instant ``i`` events, plus thread-name metadata so the lanes are
    labeled. Timestamps are the records' monotonic seconds as µs.
    ``search.telemetry`` events additionally emit ``C`` counter samples
    (COUNTER_KEYS), so Perfetto draws per-submesh counter tracks; the
    instant event is kept too — its args carry the full per-segment
    record for tools/search_report.py's Chrome-format path.
    ``request.*`` lifecycle events additionally repeat on a
    per-request LIFELINE lane (see :func:`_lifeline_of`)."""
    tids: dict[str, int] = {}
    events = []
    for rec in records:
        if rec.get("kind") == "meta":
            continue
        track = _track_of(rec)
        tid = tids.setdefault(track, len(tids))
        args = {k: v for k, v in rec.items()
                if k not in ("kind", "name", "ts", "dur", "pid",
                             "thread", "seq")}
        base = {"name": rec.get("name", "?"), "pid": 0, "tid": tid,
                "ts": round(float(rec.get("ts", 0.0)) * 1e6, 3),
                "args": args}
        if rec.get("kind") == "span":
            events.append({**base, "ph": "X",
                           "dur": round(float(rec.get("dur", 0.0)) * 1e6,
                                        3)})
        else:
            events.append({**base, "ph": "i", "s": "t"})
            for key, val in _counter_samples(rec):
                events.append({
                    "ph": "C", "pid": 0, "tid": tid,
                    "name": f"{key} ({track})",
                    "ts": base["ts"],
                    "args": {key.split(" ")[-1]: val}})
            lifeline = _lifeline_of(rec)
            if lifeline is not None and lifeline != track:
                lf_tid = tids.setdefault(lifeline, len(tids))
                events.append({**base, "tid": lf_tid,
                               "ph": "i", "s": "t"})
            sl = _lane_state_slice(rec)
            if sl is not None:
                st_tid = tids.setdefault(sl["track"], len(tids))
                events.append({"name": sl["name"], "ph": "X",
                               "pid": 0, "tid": st_tid,
                               "ts": sl["ts"], "dur": sl["dur"],
                               "args": {"state": sl["name"]}})
    meta = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
             "args": {"name": track}} for track, tid in tids.items()]
    # sorted lanes first, then events in timestamp order: Perfetto does
    # not require it, but a human reading the raw JSON does
    events.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome(path: str | os.PathLike,
                 records: list[dict] | None = None) -> str:
    """Write a Chrome trace JSON of `records` (default: the global
    recorder's ring buffer). Returns the path written."""
    if records is None:
        from . import tracelog
        records = tracelog.get().records()
    path = pathlib.Path(path)
    if path.parent != pathlib.Path(""):
        path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(to_chrome(records)))
    return str(path)


def read_jsonl(path: str | os.PathLike) -> list[dict]:
    """Read a tracelog JSONL sink back into records (meta lines and the
    occasional torn final line from a killed process are skipped)."""
    out = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            try:
                rec = json.loads(ln)
            except json.JSONDecodeError:
                continue                  # torn tail write
            if rec.get("kind") != "meta":
                out.append(rec)
    return out


# ------------------------------------------------------------------ import

def load_profile_trace(log_dir: str | os.PathLike) -> list[dict]:
    """Load every trace event of a capture directory (the gzipped Chrome
    JSON under ``plugins/profile/<run>/``, as obs/profiler writes it)."""
    paths = glob.glob(os.path.join(
        os.fspath(log_dir), "plugins", "profile", "*",
        "*.trace.json.gz"))
    ev = []
    for p in sorted(paths):
        with gzip.open(p, "rt") as f:
            ev.extend(json.load(f).get("traceEvents", []))
    return ev


# the categories of the card's activity in a torch.profiler trace: kernels
# (those replayed from a CUDA graph included), copies and fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CPU_CAT = "cpu_op"


def self_times(events: list[dict], lane: str | None = None):
    """Per-op SELF time (µs) and counts from Chrome trace events.

    CPU ops nest by timestamp containment within one (pid, tid) lane (an
    op spans the ops it calls); summing raw durations would count a child
    twice, so each is charged its duration minus its directly contained
    children's, lane by lane: JAX's algorithm. A kernel, a copy or a fill
    on the card contains nothing, yet its record can overlap another's in
    one stream's lane (the parallel branches of a replayed CUDA graph are
    reported on the stream it was launched into, and a programmatic
    dependent launch starts before its predecessor ends), so on the
    device lane each is charged its own duration; nesting them would
    charge an overlapped kernel's time against its neighbour.

    `lane` is ``"device"`` (the events whose ``cat`` is in DEVICE_CATS),
    ``"cpu"`` (the ``cpu_op`` events) or None: the device lane when the
    trace has any device event, else the CPU one, so the same call
    attributes a capture on the card and one on the CPU.
    """
    if lane is None:
        lane = ("device" if any(e.get("cat") in DEVICE_CATS
                                for e in events) else "cpu")
    cats = DEVICE_CATS if lane == "device" else (CPU_CAT,)
    lanes = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and "dur" in e and e.get("cat") in cats:
            lanes[(e.get("pid"), e.get("tid"))].append(e)
    self_us = collections.Counter()
    counts = collections.Counter()
    for xs in lanes.values():
        # sort by start asc, duration desc so parents precede children
        xs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []  # (end_ts, name) of open enclosing events
        for e in xs:
            ts, dur, name = e["ts"], e["dur"], e["name"]
            self_us[name] += dur
            counts[name] += 1
            if lane == "device":
                continue
            while stack and stack[-1][0] <= ts:
                stack.pop()
            if stack:
                self_us[stack[-1][1]] -= dur
            stack.append((ts + dur, name))
    return self_us, counts


# the search step's phase buckets (JAX's names), matched against the
# lowercased op names, first match wins. The port's kernels, as the card
# names them (`void (anonymous namespace)::lb2_sweep_kernel<1, 4>(...)`):
# csrc/lb2_sweep.cu `lb2_sweep_kernel`; csrc/expand_bound.cu `expand_prep`,
# `expand_main`; csrc/fused_expand.cu `fused_prep`, `fused_main`. Then
# PyTorch's own kernels and CPU ops: advanced indexing
# (`gpu_index_kernel<index_kernel_impl<...>>`, `aten::index`), `gather`
# (`_cuda_scatter_gather_internal_kernel<false, ...>`) and `index_select`
# are gathers; `index_copy_` (`index_copy_kernel_impl`), `index_put_` and
# `scatter` (`..._internal_kernel<true, ...>`) write rows; `copy_`
# (`direct_copy_kernel_cuda`), `cat` (`CatArrayBatchedCopy`), pads and the
# card's memcpy and memset records copy. scatter_write is matched before
# gather, so that `aten::index_copy_` is not read as `aten::index`
SELF_TIME_BUCKETS = (
    ("lb2_pair_sweep", ("lb2_sweep",)),
    ("expand_kernel", ("expand_prep", "expand_main", "fused_prep",
                       "fused_main")),
    ("sort", ("sort",)),
    ("scatter_write", ("index_copy", "index_put", "aten::scatter",
                       "scatter_gather_internal_kernel<true")),
    ("gather", ("index_kernel_impl", "aten::index", "gather",
                "index_select", "indexselect", "take")),
    ("copy_concat_pad", ("copy", "catarray", "aten::cat", "concat", "pad",
                         "memcpy", "memset")),
)


def bucket_of(name: str) -> str:
    low = str(name).lower()
    for bucket, subs in SELF_TIME_BUCKETS:
        if any(s in low for s in subs):
            return bucket
    return "other"


def bucketed_self_times(self_us) -> "collections.Counter":
    """Fold a per-op self-time Counter into the step's phase buckets."""
    out = collections.Counter()
    for name, d in self_us.items():
        out[bucket_of(name)] += d
    return out
