"""Durable fleet flight recorder: the observability STORE.

Reproduces `tpu_tree_search/obs/store.py` (`ObsStore`, `read_store`,
`resume_counters`) byte for byte: the same canonical record line and
CRC, segment names, rotation and retention, so either package reads the
other's store directory.

The engine outlives any single process — the request ledger replays a
kill -9, the failover watcher adopts an orphaned peer's ledger — but
metrics history, health alert lifecycles and trace rings are
process-scoped: they evaporate at exit and zero at boot. This module is
the durability tier under them: an append-only time-series + event
store in the fleet/ledger directory, written with exactly the
``service/ledger.py`` discipline (CRC-stamped JSONL records, fsync'd
batches, segment rotation, corrupt-tail truncation + quarantine) and
replayed at boot so dashboards, health history rings, SLO burn windows
and whitelisted ``tts_*`` counters RESUME instead of restarting from
zero.

Differences from the request ledger, on purpose:

- **Per-writer segment files** (``obs-<writer>-NNNNNNNN.jsonl``): N
  fleet peers share one store directory; each appends only to its own
  segment family (the ledger's quarantine rule), so there is no cross-host
  write contention and no lock. Replay reads EVERY writer's segments
  (merged by wall time) but repairs — truncates/quarantines — only its
  own: a peer's active segment may legitimately end in a torn line
  while that peer is alive.
- **Bounded-queue sink**: observability must never block the scheduler.
  ``append()`` enqueues; a writer thread drains batches and pays one
  flush+fsync per batch. A full queue DROPS the record (counted) —
  the opposite trade from the checkpoint writer, which blocks, because
  a lost metric sample is a shrug and a lost checkpoint is data loss.
- **Time-based retention, not state compaction**: the ledger compacts
  to absolute state; a time-series store has no absolute form, so at
  rotation whole own-writer segments whose newest record is older than
  the retention window are pruned.
- **Wall-clock timestamps**: tracelog records carry monotonic seconds
  (right for intra-process ordering); store records are stamped with
  ``time.time()`` so windows — the SLO burn rates — compose across
  process lifetimes and hosts.

Record schema (``{"k": kind, "t": wall_s, "w": writer, ...}``):

- ``boot``: one per store open (pid) — lifetime delimiter;
- ``sample``: a metrics snapshot — ``counters``/``gauges`` as
  ``[name, labels, value]`` triples (taken on the resource-sampler
  cadence);
- ``event``: a whitelisted tracelog event (alert transitions,
  remediation/failover/portfolio/batch/request lifecycle), flattened.

Stdlib-only: the ``journey`` CLI subcommand and the lint leg load this
module without the accelerator stack.
"""

from __future__ import annotations

import json
import os
import pathlib
import queue
import threading
import time
import zlib

from ..utils import config as cfg

__all__ = ["ObsStore", "read_store", "resume_counters",
           "RESUME_COUNTERS", "EVENT_PREFIXES", "TERMINAL_EVENTS"]

SEGMENT_PREFIX = "obs-"
SEGMENT_SUFFIX = ".jsonl"
QUARANTINE_SUFFIX = ".corrupt"

BATCH_MAX = 256          # records drained per flush+fsync
DRAIN_POLL_S = 0.2       # writer-thread wakeup when the queue is idle

# tracelog event names the sink persists (prefix match): the durable
# subset is the CONTROL-PLANE story — request lifecycle, alerting,
# remediation, failover, racing, batching — not the per-segment
# telemetry firehose (that stays in the ring / TTS_TRACE_FILE tier)
EVENT_PREFIXES = (
    "request.", "alert.", "remediation.", "failover.", "portfolio.",
    "batch.", "server.", "takeover", "ledger.replay", "journey.",
    # lane-state transitions (obs/capacity.py, TTS_CAPACITY): bounded
    # by scheduler transitions, not per-segment — and only emitted at
    # all when the capacity layer is on, so the off-path store content
    # is unchanged
    "lane.",
)

# request terminal-state events (server._finalize) — the SLO burn
# rules' inputs; mapped to the terminal state they witness
TERMINAL_EVENTS = {
    "request.done": "DONE",
    "request.cancelled": "CANCELLED",
    "request.deadline": "DEADLINE",
    "request.failed": "FAILED",
}

# counters re-seeded from the last replayed snapshot so /metrics
# resumes across a restart. A WHITELIST, not "every counter":
# ledger-fed counters (tts_server_restarts_total, tts_ledger_*) are
# already resumed by the ledger's own replay and would double-count,
# the store's own counters describe THIS lifetime's I/O, and
# engine-tier counters live in the process-global registry (seeding
# them into the server registry would expose the name twice).
RESUME_COUNTERS = (
    "tts_requests_submitted_total",
    "tts_requests_total",
    "tts_preemptions_total",
    "tts_redispatches_total",
    "tts_batches_formed_total",
    "tts_batch_requests_total",
    "tts_portfolio_races_total",
    "tts_portfolio_members_total",
    "tts_alerts_fired_total",
    "tts_takeovers_total",
    # lane-state seconds (obs/capacity.py): the utilization history
    # that must survive kill -9 — the LaneLedger re-seeds its per-state
    # accumulators from the replayed series at boot (replayed seconds
    # tracked separately so conservation stays exact per lifetime)
    "tts_lane_seconds_total",
)

# gauges snapshotted into every sample record — the health monitor's
# history-ring signals, so /dashboard sparklines resume after a boot
SAMPLE_GAUGES = (
    "tts_queue_depth",
    "tts_submeshes_busy",
    "tts_device_bytes_in_use",
    "tts_host_rss_bytes",
    # per-shape-class ρ (obs/capacity.py): exists only with the
    # capacity layer on, so off-path samples are unchanged
    "tts_capacity_utilization",
)


def _canonical(rec: dict) -> bytes:
    return json.dumps(rec, sort_keys=True,
                      separators=(",", ":")).encode()


def _line(rec: dict) -> bytes:
    body = _canonical(rec)
    return json.dumps({"c": zlib.crc32(body),
                       "r": rec}, sort_keys=True,
                      separators=(",", ":")).encode() + b"\n"


def _parse_line(raw: bytes) -> dict | None:
    """One wrapped record, or None on any damage (torn/garbled/CRC)."""
    try:
        outer = json.loads(raw.decode())
        rec = outer["r"]
        if not isinstance(rec, dict):
            return None
        if zlib.crc32(_canonical(rec)) != int(outer["c"]):
            return None
        return rec
    except (ValueError, KeyError, TypeError, UnicodeDecodeError):
        return None


def _safe_writer(writer: str) -> str:
    """Writer ids land in file names; keep them path-safe."""
    return "".join(c if (c.isalnum() or c in "._=+") else "_"
                   for c in str(writer)) or "writer"


def _scan_segment(data: bytes):
    """Yield (record_or_None, end_offset_of_good_prefix) pairs the way
    the ledger's replay walks a segment: byte scan, no readline — a
    torn line is detected at its exact offset."""
    pos = good_end = 0
    while pos < len(data):
        nl = data.find(b"\n", pos)
        raw, nxt = ((data[pos:], len(data)) if nl < 0
                    else (data[pos:nl], nl + 1))
        if raw:
            rec = _parse_line(raw)
            if rec is None:
                yield None, good_end
                return
            yield rec, nxt
        pos = good_end = nxt


def read_store(root: str | os.PathLike) -> list[dict]:
    """Read-only merge of every writer's segments in `root`, sorted by
    wall time. Damaged lines (and everything after them within their
    segment) are skipped, never repaired — the reader may not own the
    files it reads. The tools/CLI entry point."""
    root = pathlib.Path(root)
    out: list[dict] = []
    if not root.is_dir():
        return out
    for seg in sorted(root.iterdir()):
        if not (seg.name.startswith(SEGMENT_PREFIX)
                and seg.name.endswith(SEGMENT_SUFFIX)):
            continue
        try:
            data = seg.read_bytes()
        except OSError:
            continue
        for rec, _end in _scan_segment(data):
            if rec is None:
                break
            out.append(rec)
    out.sort(key=lambda r: r.get("t", 0.0))
    return out


def resume_counters(registry, records: list[dict], writer: str) -> int:
    """Re-seed whitelisted counters from the newest replayed snapshot
    this writer authored, so a restarted server's /metrics continues
    the series instead of restarting at zero. Returns the number of
    series seeded. Ledger-fed counters are deliberately absent from
    RESUME_COUNTERS (the ledger replay already feeds them)."""
    from . import metric_names
    last = None
    for rec in records:
        if rec.get("k") == "sample" and rec.get("w") == writer:
            last = rec
    if last is None:
        return 0
    seeded = 0
    for name, labels, value in last.get("counters") or ():
        if name not in RESUME_COUNTERS or not value:
            continue
        meta = metric_names.REGISTRY.get(name)
        doc = meta.doc if meta is not None else name
        try:
            registry.counter(name, doc).inc(
                float(value), **dict(labels or {}))
        except (TypeError, ValueError):
            continue
        seeded += 1
    return seeded


class ObsStore:
    """One process's handle on the shared observability store.

    Constructing it REPLAYS every writer's segments in `root` (same
    contract as the request ledger: read ``records()`` / ``replayed``
    / ``truncated`` before appending), repairs only this writer's
    family, journals a ``boot`` record, and starts the bounded-queue
    writer thread. All appends go through :meth:`append` — enqueue-only,
    never raises, never blocks.
    """

    def __init__(self, root: str | os.PathLike, writer: str,
                 registry=None,
                 segment_records: int = cfg.OBS_STORE_SEGMENT_RECORDS_DEFAULT,
                 retain_s: float = cfg.OBS_STORE_RETAIN_S_DEFAULT,
                 queue_depth: int = cfg.OBS_STORE_QUEUE_DEFAULT,
                 fsync: bool = True):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.writer = _safe_writer(writer)
        self.segment_records = max(2, int(segment_records))
        self.retain_s = float(retain_s)
        self.fsync = fsync
        self._lock = threading.Lock()
        self._fh = None                 # guarded-by: self._lock
        self._seg_index = 0             # guarded-by: self._lock
        self._seg_records = 0           # guarded-by: self._lock
        self._closed = False
        self.records = 0                # appended this lifetime
        self.replayed = 0               # good records replayed at boot
        self.truncated = 0              # corrupt-tail records discarded
        self.quarantined_segments = 0
        self.dropped = 0                # queue-full drops
        self.write_errors = 0
        # terminal-request history (wall_t, state, spent_s, tenant) —
        # the SLO burn rules' window source; seeded by replay, extended
        # live. Bounded: burn windows never exceed the slow window, and
        # retention prunes the disk copy.
        self.terminals: list[tuple] = []
        self._terminal_keep = 65536
        self._replayed_records: list[dict] = []
        self._m_records = self._m_replayed = self._m_truncated = None
        if registry is not None:
            self._m_records = registry.counter(
                "tts_obs_store_records_total",
                "flight-recorder store records appended (batched "
                "fsync'd CRC JSONL)")
            self._m_replayed = registry.counter(
                "tts_obs_store_replayed_total",
                "flight-recorder store records replayed at boot "
                "(all writers)")
            self._m_truncated = registry.counter(
                "tts_obs_store_truncated_total",
                "corrupt-tail store records discarded at replay "
                "(own segments only)")
        self._replay()
        self._q: queue.Queue = queue.Queue(maxsize=max(2, queue_depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._drain_loop, name="obs-store-writer",
            daemon=True)
        self._thread.start()
        self._sampler: threading.Thread | None = None
        self.append("boot", pid=os.getpid())

    # ----------------------------------------------------------- replay

    def _own(self, seg: pathlib.Path) -> bool:
        return seg.name.startswith(
            f"{SEGMENT_PREFIX}{self.writer}-")

    def _segments(self, own_only: bool = False) -> list[pathlib.Path]:
        segs = sorted(p for p in self.root.iterdir()
                      if p.name.startswith(SEGMENT_PREFIX)
                      and p.name.endswith(SEGMENT_SUFFIX))
        if own_only:
            segs = [p for p in segs if self._own(p)]
        return segs

    def _replay(self) -> None:
        corrupt = False
        for seg in self._segments():
            own = self._own(seg)
            if corrupt and own:
                # own segments after the first own corruption are
                # suspect (written after bytes this replay refused):
                # set them aside, exactly the ledger's rule
                self.quarantined_segments += 1
                try:
                    os.replace(seg, str(seg) + QUARANTINE_SUFFIX)
                except OSError:
                    pass
                continue
            try:
                data = seg.read_bytes()
            except OSError:
                continue
            good_end = len(data)
            damaged = False
            for rec, end in _scan_segment(data):
                if rec is None:
                    damaged, good_end = True, end
                    break
                self._note(rec)
                self._replayed_records.append(rec)
                self.replayed += 1
            if not damaged:
                continue
            if not own:
                continue      # a live peer's torn tail is not ours to cut
            corrupt = True
            bad = [ln for ln in data[good_end:].split(b"\n") if ln]
            self.truncated += len(bad)
            try:
                with open(seg, "r+b") as f:
                    f.truncate(good_end)
                    f.flush()
                    os.fsync(f.fileno())
            except OSError:
                pass
        if self._m_replayed is not None and self.replayed:
            self._m_replayed.inc(self.replayed)
        if self._m_truncated is not None and self.truncated:
            self._m_truncated.inc(self.truncated)
        own = self._segments(own_only=True)
        if own:
            last = own[-1]
            # replay runs before the writer thread exists, but these
            # fields are declared lock-guarded: keep the discipline
            with self._lock:
                self._seg_index = int(
                    last.name[:-len(SEGMENT_SUFFIX)].rsplit("-", 1)[-1])
                try:
                    self._seg_records = sum(
                        1 for ln in last.read_bytes().split(b"\n")
                        if ln)
                except OSError:
                    self._seg_records = 0
        self._replayed_records.sort(key=lambda r: r.get("t", 0.0))
        self.terminals.sort(key=lambda row: row[0])

    def records_replayed(self) -> list[dict]:
        """The boot replay's merged record list (all writers, sorted by
        wall time) — the dashboard/health/counter resume feed."""
        return list(self._replayed_records)

    def _note(self, rec: dict) -> None:
        """Fold one record into the in-memory indexes (replay + live)."""
        state = TERMINAL_EVENTS.get(rec.get("name", ""))
        if rec.get("k") == "event" and state is not None:
            self.terminals.append(
                (float(rec.get("t", 0.0)), state,
                 float(rec.get("spent_s") or 0.0),
                 rec.get("tenant") or "-"))
            del self.terminals[:-self._terminal_keep]

    def terminal_history(self, since_s: float | None = None) -> list:
        """(wall_t, state, spent_s, tenant) rows, oldest first —
        optionally only those newer than `since_s` (wall clock)."""
        with self._lock:
            rows = list(self.terminals)
        if since_s is not None:
            rows = [r for r in rows if r[0] >= since_s]
        return rows

    # ----------------------------------------------------------- append

    def append(self, kind: str, **fields) -> None:
        """Enqueue one record for the writer thread. Never raises and
        never blocks: a full queue drops the record (counted) — the
        flight recorder must not become back-pressure on the
        scheduler."""
        if self._closed:
            return
        rec = {"k": kind, "t": time.time(), "w": self.writer, **fields}
        with self._lock:
            self._note(rec)
        try:
            self._q.put_nowait(rec)
        except queue.Full:
            self.dropped += 1

    def on_trace_event(self, rec: dict) -> None:
        """TraceLog listener: persist the control-plane event subset.
        Tracelog timestamps are monotonic; the store re-stamps with
        wall clock at enqueue (cross-lifetime windows need it)."""
        if rec.get("kind") != "event":
            return
        name = rec.get("name", "")
        if not name.startswith(EVENT_PREFIXES):
            return
        fields = {k: v for k, v in rec.items()
                  if k not in ("kind", "ts", "seq", "thread")
                  and _jsonable(v)}
        self.append("event", **fields)

    # ------------------------------------------------------------- sink

    def _seg_path(self, index: int) -> pathlib.Path:
        return self.root / (f"{SEGMENT_PREFIX}{self.writer}-"
                            f"{index:08d}{SEGMENT_SUFFIX}")

    def _drain_loop(self) -> None:
        while True:
            try:
                rec = self._q.get(timeout=DRAIN_POLL_S)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            batch = [rec]
            while len(batch) < BATCH_MAX:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            self._write_batch(batch)
            if self._stop.is_set() and self._q.empty():
                return

    def _write_batch(self, batch: list[dict]) -> None:
        """One flush+fsync per batch; errors degrade durability loudly
        (write_errors) but never propagate — the ledger's stance."""
        with self._lock:
            try:
                if self._fh is None:
                    if self._seg_index == 0:
                        self._seg_index = 1
                    self._fh = open(self._seg_path(self._seg_index),
                                    "ab")
                self._fh.write(b"".join(_line(r) for r in batch))
                self._fh.flush()
                if self.fsync:
                    os.fsync(self._fh.fileno())
            except OSError:
                self.write_errors += len(batch)
                return
            self._seg_records += len(batch)
            self.records += len(batch)
            if self._seg_records >= self.segment_records:
                self._rotate_locked()
        if self._m_records is not None:
            self._m_records.inc(len(batch))

    def _rotate_locked(self) -> None:   # holds: self._lock
        try:
            self._fh.close()
        except OSError:
            pass
        self._fh = None
        self._seg_index += 1
        self._seg_records = 0
        # time-based retention: prune OWN closed segments whose newest
        # write is past the window (mtime — the last append's time)
        if self.retain_s <= 0:
            return
        horizon = time.time() - self.retain_s
        for seg in self._segments(own_only=True)[:-1]:
            try:
                if seg.stat().st_mtime < horizon:
                    seg.unlink()
            except OSError:
                pass

    # -------------------------------------------------------- sampling

    def start_sampling(self, sample_fn, interval_s: float) -> None:
        """Snapshot `sample_fn()` (a dict of sample-record fields) every
        `interval_s` seconds on a daemon thread — the resource-sampler
        cadence. One immediate sample is taken up front."""
        if interval_s <= 0 or self._sampler is not None:
            return
        self.sample_now(sample_fn)

        def loop():
            while not self._stop.wait(interval_s):
                self.sample_now(sample_fn)

        self._sampler = threading.Thread(
            target=loop, name="obs-store-sampler", daemon=True)
        self._sampler.start()

    def sample_now(self, sample_fn) -> None:
        try:
            fields = sample_fn() or {}
        except Exception:
            return
        self.append("sample", **fields)

    # ----------------------------------------------------------- close

    def flush(self, timeout_s: float = 5.0) -> None:
        """Best-effort wait for the queue to drain (tests, drain path)."""
        deadline = time.monotonic() + timeout_s
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.01)

    def snapshot(self) -> dict:
        return {
            "dir": str(self.root), "writer": self.writer,
            "records": self.records, "replayed": self.replayed,
            "truncated": self.truncated,
            "quarantined_segments": self.quarantined_segments,
            "dropped": self.dropped, "write_errors": self.write_errors,
            "segment_index": self._seg_index,
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._thread.join(timeout=5.0)
        if self._sampler is not None:
            self._sampler.join(timeout=1.0)
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                    if self.fsync:
                        os.fsync(self._fh.fileno())
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def _jsonable(v) -> bool:
    if v is None or isinstance(v, (bool, int, float, str)):
        return True
    if isinstance(v, (list, tuple)):
        return all(_jsonable(x) for x in v)
    if isinstance(v, dict):
        return all(isinstance(k, str) and _jsonable(x)
                   for k, x in v.items())
    return False
