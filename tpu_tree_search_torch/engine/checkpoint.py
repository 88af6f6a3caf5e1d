"""Checkpoint / resume for long searches, on one device or many workers.

Reproduces the sync durability layer of
`tpu_tree_search/engine/checkpoint.py`:

- `save`/`load`: snapshots of the live pool rows and every counter in the
  JAX package's file format (`np.savez_compressed`, the `SearchState`
  field names, `meta_capacity`, `meta_pool_layout = 1`, schema 3 with an
  embedded CRC32), so a snapshot written here loads in the JAX package
  and the reverse; torn-write-proof (temp file, fsync, rotation of the
  current file to a `.prev` last-good); schema 1 and 2 files upgrade on
  load;
- `load_resilient`: rollback from a torn current file to its last-good
  sibling, with the torn file quarantined;
- `reshard_state`/`collapse_to_single_device`: a stacked (D-worker)
  snapshot, as the JAX multi-device driver writes it, re-homed onto one
  pool;
- `grow`: lossless re-homing into a larger pool after an overflow;
- `run_segmented`: the segment driver, with heartbeat reports,
  checkpoints, stall detection, retry of transient errors, a wall-clock
  watchdog and the fault-injection points of `utils/faults.py`; with
  `overlap=True` the pipelined driver (`_run_segmented_overlap`), which
  dispatches segment N+1 before it reads segment N's counters and hands
  compression, fsync and rotation to an `AsyncCheckpointWriter` thread.

Every function that takes a state also takes a multi-worker search's
list of worker states (`engine/distributed.py`): `save` writes it as the
JAX multi-device driver's stacked (D, ...) snapshot, `run_segmented`
drives one `_DistDriver.run` a segment with per-worker heartbeat fields,
and `load` returns a stacked snapshot as one stacked state, which the
driver splits across its workers (`reshard_state` first when the worker
count differs).

`device.run` updates the pool in place (a captured CUDA graph holds it by
address), where the JAX `run` is functional. So `run_segmented` keeps a
device copy of the live rows, the counters and the telemetry vector
before each segment it may retry, and copies it back into the same
tensors before a retry: a retried segment redoes the same work on the same
pool, and `run` replays the same graph. `load`, `grow` and
`collapse_to_single_device` make new pool storage, so `run` captures a new
graph for a state they return (`device.clear_graphs()` drops the old
ones).

Under overlap `run_fn` dispatches without reading anything back
(`distributed._DistDriver.run_async`) and returns a `DispatchedStates`:
the worker list with a `CounterBlock`, its report fields copied into
pinned host memory behind a CUDA event right after the segment's last
replay. The next dispatch rewrites the same counter and pool tensors in
place, so the driver reads the counters only from that block, and reads a
checkpoint segment's live rows before it dispatches the next segment.

In a multi-process job (`parallel/mesh.py`: a gloo process group, each
rank driving its share of the workers), a worker list holds the rank's
workers: every per-segment fetch gathers every rank's counters, a save
gathers the stacked state on rank 0, which alone writes the file, a torn
file is quarantined by rank 0 only, and `run_segmented` makes one attempt
and never overlaps (a retry or a speculative dispatch would reorder the
collectives across ranks), as the JAX multi-controller tier does.

Entry points that make a state take `device` ("cuda" unless the caller
passes "cpu").
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pathlib
import queue
import threading
import time
import warnings
import zipfile
import zlib

import numpy as np
import torch

from .. import convert
from ..obs import metrics as obs_metrics
from ..obs import tracelog
from ..parallel import mesh
from ..utils import faults
from ..utils.retry import retry_call
from . import telemetry as tele
from .device import COUNTER_DTYPES, SearchState, resolve_device, row_limit

POOL_FIELDS = ("prmu", "depth", "aux")

# Checkpoint schema version, embedded in every file. Loaders accept every
# version <= CURRENT (row-major pools transpose, pre-aux files rebuild);
# a file from a NEWER schema fails loudly (CheckpointSchemaError).
#   1 (implicit): row-major full-pool snapshots, no aux, no meta
#   2: feature-major live-row snapshots + capacity/pool_layout meta
#   3: = 2 plus embedded CRC32 + explicit schema version
SCHEMA_VERSION = 3

LAST_GOOD_SUFFIX = ".prev"


class CheckpointCorrupt(RuntimeError):
    """The checkpoint file is torn/corrupt (bad zip, CRC mismatch, missing
    members). load_resilient treats this as 'skip to the last-good
    snapshot', never 'resume wrong state'."""


class CheckpointSchemaError(RuntimeError):
    """The checkpoint was written by a NEWER schema than this build reads.
    Not corruption: falling back to an older snapshot would silently
    discard valid progress, so this is never swallowed."""


class SegmentTimeout(RuntimeError):
    """A segment exceeded its wall-clock watchdog. Never retried: the
    watchdog's thread may still be running the segment on the pool, so the
    state is lost; kill the process and resume from the checkpoint."""


class StaleCheckpointError(RuntimeError):
    """An epoch-stale save was refused: the file on disk carries a NEWER
    lease epoch (`meta_lease_epoch`) than the writer. Never retried: the
    stale owner must stop, not clobber its successor's snapshot."""


# Error types worth retrying: host/filesystem I/O, injected faults, and an
# allocation that failed (the caching allocator raises it before any
# launch, and the context stays usable). A CUDA runtime error
# (`torch.AcceleratorError`, or a RuntimeError carrying one) poisons the
# context and is not among them.
TRANSIENT_ERRORS = (OSError, faults.InjectedFault,
                    torch.cuda.OutOfMemoryError)


def _retry(fn, what: str, attempts: int, base_s: float):
    """Run `fn` with exponential-backoff retry on TRANSIENT_ERRORS; any
    other exception (wrong answers, schema errors, timeouts) propagates
    at once."""
    return retry_call(fn, what=what, attempts=attempts, base_s=base_s,
                      transient=TRANSIENT_ERRORS)


def _on_device(device: torch.device | None):
    """The CUDA device context for `device` (a thread's current device is
    its own), or nothing for the CPU."""
    if device is not None and device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _with_watchdog(fn, timeout_s: float | None, what: str,
                   device: torch.device | None = None):
    """Run `fn` under a wall-clock watchdog: raises SegmentTimeout if it
    exceeds `timeout_s` (None/0 disables). The work runs on a daemon
    thread, on `device` and under the caller's fault plan (a thread-scoped
    plan lives in thread-local state the worker could not see otherwise),
    so a hung call cannot also hang process exit."""
    if not timeout_s or timeout_s <= 0:
        return fn()
    box: dict = {}
    plan = faults.active()

    def target():
        try:
            with faults.scoped(plan), _on_device(device):
                box["result"] = fn()
        except BaseException as e:      # noqa: BLE001 — re-raised below
            box["error"] = e

    th = threading.Thread(target=target, daemon=True,
                          name="tts-segment-watchdog")
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        raise SegmentTimeout(
            f"{what} exceeded the {timeout_s:.1f}s wall-clock watchdog "
            "(hung device call?); kill and resume from the last "
            "checkpoint")
    if "error" in box:
        raise box["error"]
    return box["result"]


def _field(state, f: str) -> torch.Tensor:
    """Field `f` of a state, or of a worker list stacked on the first
    worker's device (a counter as (D,), the telemetry as (D, WIDTH))."""
    if isinstance(state, list):
        dev = state[0].prmu.device
        return torch.stack([getattr(s, f).to(dev) for s in state])
    return getattr(state, f)


def _pool(state) -> torch.Tensor:
    """A pool tensor of the state (the first worker's for a list): its
    device and row capacity are the state's."""
    return state[0].prmu if isinstance(state, list) else state.prmu


def _fetch_many(xs: tuple, fire: bool = True) -> tuple:
    """Several device tensors of one device read back in ONE transfer (as
    int64, then cast back to each tensor's dtype), as numpy arrays of their
    shapes. `fire=False` skips the `host_fetch` fault-injection point (only
    the per-segment heartbeat fetch is one)."""
    if fire:
        faults.fire("host_fetch")
    flat = torch.cat([x.reshape(-1).long() for x in xs]).cpu().numpy()
    out, at = [], 0
    for x in xs:
        n = x.numel()
        out.append(flat[at:at + n].reshape(tuple(x.shape))
                   .astype(convert.np_dtype(x.dtype)))
        at += n
    return tuple(out)


# the per-segment report fields, in the order every driver reads them
REPORT_FIELDS = ("iters", "tree", "sol", "size", "best", "steals",
                 "overflow", "evals")


class PinnedRing:
    """Two pinned host buffers, taken in turn by successive
    `CounterBlock`s of one driver: the block of segment N and the block of
    the speculative N+1 can be in flight together. A buffer taken again
    first has its previous block read out of it."""

    def __init__(self):
        self._slots: list = [None, None]
        self._next = 0

    def take(self, n: int, block: "CounterBlock") -> torch.Tensor:
        i, self._next = self._next, self._next ^ 1
        buf = None
        if self._slots[i] is not None:
            buf, owner = self._slots[i]
            owner.read()
            if buf.numel() < n:
                buf = None
        if buf is None:
            buf = torch.empty(n, dtype=torch.int64, pin_memory=True)
        self._slots[i] = (buf, block)
        return buf[:n]


class CounterBlock:
    """A worker list's report fields (`REPORT_FIELDS`) and telemetry
    vectors on their way to the host. On a card, one copy into pinned host
    memory (from `ring`) is enqueued on the stream right after the
    segment's last replay, and an event is recorded behind it: `read` waits
    for that event only, so a segment dispatched after it, which rewrites
    the same device tensors in place, neither stalls the read nor leaks
    into it. On the CPU the values are taken at once."""

    def __init__(self, states: list, ring: PinnedRing | None = None):
        dev = states[0].prmu.device
        self.n = len(states)
        self.tele_w = int(states[0].telemetry.shape[-1])
        flat = torch.cat(
            [torch.stack([getattr(s, f).to(dev).long() for s in states])
             for f in REPORT_FIELDS]
            + [torch.stack([s.telemetry.to(dev) for s in states])
               .reshape(-1)])
        self._values: np.ndarray | None = None
        self._event = None
        if dev.type == "cuda":
            self._host = (ring or PinnedRing()).take(flat.numel(), self)
            self._host.copy_(flat, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))
        else:
            self._host = flat

    def read(self, fields: tuple = REPORT_FIELDS) -> tuple:
        """`fields` (report fields or "telemetry") as numpy arrays of the
        JAX dtypes, (D,) each and (D, WIDTH) for the telemetry."""
        if self._values is None:
            if self._event is not None:
                self._event.synchronize()
            self._values = self._host.numpy().copy()
        n, out = self.n, []
        for f in fields:
            if f == "telemetry":
                at = len(REPORT_FIELDS) * n
                out.append(self._values[at:].reshape(n, self.tele_w))
            else:
                i = REPORT_FIELDS.index(f)
                out.append(self._values[i * n:(i + 1) * n].astype(
                    convert.np_dtype(COUNTER_DTYPES[f])))
        return tuple(out)


class DispatchedStates(list):
    """The worker list an asynchronous segment dispatch returns, with the
    `CounterBlock` of its report fields (`counter_block`)."""

    def __init__(self, states: list, block: CounterBlock):
        super().__init__(states)
        self.counter_block = block


def _fetch_fields(state, fields: tuple, fire: bool = True) -> tuple:
    """Fields of a state as numpy arrays in one transfer (`_fetch_many`);
    a worker list's stacked over its workers and, in a multi-process job,
    over every rank's workers. A `DispatchedStates` is read from its
    counter block."""
    if isinstance(state, DispatchedStates):
        if fire:
            faults.fire("host_fetch")
        return state.counter_block.read(fields)
    out = _fetch_many(tuple(_field(state, f) for f in fields), fire=fire)
    if isinstance(state, list):
        out = mesh.gather_rows(out)
    return out


def _payload_crc(arrays: dict) -> int:
    """CRC32 over every stored array's name, dtype, shape and raw bytes
    (sorted by name, `meta_crc32` itself excluded): the end-to-end
    integrity check a torn write or bit flip cannot survive, including
    damage the zip container cannot see."""
    crc = 0
    for name in sorted(arrays):
        if name == "meta_crc32":
            continue
        a = np.ascontiguousarray(np.asarray(arrays[name]))
        crc = zlib.crc32(name.encode(), crc)
        crc = zlib.crc32(str(a.dtype).encode(), crc)
        crc = zlib.crc32(np.asarray(a.shape, np.int64).tobytes(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return crc & 0xFFFFFFFF


def last_good_path(path: str | pathlib.Path) -> pathlib.Path:
    """The rotating last-good snapshot that rides beside `path`."""
    path = pathlib.Path(path)
    return path.with_name(path.name + LAST_GOOD_SUFFIX)


def resume_path(path: str | pathlib.Path) -> pathlib.Path | None:
    """The file a resume should try first: `path` if present, else its
    last-good sibling (the current file vanished mid-rotation), else None
    (a stale .tmp of an interrupted first save is not resumable: it was
    never fsync'd and renamed)."""
    path = pathlib.Path(path)
    if path.exists():
        return path
    prev = last_good_path(path)
    return prev if prev.exists() else None


# checkpoint size buckets (bytes)
_BYTES_BUCKETS = (1e4, 1e5, 1e6, 1e7, 1e8, 1e9)

# segment-gap buckets (seconds)
GAP_BUCKETS = (0.0005, 0.002, 0.01, 0.05, 0.2, 1.0, 5.0, 30.0)
GAP_HELP = ("device-idle gap between consecutive segments: dispatch of "
            "segment N+1 minus results-ready of segment N, clamped at 0")


def save(path: str | pathlib.Path, state: SearchState,
         meta: dict | None = None) -> dict | None:
    """Snapshot a search state: one `checkpoint.save` span carrying the
    written byte count, plus the save-latency and bytes histograms. See
    `_save_impl` for the format and durability story. Returns the payload
    written (None on a rank of a multi-process job that writes nothing)."""
    with tracelog.span("checkpoint.save", path=str(path)) as sp:
        arrays = _save_impl(path, state, meta)
        nbytes = os.path.getsize(path) if arrays is not None else 0
        sp.set(bytes=nbytes)
    _record_save_metrics(sp.dur, nbytes)
    return arrays


def _record_save_metrics(dur: float, nbytes: int) -> None:
    reg = obs_metrics.default()
    reg.counter("tts_checkpoint_saves_total",
                "checkpoint snapshots written").inc()
    reg.histogram("tts_checkpoint_save_seconds",
                  "checkpoint save latency (fetch+compress+fsync)"
                  ).observe(dur)
    if nbytes:
        reg.histogram("tts_checkpoint_bytes", "checkpoint file size",
                      buckets=_BYTES_BUCKETS).observe(nbytes)


def _save_impl(path: str | pathlib.Path, state: SearchState,
               meta: dict | None = None) -> dict | None:
    """Snapshot a search state (single-device or stacked).

    Only the live pool rows (below the cursor) are fetched and written:
    rows above it are garbage by the pool invariant. The declared capacity
    is kept in the file, so `load` re-homes the rows into an identical
    pool.

    Torn-write-proof: the bytes (with an embedded CRC32 and the schema
    version) go to a temp file that is flushed and fsync'd BEFORE any
    rename; the previous snapshot rotates to a `.prev` last-good sibling
    and the temp file renames into place. A crash at any point leaves the
    old snapshot, the rotated last-good, or the new snapshot, never a
    half-written file under the resume path. Only rank 0 of a
    multi-process job writes; the others return None."""
    arrays = snapshot_arrays(state, meta)
    if arrays is not None:
        _write_snapshot(path, arrays)
    return arrays


def snapshot_arrays(state, meta: dict | None = None) -> dict | None:
    """The checkpoint payload of a state (or a worker list, stacked), up to
    (not including) the schema and CRC stamps: `size` read once, then the
    live rows `[..., :size]` of each pool and the counters and telemetry
    vector (the counters in one transfer). In a multi-process job every
    rank takes part, every rank's workers are stacked on rank 0, and the
    other ranks get None (they write nothing)."""
    n = int(np.max(_fetch_fields(state, ("size",), fire=False)[0]))
    arrays = convert.state_to_numpy(state, rows=n)
    if isinstance(state, list):
        arrays = mesh.gather_stacked(arrays, dst=0)
        if arrays is None:
            return None
    arrays["meta_capacity"] = np.asarray(_pool(state).shape[-1])
    arrays["meta_pool_layout"] = np.asarray(1)   # 1 = feature-major
    if meta:
        reserved = {"capacity", "pool_layout", "schema_version", "crc32"} \
            & meta.keys()
        if reserved:
            raise ValueError(f"meta keys {sorted(reserved)} are reserved "
                             "by the checkpoint format")
        for k, v in meta.items():
            arrays[f"meta_{k}"] = np.asarray(v)
    return arrays


def _existing_lease_epoch(path: pathlib.Path) -> int | None:
    """Best-effort peek of an on-disk snapshot's `meta_lease_epoch`. An
    absent file, an absent stamp or an unreadable file all give None: the
    fence only refuses when it can PROVE the disk is newer."""
    try:
        with np.load(path) as z:
            if "meta_lease_epoch" in z.files:
                return int(z["meta_lease_epoch"])
    except Exception:  # noqa: BLE001 — any unreadable existing file
        return None    # means "nothing provably newer": proceed
    return None


def _write_snapshot(path: str | pathlib.Path, arrays: dict) -> None:
    """The durable half of a save: stamp schema + CRC, write to a temp
    file, fsync, rotate current -> `.prev` last-good, rename into place,
    fsync the directory. Idempotent with respect to retry."""
    arrays["meta_schema_version"] = np.asarray(SCHEMA_VERSION)
    arrays["meta_crc32"] = np.asarray(_payload_crc(arrays), np.uint32)
    path = pathlib.Path(path)
    # a save that carries a lease-epoch stamp refuses to overwrite a file
    # stamped with a newer one; saves without it pay nothing
    inc = arrays.get("meta_lease_epoch")
    if inc is not None:
        existing = _existing_lease_epoch(path)
        if existing is not None and existing > int(inc):
            raise StaleCheckpointError(
                f"{path}: on-disk checkpoint carries lease epoch "
                f"{existing} > writer's {int(inc)} — refusing the "
                "stale save")
    tmp = path.with_suffix(".tmp.npz")
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    # both renames are atomic; a kill between them leaves no current file
    # and resume_path/load_resilient fall back to the last-good sibling
    if path.exists():
        os.replace(path, last_good_path(path))
    os.replace(tmp, path)
    try:
        dfd = os.open(path.parent or pathlib.Path("."), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass   # not every filesystem supports directory fsync


class AsyncCheckpointWriter:
    """One writer thread that takes checkpoint compression, fsync and
    rotation off the segment dispatch thread (JAX
    `AsyncCheckpointWriter`; the overlapped driver's half of TTS_OVERLAP).

    - One thread (`tts-ckpt-writer`) and a FIFO queue: snapshots land in
      submission order, so the current/`.prev` rotation of
      `_write_snapshot` holds exactly as on the synchronous path.
    - The queue is bounded (`config.ASYNC_CKPT_QUEUE_DEPTH`): a dispatch
      thread that outruns the disk blocks in `enqueue`, and no snapshot is
      ever dropped.
    - `prepare` reads the state on the calling thread (`snapshot_arrays`:
      the next dispatch rewrites the pools in place); only the host work on
      the fetched arrays crosses to the thread.
    - `drain` blocks until everything queued is on disk and re-raises the
      first writer error; every exit of the overlapped driver drains, so a
      returned state has its last checkpoint on disk.

    The thread re-installs the submitting thread's fault plan and trace
    context (`submesh` dropped) and runs the synchronous path's post-write
    hooks in the same order: the round-trip audit, against the counter sums
    taken in `prepare`, then the `post_checkpoint` fault point."""

    def __init__(self, retry_attempts: int | None = None,
                 retry_base_s: float | None = None,
                 max_pending: int | None = None):
        from ..utils import config as _cfg

        if retry_attempts is None:
            retry_attempts = _cfg.env_int("TTS_RETRY_ATTEMPTS")
        if retry_base_s is None:
            retry_base_s = _cfg.env_float("TTS_RETRY_BASE_S")
        self.retry_attempts = retry_attempts
        self.retry_base_s = retry_base_s
        self._q: queue.Queue = queue.Queue(
            maxsize=max_pending or _cfg.ASYNC_CKPT_QUEUE_DEPTH)
        # two locks on purpose: _close_lock makes the closed check and the
        # put atomic against close() (a task put after the shutdown
        # sentinel would never be marked done, hanging a later drain), and
        # the writer thread never takes it, so a submitter blocked on the
        # full queue while holding it still drains; _err_lock hands the
        # error over between the writer and the submitter. One shared lock
        # would deadlock: a submitter holding it while blocked in the full
        # queue's put(), and the writer's error path waiting for it before
        # task_done(), form an ABBA cycle between the lock and the queue's
        # capacity.
        self._close_lock = threading.Lock()
        self._err_lock = threading.Lock()
        self._err: BaseException | None = None   # guarded-by: _err_lock
        self._closed = False                     # guarded-by: _close_lock
        # the most tasks queued or being written at once, since creation
        self.peak_pending = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tts-ckpt-writer")
        self._thread.start()

    def prepare(self, path, state, meta: dict | None = None,
                segment: int | None = None) -> dict | None:
        """Read the snapshot on the calling thread; returns the task for
        `enqueue`, or None on a rank that writes nothing."""
        from ..obs import audit as obs_audit

        arrays = snapshot_arrays(state, meta)
        if arrays is None:
            return None
        sums = (obs_audit.array_sums(arrays)
                if obs_audit.roundtrip_enabled() else None)
        ctx = {**tracelog.current_context(), "submesh": None}
        return {"path": str(path), "arrays": arrays, "sums": sums,
                "segment": segment, "plan": faults.active(), "ctx": ctx}

    def enqueue(self, task: dict | None) -> None:
        """Queue a prepared task, blocking at the queue's bound. The first
        pending writer error is raised first (a failed write is never
        papered over by later ones)."""
        self._raise_pending()
        if task is None:
            return
        with self._close_lock:
            if self._closed:
                raise RuntimeError("AsyncCheckpointWriter is closed")
            self._q.put(task)
            self.peak_pending = max(self.peak_pending,
                                    self._q.unfinished_tasks)

    def submit(self, path, state, meta: dict | None = None,
               segment: int | None = None) -> None:
        """`prepare` and `enqueue` in one call."""
        self.enqueue(self.prepare(path, state, meta, segment=segment))

    def drain(self) -> None:
        """Block until every queued snapshot is on disk; raise the first
        writer error (a failed last save fails the run, as it would on the
        synchronous path)."""
        self._q.join()
        self._raise_pending()

    def close(self, raise_pending: bool = True) -> None:
        """Drain and stop the thread; raise a pending writer error unless
        `raise_pending` is False (on an exception's way out, where it would
        hide the first error)."""
        with self._close_lock:
            was_closed = self._closed
            if not was_closed:
                self._closed = True
                self._q.put(None)
        if not was_closed:
            self._thread.join()
        if raise_pending:
            self._raise_pending()

    def _raise_pending(self) -> None:
        with self._err_lock:
            err, self._err = self._err, None
        if err is not None:
            raise err

    def _loop(self) -> None:
        while True:
            task = self._q.get()
            try:
                if task is None:
                    return
                self._write_one(task)
            except BaseException as e:  # noqa: BLE001 — raised at the
                with self._err_lock:    # next enqueue() or drain()
                    if self._err is None:
                        self._err = e
            finally:
                self._q.task_done()

    def _write_one(self, task: dict) -> None:
        from ..obs import audit as obs_audit

        path = task["path"]
        with faults.scoped(task["plan"]), \
                tracelog.get().context(**task["ctx"]):
            with tracelog.span("checkpoint.save", path=path,
                               async_write=True) as sp:
                _retry(lambda: _write_snapshot(path, task["arrays"]),
                       "checkpoint save", self.retry_attempts,
                       self.retry_base_s)
                nbytes = os.path.getsize(path)
                sp.set(bytes=nbytes)
            _record_save_metrics(sp.dur, nbytes)
            if task["sums"] is not None:
                # the audit comes before the fault point, which may
                # corrupt the file on purpose, as on the synchronous path
                obs_audit.check_checkpoint_roundtrip(path, task["sums"])
            faults.fire("post_checkpoint", segment=task["segment"],
                        path=path)


def load(path: str | pathlib.Path, p_times: np.ndarray | None = None,
         device="cuda") -> tuple[SearchState, dict]:
    """Load a snapshot onto `device`, verifying integrity first. Pre-aux
    checkpoints are upgraded by rebuilding aux from the live rows: pass
    the instance's `p_times` for that; without it such files raise a clear
    error.

    Raises CheckpointCorrupt on a torn/damaged file (bad zip, CRC
    mismatch, missing members) and CheckpointSchemaError on a file written
    by a newer schema than this build reads."""
    with tracelog.span("checkpoint.load", path=str(path)):
        obs_metrics.default().counter(
            "tts_checkpoint_loads_total",
            "checkpoint load attempts").inc()
        return _load_impl(path, p_times=p_times, device=device)


def _load_impl(path: str | pathlib.Path, p_times: np.ndarray | None = None,
               device="cuda") -> tuple[SearchState, dict]:
    dev = resolve_device(device)
    path = pathlib.Path(path)
    try:
        with np.load(path) as z:
            # full materialization doubles as the zip-member CRC pass
            raw = {k: z[k] for k in z.files}
    except (zipfile.BadZipFile, zlib.error, OSError, EOFError, ValueError,
            KeyError) as e:
        reason = str(e)
        if len(reason) > 200:
            reason = reason[:200] + "... [truncated]"
        raise CheckpointCorrupt(
            f"checkpoint {path} is unreadable (torn write or "
            f"corruption): {reason}") from e
    version = int(raw.get("meta_schema_version", 2 if "meta_capacity"
                          in raw else 1))
    if version > SCHEMA_VERSION:
        raise CheckpointSchemaError(
            f"checkpoint {path} uses schema version {version}; this "
            f"build reads <= {SCHEMA_VERSION} — upgrade the reader, do "
            "not fall back to an older snapshot")
    if "meta_crc32" in raw:
        want = int(raw["meta_crc32"])
        got = _payload_crc(raw)
        if got != want:
            raise CheckpointCorrupt(
                f"checkpoint {path} failed its embedded CRC32 "
                f"(stored {want:#010x}, recomputed {got:#010x})")
    missing = [f for f in SearchState._fields
               if f not in ("aux", "telemetry") and f not in raw]
    if missing:
        raise CheckpointCorrupt(
            f"checkpoint {path} is missing state fields {missing} "
            "(truncated or partial write)")
    arrays = {f: raw[f] for f in SearchState._fields if f in raw}
    meta = {k[5:]: raw[k] for k in raw if k.startswith("meta_")}
    meta.pop("schema_version", None)
    meta.pop("crc32", None)
    if not bool(meta.pop("pool_layout", 0)):
        # legacy row-major snapshot: transpose the pool matrices; a legacy
        # aux held [front | remain], of which the pool keeps the front
        for f in ("prmu", "aux"):
            if f in arrays:
                arrays[f] = np.swapaxes(arrays[f], -1, -2).copy()
        if "aux" in arrays and arrays["aux"].shape[-2] > 0:
            m = arrays["aux"].shape[-2] // 2
            arrays["aux"] = arrays["aux"][..., :m, :].copy()
    # a live-row snapshot re-homes into its declared capacity
    capacity = int(meta.pop("capacity")) if "capacity" in meta else None
    if "aux" not in arrays:
        if p_times is None:
            raise ValueError(
                f"{path} is a pre-aux checkpoint; pass p_times to load() "
                "so the per-node pool tables can be reconstructed")
        from ..ops import reference as ref
        prmu = arrays["prmu"]            # feature-major (/, jobs, rows)
        depth = arrays["depth"]
        size = np.atleast_1d(arrays["size"])
        stacked = prmu.ndim == 3
        m = p_times.shape[0]
        aux = np.zeros(prmu.shape[:-2] + (m, prmu.shape[-1]), np.int32)
        for d in range(prmu.shape[0] if stacked else 1):
            n = int(size[d if stacked else 0])
            if stacked:
                aux[d, :, :n] = ref.prefix_front_remain(
                    p_times, prmu[d, :, :n].T, depth[d, :n])[:, :m].T
            else:
                aux[:, :n] = ref.prefix_front_remain(
                    p_times, prmu[:, :n].T, depth[:n])[:, :m].T
        arrays["aux"] = aux
    if "telemetry" not in arrays:
        # pre-telemetry snapshot: a zeroed block at the current flag's
        # width (counts restart from the resume)
        lead = arrays["prmu"].shape[:-2]
        arrays["telemetry"] = np.zeros(lead + (tele.enabled_width(),),
                                       np.int64)
    return convert.state_from_numpy(arrays, dev, capacity=capacity), meta


def load_resilient(path: str | pathlib.Path,
                   p_times: np.ndarray | None = None, device="cuda"
                   ) -> tuple[SearchState, dict, pathlib.Path]:
    """Load `path`, falling back to its rotating last-good sibling when the
    current file is torn/corrupt (or missing after an interrupted
    rotation). Returns (state, meta, loaded_path).

    A torn current file is quarantined (renamed to `.corrupt`), so the
    next save cannot rotate it over the good last-good. Only when every
    candidate is unreadable does this raise, listing what was tried.
    CheckpointSchemaError is not caught: a valid newer-schema file must
    not be silently shadowed by an older one."""
    path = pathlib.Path(path)
    errors = []
    for cand in (path, last_good_path(path)):
        if not cand.exists():
            errors.append(f"{cand}: missing")
            continue
        try:
            state, meta = load(cand, p_times=p_times, device=device)
        except CheckpointCorrupt as e:
            warnings.warn(f"skipping corrupt checkpoint {cand}: {e}",
                          RuntimeWarning, stacklevel=2)
            errors.append(f"{cand}: {e}")
            tracelog.event("checkpoint.corrupt", path=str(cand),
                           error=str(e)[:200])
            obs_metrics.default().counter(
                "tts_checkpoint_corrupt_total",
                "torn/corrupt snapshots skipped on load").inc()
            if cand == path and mesh.process_index() == 0:
                # renamed aside, not unlinked: the damage stays available
                # for forensics; by rank 0 only, since every rank of a
                # multi-process job resumes the same file
                try:
                    os.replace(cand, str(cand) + ".corrupt")
                    tracelog.event("checkpoint.quarantine",
                                   path=str(cand) + ".corrupt")
                    obs_metrics.default().counter(
                        "tts_checkpoint_quarantines_total",
                        "torn current snapshots renamed aside").inc()
                except OSError:
                    pass
            continue
        if cand != path:
            warnings.warn(
                f"resuming from last-good snapshot {cand} (current "
                "checkpoint torn/missing); work since the previous "
                "checkpoint interval will be redone",
                RuntimeWarning, stacklevel=2)
            tracelog.event("checkpoint.rollback", path=str(cand),
                           wanted=str(path))
            obs_metrics.default().counter(
                "tts_checkpoint_rollbacks_total",
                "resumes served by the rotating last-good sibling").inc()
        return state, meta, cand
    raise CheckpointCorrupt("no loadable checkpoint: " + "; ".join(errors))


def reshard_state(state: SearchState, new_workers: int,
                  squeeze: bool = False, device="cuda") -> SearchState:
    """Re-home an N-worker stacked state (or a single-device one) onto
    `new_workers` pools on `device`, on the host and losslessly: every
    worker's live rows are concatenated in worker order and striped
    round-robin across the new pools (`balance.waterfill_counts`: the
    pools' counts differ by <= 1). Capacity doubles until the widest
    stripe fits.

    Counters: tree/sol/evals/sent/recv/steals keep their global totals,
    summed onto worker 0; iters is replicated at the old max; best is the
    min, replicated; overflow is cleared. Telemetry merges onto worker 0
    (`telemetry.merge`). `squeeze=True` with new_workers=1 returns an
    unstacked single-device state (the shape `device.run` takes)."""
    if new_workers < 1:
        raise ValueError(f"new_workers must be >= 1, got {new_workers}")
    if squeeze and new_workers != 1:
        raise ValueError("squeeze=True requires new_workers == 1")
    from ..parallel import balance as bal

    capacity = int(state.prmu.shape[-1])
    arrs = convert.state_to_numpy(state, rows=int(state.size.max()))
    if arrs["prmu"].ndim == 2:            # single-device state: lift
        arrs = {f: a[None, ...] for f, a in arrs.items()}
    if arrs["prmu"].ndim != 3:
        raise ValueError(
            f"reshard_state needs a (D, jobs, capacity) stacked or "
            f"(jobs, capacity) single-device pool, got "
            f"{tuple(state.prmu.shape)}")
    D, jobs, _ = arrs["prmu"].shape
    A = arrs["aux"].shape[1]
    M = new_workers
    if M != D:
        tracelog.event("elastic_reshard", old_workers=int(D),
                       new_workers=int(M))
        obs_metrics.default().counter(
            "tts_elastic_reshards_total",
            "checkpoints re-homed onto a different worker count").inc()
    sizes = arrs["size"].astype(np.int64)

    # live rows in worker order (bottom-to-top per pool)
    live_prmu = np.concatenate(
        [arrs["prmu"][d, :, :sizes[d]] for d in range(D)], axis=1)
    live_depth = np.concatenate(
        [arrs["depth"][d, :sizes[d]] for d in range(D)])
    live_aux = np.concatenate(
        [arrs["aux"][d, :, :sizes[d]] for d in range(D)], axis=1)

    counts = bal.waterfill_counts(int(sizes.sum()), M)
    while counts.max() > capacity:
        capacity *= 2
    width = int(counts.max())
    prmu = np.zeros((M, jobs, width), arrs["prmu"].dtype)
    depth = np.zeros((M, width), arrs["depth"].dtype)
    aux = np.zeros((M, A, width), arrs["aux"].dtype)
    for m in range(M):
        stripe = slice(m, None, M)     # round-robin, water-filled
        n = int(counts[m])
        prmu[m, :, :n] = live_prmu[:, stripe]
        depth[m, :n] = live_depth[stripe]
        aux[m, :, :n] = live_aux[:, stripe]

    def on_zero(f):
        v = np.zeros(M, np.int64)
        v[0] = int(np.sum(arrs[f]))
        return v

    tw = arrs["telemetry"].shape[-1]
    telem = np.zeros((M, tw), np.int64)
    if tw:
        telem[0] = tele.merge(arrs["telemetry"])
    out = dict(prmu=prmu, depth=depth, aux=aux, telemetry=telem,
               size=counts.astype(np.int32),
               best=np.full(M, int(np.min(arrs["best"])), np.int32),
               iters=np.full(M, int(np.max(arrs["iters"])), np.int64),
               overflow=np.zeros(M, bool),
               **{f: on_zero(f) for f in ("tree", "sol", "evals", "sent",
                                          "recv", "steals")})
    if squeeze:
        out = {f: a[0] for f, a in out.items()}
    return convert.state_from_numpy(out, device, capacity=capacity)


def collapse_to_single_device(state: SearchState, chunk: int, jobs: int,
                              device="cuda") -> SearchState:
    """Collapse a stacked (D, jobs, cap) state onto ONE pool on `device`:
    the reshard to a single squeezed pool, pre-sized for the stacked
    run's total footprint (D x per-worker capacity) and then doubled until
    the live rows clear the usable-row limit (`device.row_limit`'s
    chunk*jobs scratch margin), so a nearly full stacked snapshot cannot
    overflow on its first resumed segment. A single-device state is
    returned as it is."""
    if state.prmu.dim() != 3:
        return state
    stacked_total = int(state.prmu.shape[0] * state.prmu.shape[-1])
    out = reshard_state(state, 1, squeeze=True, device=device)
    grown = max(int(out.prmu.shape[-1]), stacked_total)
    need = int(out.size)
    while row_limit(grown, chunk, jobs) < max(need, 1):
        grown *= 2
    if grown != out.prmu.shape[-1]:
        out = grow(out, grown)
    return out


class PoolOverflow(RuntimeError):
    """Pool capacity exceeded; `.state` is the (resumable) search state."""

    def __init__(self, message: str, state: SearchState):
        super().__init__(message)
        self.state = state


def grow(state: SearchState, new_capacity: int) -> SearchState:
    """Re-home a state's pool (single-device or stacked) into
    `new_capacity` rows on its device and clear the overflow flag(s): the
    recovery path after an overflow. Rows above the cursor are garbage by
    the pool invariant, so growth is zero-padding the row axis."""
    capacity = state.prmu.shape[-1]
    if new_capacity < capacity:
        raise ValueError(f"new_capacity {new_capacity} < current {capacity}")
    tracelog.event("pool.grow", capacity=int(capacity),
                   new_capacity=int(new_capacity))
    obs_metrics.default().counter(
        "tts_pool_grows_total", "lossless overflow pool growths").inc()

    def pad_rows(x: torch.Tensor) -> torch.Tensor:
        out = x.new_zeros(x.shape[:-1] + (new_capacity,))
        out[..., :capacity] = x
        return out

    return state._replace(prmu=pad_rows(state.prmu),
                          depth=pad_rows(state.depth),
                          aux=pad_rows(state.aux),
                          overflow=torch.zeros_like(state.overflow))


@dataclasses.dataclass
class SegmentReport:
    segment: int
    iters: int
    tree: int
    sol: int
    best: int
    pool_size: int
    elapsed: float
    # a multi-worker run's per-worker live sizes, cumulative steal counts,
    # incumbents, iterations and evaluations; None on one device
    per_worker: dict | None = None
    evals: int = 0               # cumulative bound evaluations
    # cumulative search telemetry (telemetry.summarize), None when the
    # state carries no telemetry vector
    telemetry: dict | None = None


class _ReportFolder:
    """Per-segment report assembly: fold a fetched counter/telemetry block
    into the per-segment `search.telemetry` delta event, the
    SegmentReport, the explored-node throughput counter and the
    no-progress stall check."""

    def __init__(self, state: SearchState, t0: float, stall_limit: int,
                 start_iters: int):
        self.t0 = t0
        self.stall_limit = stall_limit
        self.stalls = 0
        self.last = (start_iters, -1, -1)
        self.tele_w = int(_field(state, "telemetry").shape[-1])
        # a resumed state carries cumulative totals: the throughput counter
        # and the telemetry deltas count only this run's progress
        tree, telem = _fetch_fields(state, ("tree", "telemetry"),
                                    fire=False)
        self.prev_tree = int(tree.sum())
        self.prev_tele = tele.merge(telem) if self.tele_w else None
        self.nodes_c = obs_metrics.default().counter(
            "tts_nodes_explored_total",
            "explored-node throughput (segment deltas)")

    def fold(self, fetched: tuple, seg: int) -> SegmentReport:
        f_iters, f_tree, f_sol, f_size, f_best, f_steals, _, f_evals = \
            fetched[:8]
        tree = int(f_tree.sum())
        per_worker = None
        if f_size.ndim:                     # a worker list or stacked state
            per_worker = {"size": f_size.tolist(),
                          "steals": f_steals.tolist(),
                          "best": f_best.tolist(),
                          "iters": f_iters.tolist(),
                          "evals": f_evals.tolist()}
        tele_summary = None
        if self.tele_w:
            merged = tele.merge(fetched[8])
            tele_summary = tele.summarize(merged)
            tracelog.event(
                "search.telemetry", segment=seg,
                **tele.delta_counts(merged, self.prev_tele),
                pool=int(f_size.sum()),
                pool_hw=tele_summary["pool_highwater"],
                best=int(f_best.min()),
                improvements=tele_summary["improvements"])
            self.prev_tele = merged
        # per-segment delta: live throughput, not the cumulative totals a
        # resumed checkpoint would double-report
        self.nodes_c.inc(max(tree - self.prev_tree, 0))
        self.prev_tree = tree
        return SegmentReport(
            segment=seg, iters=int(f_iters.max()), tree=tree,
            sol=int(f_sol.sum()), best=int(f_best.min()),
            pool_size=int(f_size.sum()),
            elapsed=time.perf_counter() - self.t0, per_worker=per_worker,
            evals=int(f_evals.sum()), telemetry=tele_summary)

    def check_stall(self, report: SegmentReport) -> None:
        key = (report.iters, report.tree, report.sol)
        if key == self.last:
            self.stalls += 1
            if self.stalls >= self.stall_limit:
                raise RuntimeError(
                    f"search stalled: no progress across {self.stalls} "
                    f"segments (iters={report.iters}, "
                    f"pool={report.pool_size})")
        else:
            self.stalls = 0
        self.last = key


def _segment_copy(state, rows: int):
    """A device copy of what a segment may change: the live rows
    `[..., :rows]` of each pool, every counter and the telemetry vector
    (a list of them for a worker list)."""
    if isinstance(state, list):
        return [_segment_copy(s, rows) for s in state]
    saved = {f: getattr(state, f)[..., :rows].clone() for f in POOL_FIELDS}
    for f in (*COUNTER_DTYPES, "telemetry"):
        saved[f] = getattr(state, f).clone()
    return saved


def _restore(state, saved) -> None:
    """Copy `_segment_copy`'s tensors back into the same tensors of
    `state` (the addresses a captured graph holds)."""
    if isinstance(state, list):
        for s, sv in zip(state, saved):
            _restore(s, sv)
        return
    for f, x in saved.items():
        dst = getattr(state, f)
        (dst[..., :x.shape[-1]] if f in POOL_FIELDS else dst).copy_(x)


def run_segmented(run_fn, state: SearchState, segment_iters: int = 2048,
                  checkpoint_path: str | None = None,
                  checkpoint_every: int = 1,
                  heartbeat=print, max_segments: int | None = None,
                  max_total_iters: int | None = None,
                  stall_limit: int = 3,
                  raise_on_overflow: bool = True,
                  checkpoint_meta: dict | None = None,
                  post_segment=None,
                  should_stop=None,
                  retry_attempts: int | None = None,
                  retry_base_s: float | None = None,
                  segment_timeout_s: float | None = None,
                  overlap: bool = False,
                  grow_fn=None,
                  stop_pending=None):
    """Drive `run_fn(state, target_total_iters) -> state` to exhaustion in
    bounded segments. `state` is one device's SearchState or a worker list
    (`engine/distributed.py`, whose `_DistDriver.run` is then `run_fn`;
    the reports carry `per_worker`).

    `run_fn` receives a CUMULATIVE iteration ceiling (`device.run(...,
    max_iters=...)`'s semantics), offset by the incoming state's iteration
    count, so resuming from a loaded checkpoint works. `run_fn` may update
    the pool of the state it is given in place, as `device.run` does: the
    incoming state's pool tensors are then the returned state's.

    - checkpoints every `checkpoint_every` segments when a path is given,
      and on every exit;
    - calls `post_segment(state) -> state` after each segment, before the
      report and the checkpoint, so that what it changes (the `-C` host
      session's incumbent merge, `engine/hybrid.HostSession`) lands in
      both and in the next segment's counters;
    - calls `heartbeat(SegmentReport)` after each segment;
    - stops early (after checkpointing) when `should_stop(SegmentReport)`
      returns True;
    - `checkpoint_meta` may be a callable returning the meta dict,
      re-evaluated at every save;
    - raises RuntimeError after `stall_limit` consecutive segments with no
      progress (tree/sol/iters unchanged);
    - on pool overflow raises PoolOverflow (after checkpointing, so the
      state is recoverable) unless `raise_on_overflow=False`, in which
      case the caller must check `state.overflow`.

    Resilience: segment execution, checkpoint writes and the per-segment
    fetch are retried `retry_attempts` times with exponential backoff
    (`retry_base_s * 2^k`) on TRANSIENT_ERRORS only. Before each segment
    (when `retry_attempts > 1`) the live rows, counters and telemetry are
    copied on the device, and copied back into the same tensors before a
    retry, so a retried segment redoes the same work. A
    `segment_timeout_s` watchdog turns a hung segment into SegmentTimeout
    (never retried: kill the process and resume from the checkpoint).
    Defaults read TTS_RETRY_ATTEMPTS (3), TTS_RETRY_BASE_S (0.5) and
    TTS_SEG_TIMEOUT_S (0 = off). Fault injection: utils/faults.py
    (TTS_FAULTS).

    Overlap (`overlap=True`, the pipelined driver; `distributed.search`
    resolves TTS_OVERLAP and supplies the hooks): `run_fn` is then an
    asynchronous dispatch (`_DistDriver.run_async`, which returns a
    `DispatchedStates`; a synchronous `run_fn` also works, without
    overlap), and segment N+1 is dispatched before segment N's counters
    are read, so the heartbeat takes segment N's report while the device
    runs N+1. Checkpoint compression and fsync go to an
    `AsyncCheckpointWriter` thread; a checkpoint segment reads its live
    rows before it dispatches the next one (the one synchronization a
    checkpoint needs). `grow_fn(state) -> state` is the lossless overflow
    recovery; `stop_pending() -> bool` is a stop probe that skips the
    speculative dispatch once a stop was asked for. The exit conditions
    are read one segment later than on the synchronous path, and the
    speculative segment in flight is drained, never dropped (a no-op on an
    empty or overflowed pool), so a stop costs at most one extra segment
    and the totals and every report but its wall-clock fields are the
    synchronous driver's. Overlap does not take `post_segment` (ValueError:
    the host tier's merge changes a state the pipeline has moved past), and
    it cannot retry a segment's execution in place (the next dispatch has
    already rewritten its pools): its retries cover the counter fetch, the
    checkpoint fetch and the writes; a failed segment is recovered from
    the checkpoint.

    In a multi-process job (`mesh.process_count() > 1`) the call makes one
    attempt of everything and runs synchronously: the segment, the fetches
    and the saves hold collectives, and a retry or a speculative dispatch
    on one rank would reorder them against the others."""
    from ..utils import config as _cfg

    if retry_attempts is None:
        retry_attempts = _cfg.env_int("TTS_RETRY_ATTEMPTS")
    if retry_base_s is None:
        retry_base_s = _cfg.env_float("TTS_RETRY_BASE_S")
    if segment_timeout_s is None:
        segment_timeout_s = _cfg.env_float("TTS_SEG_TIMEOUT_S")
    if mesh.process_count() > 1:
        retry_attempts = 1
        overlap = False
    if overlap:
        if post_segment is not None:
            raise ValueError(
                "overlap=True is incompatible with post_segment (the host "
                "tier's merge changes a state the pipeline has moved "
                "past); run the host tier with overlap off")
        return _run_segmented_overlap(
            run_fn, state, segment_iters=segment_iters,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, heartbeat=heartbeat,
            max_segments=max_segments, max_total_iters=max_total_iters,
            stall_limit=stall_limit, raise_on_overflow=raise_on_overflow,
            checkpoint_meta=checkpoint_meta, should_stop=should_stop,
            retry_attempts=retry_attempts, retry_base_s=retry_base_s,
            segment_timeout_s=segment_timeout_s, grow_fn=grow_fn,
            stop_pending=stop_pending)
    from ..obs import audit as obs_audit

    dev = _pool(state).device
    t0 = time.perf_counter()
    seg = 0
    start_iters, live = (int(x.max()) for x in _fetch_fields(
        state, ("iters", "size"), fire=False))
    folder = _ReportFolder(state, t0, stall_limit, start_iters)
    # the time the device waits on the host between segments (heartbeat,
    # checkpoint, stop checks)
    gap_hist = obs_metrics.default().histogram(
        "tts_segment_gap_seconds", GAP_HELP, buckets=GAP_BUCKETS)
    results_ready_t = None

    def meta_now(seg):
        base = checkpoint_meta() if callable(checkpoint_meta) \
            else dict(checkpoint_meta or {})
        return {**base, "segment": seg}

    def do_save(s, seg_no):
        arrays = _retry(
            lambda: save(checkpoint_path, s, meta=meta_now(seg_no)),
            "checkpoint save", retry_attempts, retry_base_s)
        # the audit re-reads the snapshot BEFORE the fault injection
        # below, which may corrupt the file on purpose (on the rank that
        # wrote it)
        if arrays is not None and obs_audit.roundtrip_enabled():
            obs_audit.check_checkpoint_roundtrip(
                checkpoint_path, obs_audit.array_sums(arrays))
        faults.fire("post_checkpoint", segment=seg_no, path=checkpoint_path)

    def final_save(s, seg):
        # every exit leaves a CURRENT checkpoint, also with
        # checkpoint_every > 1
        if checkpoint_path and seg % checkpoint_every != 0:
            do_save(s, seg)

    while True:
        target = start_iters + (seg + 1) * segment_iters
        if max_total_iters is not None:
            target = min(target, start_iters + max_total_iters)
        faults.fire("segment_start", segment=seg + 1)
        prev_state = state
        saved = (_segment_copy(prev_state, live) if retry_attempts > 1
                 else None)
        tries = 0

        def attempt():
            nonlocal tries
            if tries:
                _restore(prev_state, saved)
            tries += 1
            return _with_watchdog(lambda: run_fn(prev_state, target),
                                  segment_timeout_s, f"segment {seg + 1}",
                                  dev)

        if results_ready_t is not None:
            gap_hist.observe(max(0.0, time.monotonic() - results_ready_t))
        with tracelog.span("segment", segment=seg + 1) as seg_span:
            state = _retry(attempt, "segment execution", retry_attempts,
                           retry_base_s)
            saved = None
            if post_segment is not None:
                state = post_segment(state)
            seg += 1
            # ONE transfer of every per-segment scalar (and the telemetry)
            fetched = _retry(
                lambda: _with_watchdog(
                    lambda: _fetch_fields(
                        state, REPORT_FIELDS
                        + (("telemetry",) if folder.tele_w else ())),
                    segment_timeout_s, f"segment {seg} result fetch", dev),
                "per-segment host fetch", retry_attempts, retry_base_s)
            results_ready_t = time.monotonic()
            f_ovf = fetched[6]
            live = int(fetched[3].max())
            seg_span.set(iters=int(fetched[0].max()),
                         tree=int(fetched[1].sum()),
                         sol=int(fetched[2].sum()),
                         pool=int(fetched[3].sum()),
                         best=int(fetched[4].min()))
        # fold AFTER the span closes, so the `segment` span record precedes
        # its search.telemetry event
        report = folder.fold(fetched, seg)
        iters, size = report.iters, report.pool_size
        obs_metrics.default().histogram(
            "tts_segment_seconds",
            "segment wall latency (execute+fetch)").observe(seg_span.dur)
        if heartbeat is not None:
            heartbeat(report)
        if checkpoint_path and seg % checkpoint_every == 0:
            do_save(state, seg)
        # preemption injection point: the END of segment k, after any
        # checkpoint that segment wrote
        faults.fire("post_segment", segment=seg)
        if bool(f_ovf.any()):
            final_save(state, seg)
            if raise_on_overflow:
                hint = (f"resume from {checkpoint_path} with a larger "
                        "capacity" if checkpoint_path else
                        "rerun with a larger capacity, or catch "
                        "PoolOverflow and grow() its .state")
                raise PoolOverflow(
                    f"pool overflow at segment {seg} (pool={size}): search "
                    f"incomplete; {hint}", state)
            return state
        if size == 0:
            final_save(state, seg)
            return state
        if should_stop is not None and should_stop(report):
            final_save(state, seg)
            return state
        folder.check_stall(report)
        if max_segments is not None and seg >= max_segments:
            final_save(state, seg)
            return state
        if (max_total_iters is not None
                and iters >= start_iters + max_total_iters):
            final_save(state, seg)
            return state


def _run_segmented_overlap(run_fn, state, *, segment_iters, checkpoint_path,
                           checkpoint_every, heartbeat, max_segments,
                           max_total_iters, stall_limit, raise_on_overflow,
                           checkpoint_meta, should_stop, retry_attempts,
                           retry_base_s, segment_timeout_s, grow_fn,
                           stop_pending):
    """The pipelined driver behind `run_segmented(overlap=True)` (JAX
    `_run_segmented_overlap`).

    Segment N+1 is dispatched before segment N's counter block is read;
    the heartbeat then takes N's report while the device runs N+1. An exit
    found in N's report drains the segment in flight (a no-op when the
    pool is empty or overflowed: the loop condition on the device checks
    both) instead of dropping it, so the node accounting is the
    synchronous driver's. A checkpoint segment synchronizes only for its
    live-row fetch (`AsyncCheckpointWriter.prepare`), then dispatches, then
    queues the write.

    `segment` spans carry explicit [dispatch, results-ready] times
    (`tracelog.span_at`, `overlapped=True`): consecutive spans overlap in
    wall time exactly when the device ran back to back, which is what
    `tts_segment_gap_seconds` measures."""
    t0 = time.perf_counter()
    seg = 0
    dev = _pool(state).device
    start_iters = int(np.max(_fetch_fields(state, ("iters",),
                                           fire=False)[0]))
    folder = _ReportFolder(state, t0, stall_limit, start_iters)
    reg = obs_metrics.default()
    gap_hist = reg.histogram("tts_segment_gap_seconds", GAP_HELP,
                             buckets=GAP_BUCKETS)
    seg_hist = reg.histogram("tts_segment_seconds",
                             "segment wall latency (execute+fetch)")
    writer = (AsyncCheckpointWriter(retry_attempts=retry_attempts,
                                    retry_base_s=retry_base_s)
              if checkpoint_path else None)
    fields = REPORT_FIELDS + (("telemetry",) if folder.tele_w else ())

    def target_for(k: int) -> int:
        t = start_iters + k * segment_iters
        if max_total_iters is not None:
            t = min(t, start_iters + max_total_iters)
        return t

    def meta_now(seg_no):
        base = checkpoint_meta() if callable(checkpoint_meta) \
            else dict(checkpoint_meta or {})
        return {**base, "segment": seg_no}

    def fetch_counters(cur, seg_no):
        # the only per-segment read on the hot path: the counter block
        # (the pools are read on checkpoint segments only, by prepare())
        return _retry(
            lambda: _with_watchdog(
                lambda: _fetch_fields(cur, fields),
                segment_timeout_s, f"segment {seg_no} result fetch", dev),
            "per-segment host fetch", retry_attempts, retry_base_s)

    try:
        faults.fire("segment_start", segment=1)
        dispatch_t = time.monotonic()
        cur = run_fn(state, target_for(1))
        halting = False
        results_ready_t = None
        while True:
            seg += 1
            this_dispatch_t = dispatch_t
            is_ckpt = bool(checkpoint_path) and seg % checkpoint_every == 0

            def can_speculate():
                return (not halting
                        and (max_segments is None or seg < max_segments)
                        and target_for(seg + 1) > target_for(seg)
                        and not (stop_pending is not None
                                 and stop_pending()))

            spec = spec_t = None
            next_fired = False   # segment_start fired for seg + 1 yet?
            if not is_ckpt and can_speculate():
                faults.fire("segment_start", segment=seg + 1)
                next_fired = True
                spec_t = time.monotonic()
                spec = run_fn(cur, target_for(seg + 1))

            fetched = fetch_counters(cur, seg)
            prev_ready_t = results_ready_t
            results_ready_t = time.monotonic()
            f_ovf = fetched[6]

            # lossless overflow recovery: the speculative segment was a
            # no-op on the overflow flag, so adopt it, grow every pool and
            # run the same segment target again from where the loop stopped
            while bool(f_ovf.any()) and grow_fn is not None:
                if spec is not None:
                    cur, spec = spec, None
                cur = run_fn(grow_fn(cur), target_for(seg))
                fetched = fetch_counters(cur, seg)
                results_ready_t = time.monotonic()
                f_ovf = fetched[6]

            if is_ckpt:
                # the live rows are read before the next dispatch rewrites
                # the pools: prepare() here, then dispatch, then hand the
                # compression and fsync to the writer (enqueue may block on
                # the queue's bound while the device already runs)
                task = _retry(
                    lambda: _with_watchdog(
                        lambda: writer.prepare(checkpoint_path, cur,
                                               meta_now(seg), segment=seg),
                        segment_timeout_s,
                        f"segment {seg} checkpoint fetch", dev),
                    "checkpoint state fetch", retry_attempts, retry_base_s)
                if can_speculate():
                    faults.fire("segment_start", segment=seg + 1)
                    next_fired = True
                    spec_t = time.monotonic()
                    spec = run_fn(cur, target_for(seg + 1))
                writer.enqueue(task)

            tracelog.span_at("segment", this_dispatch_t, results_ready_t,
                             segment=seg, iters=int(fetched[0].max()),
                             tree=int(fetched[1].sum()),
                             sol=int(fetched[2].sum()),
                             pool=int(fetched[3].sum()),
                             best=int(fetched[4].min()), overlapped=True)
            if prev_ready_t is not None:
                gap_hist.observe(max(0.0, this_dispatch_t - prev_ready_t))
            seg_hist.observe(max(results_ready_t - this_dispatch_t, 0.0))
            report = folder.fold(fetched, seg)
            if heartbeat is not None:
                heartbeat(report)
            faults.fire("post_segment", segment=seg)

            overflow_exit = bool(f_ovf.any())
            exit_now = halting or overflow_exit or report.pool_size == 0
            if not exit_now and should_stop is not None \
                    and should_stop(report):
                exit_now = True
            if not exit_now and max_segments is not None \
                    and seg >= max_segments:
                exit_now = True
            if not exit_now and max_total_iters is not None \
                    and report.iters >= start_iters + max_total_iters:
                exit_now = True
            if exit_now:
                if spec is not None:
                    # drain the speculative segment first: a no-op on an
                    # empty or overflowed pool, one segment of extra work
                    # on a stop; its output is the state this exit keeps
                    halting = True
                    cur, dispatch_t = spec, spec_t
                    continue
                if checkpoint_path and seg % checkpoint_every != 0:
                    writer.submit(checkpoint_path, cur, meta_now(seg),
                                  segment=seg)
                if writer is not None:
                    writer.drain()
                if overflow_exit and raise_on_overflow:
                    hint = (f"resume from {checkpoint_path} with a larger "
                            "capacity" if checkpoint_path else
                            "rerun with a larger capacity, or catch "
                            "PoolOverflow and grow() its .state")
                    raise PoolOverflow(
                        f"pool overflow at segment {seg} "
                        f"(pool={report.pool_size}): search incomplete; "
                        f"{hint}", cur)
                return cur
            folder.check_stall(report)
            if spec is not None:
                cur, dispatch_t = spec, spec_t
            else:
                if not next_fired:
                    # a speculation dropped by the overflow recovery
                    # already fired this segment's injection point
                    faults.fire("segment_start", segment=seg + 1)
                dispatch_t = time.monotonic()
                cur = run_fn(cur, target_for(seg + 1))
    finally:
        if writer is not None:
            # the success paths drained above; on an exception's way out a
            # writer error must not hide the first one
            writer.close(raise_pending=False)
            tracelog.event("checkpoint.writer",
                           peak_pending=writer.peak_pending)
