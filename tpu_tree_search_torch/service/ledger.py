"""Durable write-ahead request ledger: crash-safe serving state.

Reproduces `tpu_tree_search/service/ledger.py` (`LedgerState` with every
`_apply_*` and `to_records`, `RequestLedger` with `journal`, replay,
truncation, quarantine, compaction, the fence, `lag_s`, `snapshot` and
`close`). Each record's line is JAX's, byte for byte (`_canonical`,
`_line`): under the same clock the same journal calls give the same
segment files, and either package replays the other's ledger. Stdlib only.

The checkpoint layer makes a request's search state durable; this journal
makes the server's own state durable: an append-only JSONL record of every
request **state transition** (admit, dispatch, budget heartbeat, preempt,
release, exclusion, failure, quarantine/readmit, admission pause/resume,
terminal) that a restarted server replays at boot.

- Every record is one JSON line wrapped with a CRC32 stamp over its
  canonical serialization: a torn or garbled line is detected, never half
  applied.
- `journal()` writes, flushes and fsyncs before it returns, so an
  acknowledgement built on it is a durability promise.
- Segments rotate at a record bound and rotation COMPACTS: the new segment
  starts with absolute-state records (one ``restore`` per live request,
  explicit pause and quarantine state), then the older segments are
  deleted. The new segment is complete and fsync'd before any old one is
  removed, ``restore`` and ``*_state`` records overwrite rather than
  accumulate, and aged-out terminals get ``forget`` tombstones, so a crash
  between the two steps replays to the same state.
- On replay a corrupt record truncates the ledger to the last good record:
  the torn segment is cut at its last good byte and any later segment is
  quarantined ``*.corrupt`` (counted, never applied).

What replay yields (:class:`LedgerState`): every request keyed by id with
its spool payload, tag, cumulative ``spent_s``, dispatch, preemption and
failure counters, ``failure_log``, excluded submeshes and, for terminal
requests, the recorded terminal snapshot (what a re-submitted duplicate tag
is served); plus the standing submesh quarantines and the admission pause.

Per-request ``faults`` specs are journaled but STRIPPED on re-admission (a
kill drill must not follow the request across the restart it exists to
prove), and terminal snapshots age out of the compacted ledger beyond
``terminal_keep`` entries (live requests never do).

Observability: ``tts_ledger_{records,replayed,truncated}_total`` counters
when a registry is given, ``ledger.*`` flight-recorder events, and
:meth:`snapshot` under ``status_snapshot()``'s ``ledger`` key.
"""

from __future__ import annotations

import json
import os
import pathlib
import threading
import time
import zlib

from ..obs import tracelog
from .lease import LeaseLost

__all__ = ["RequestLedger", "LedgerState", "FAILURE_LOG_CAP"]

SEGMENT_PREFIX = "seg-"
SEGMENT_SUFFIX = ".jsonl"
QUARANTINE_SUFFIX = ".corrupt"

SEGMENT_RECORDS_DEFAULT = 4096   # records per segment before rotation
TERMINAL_KEEP_DEFAULT = 4096     # terminal snapshots kept through
#                                  compaction (the idempotent re-serve
#                                  window; live requests never age out)
FAILURE_LOG_CAP = 32             # mirrors request.FAILURE_LOG_CAP
#                                  (kept local: stdlib-only module)


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


class LedgerState:
    """The replayed (and live-mirrored) serving state.

    ``requests`` maps request id -> a JSON-safe entry dict; the server's
    replay pass turns non-terminal entries back into queued
    RequestRecords and terminal entries into idempotently re-servable
    records. The ledger keeps this mirror updated on every append so
    compaction can emit absolute state without asking the server.
    """

    def __init__(self):
        self.boots = 0
        self.paused: str | None = None
        self.quarantined: dict[int, str] = {}
        self.requests: dict[str, dict] = {}
        # lease-fencing epoch (failover): the highest epoch stamp seen.
        # Records stamped with a LOWER epoch are a fenced-out owner's
        # stale appends and are discarded on apply — the split-brain
        # fence lives in the data, not in timing
        self.epoch = 0
        self.fenced_discards = 0
        self.takeovers = 0
        # True while the last journaled lifetime ended with a graceful
        # `drain` marker; a boot record clears it. At replay this says
        # whether the PRIOR lifetime drained cleanly or died hard —
        # surfaced in snapshot()["last_shutdown"]
        self.clean_shutdown = False

    # ------------------------------------------------------------ apply

    def apply(self, rec: dict) -> None:
        """Fold one record in. Unknown kinds are ignored (forward
        compatibility: an old binary replaying a newer ledger must not
        die on a record it does not understand). Records carrying an
        epoch stamp ``"e"`` below the current fencing epoch are a stale
        owner's post-takeover appends: discarded (counted), on this
        replay and every future one."""
        e = rec.get("e")
        if isinstance(e, int):
            if e < self.epoch:
                self.fenced_discards += 1
                return
            self.epoch = e
        kind = rec.get("k")
        fn = getattr(self, f"_apply_{kind}", None)
        if fn is not None:
            fn(rec)

    def _entry(self, rec: dict) -> dict | None:
        return self.requests.get(rec.get("rid"))

    def _apply_boot(self, rec: dict) -> None:
        self.boots += 1
        self.clean_shutdown = False

    def _apply_boots(self, rec: dict) -> None:
        # compaction's absolute form: SET, don't add — after a crash
        # between compaction and old-segment deletion the old boot
        # records replay first and must not double-count
        self.boots = max(self.boots, int(rec.get("n", 0)))
        self.clean_shutdown = bool(rec.get("clean",
                                           self.clean_shutdown))

    def _apply_drain(self, rec: dict) -> None:
        self.clean_shutdown = True

    def _apply_forget(self, rec: dict) -> None:
        # compaction's aged-out-terminal tombstone: without it, a crash
        # between the new segment's fsync and the old segments' unlink
        # would replay the old admit/terminal records and resurrect
        # entries the compaction dropped
        self.requests.pop(rec.get("rid"), None)

    def _apply_admit(self, rec: dict) -> None:
        self.requests[rec["rid"]] = {
            "rid": rec["rid"], "tag": rec.get("tag"),
            "seq": int(rec.get("seq", 0)),
            "payload": rec.get("payload") or {},
            "spool_id": rec.get("spool_id"),
            "state": "QUEUED", "hold": False,
            "spent_s": float(rec.get("spent_s", 0.0)),
            "dispatches": 0, "preemptions": 0, "failures": 0,
            "submesh": None, "failure_log": [], "excluded": [],
            "terminal": None, "error": None,
            # accounting + failover lineage: the tenant label and (on
            # an adoption re-admit) the rid/ledger-dir this request
            # held under its dead owner — carried through compaction's
            # restore records verbatim so the flight recorder can
            # stitch one journey across the takeover
            "tenant": rec.get("tenant") or "-",
            "origin_rid": rec.get("origin_rid"),
            "origin_owner": rec.get("origin_owner"),
        }

    def _apply_dispatch(self, rec: dict) -> None:
        e = self._entry(rec)
        if e is None:
            return
        e["state"] = "RUNNING"
        e["submesh"] = rec.get("submesh")
        e["dispatches"] = int(rec.get("dispatch", e["dispatches"] + 1))

    def _apply_budget(self, rec: dict) -> None:
        e = self._entry(rec)
        if e is not None:
            e["spent_s"] = max(e["spent_s"],
                               float(rec.get("spent_s", 0.0)))

    def _apply_preempt(self, rec: dict) -> None:
        e = self._entry(rec)
        if e is None:
            return
        e["hold"] = bool(rec.get("hold"))
        e["state"] = "PREEMPTED" if e["hold"] else "QUEUED"
        e["preemptions"] = int(rec.get("preemptions",
                                       e["preemptions"] + 1))
        e["spent_s"] = max(e["spent_s"], float(rec.get("spent_s", 0.0)))

    def _apply_failure(self, rec: dict) -> None:
        e = self._entry(rec)
        if e is None:
            return
        e["failure_log"].append(
            {"t": rec.get("t"), "submesh": rec.get("submesh"),
             "attempt": rec.get("attempt"), "error": rec.get("error")})
        del e["failure_log"][:-FAILURE_LOG_CAP]
        e["failures"] = int(rec.get("failures", e["failures"] + 1))
        e["spent_s"] = max(e["spent_s"], float(rec.get("spent_s", 0.0)))
        e["error"] = rec.get("error")
        e["state"] = "QUEUED"    # a terminal record follows if it died

    def _apply_release(self, rec: dict) -> None:
        # operator release of a held preemption: back in line
        e = self._entry(rec)
        if e is not None and e.get("terminal") is None:
            e["hold"] = False
            e["state"] = "QUEUED"

    def _apply_exclude(self, rec: dict) -> None:
        e = self._entry(rec)
        if e is not None:
            # absolute form (add_exclusion can also RESET the set at
            # the everywhere-excluded cap, so a relative append would
            # replay wrong)
            e["excluded"] = sorted(int(s) for s in
                                   rec.get("excluded", []))

    def _apply_terminal(self, rec: dict) -> None:
        e = self._entry(rec)
        if e is None:
            return
        e["state"] = rec.get("state", "DONE")
        e["terminal"] = rec.get("snapshot") or {}
        e["error"] = e["terminal"].get("error")
        e["spent_s"] = max(e["spent_s"],
                           float(e["terminal"].get("spent_s") or 0.0))

    def _apply_portfolio(self, rec: dict) -> None:
        """Parent -> member linkage of a portfolio race
        (service/portfolio). Stamped onto the ENTRIES (parent gets the
        member list, each member a back-pointer + its raced config), so
        the linkage rides compaction for free — `_apply_restore`
        carries entry dicts verbatim."""
        e = self._entry(rec)
        if e is None:
            return
        members = [dict(m) for m in rec.get("members") or []]
        e["portfolio_members"] = members
        for m in members:
            me = self.requests.get(m.get("rid") or "")
            if me is not None:
                me["portfolio_parent"] = rec["rid"]
                me["portfolio_config"] = m.get("config")

    def _apply_quarantine(self, rec: dict) -> None:
        self.quarantined[int(rec["submesh"])] = str(
            rec.get("reason") or "")

    def _apply_readmit(self, rec: dict) -> None:
        self.quarantined.pop(int(rec["submesh"]), None)

    def _apply_quarantine_state(self, rec: dict) -> None:
        self.quarantined = {int(k): str(v) for k, v in
                            (rec.get("submeshes") or {}).items()}

    def _apply_pause(self, rec: dict) -> None:
        self.paused = str(rec.get("reason") or "paused")

    def _apply_resume(self, rec: dict) -> None:
        self.paused = None

    def _apply_pause_state(self, rec: dict) -> None:
        self.paused = rec.get("reason")

    def _apply_takeover(self, rec: dict) -> None:
        # the durable fence line a peer journals when it adopts this
        # ledger: the epoch ratchet itself happened in apply() — this
        # handler just keeps the count for snapshot()
        self.takeovers += 1

    def _apply_restore(self, rec: dict) -> None:
        e = dict(rec.get("entry") or {})
        if e.get("rid"):
            self.requests[e["rid"]] = e

    # ------------------------------------------------------- compaction

    def to_records(self, terminal_keep: int = TERMINAL_KEEP_DEFAULT
                   ) -> list[dict]:
        """Absolute-state records reconstructing this state exactly —
        what compaction writes at the head of a fresh segment. Live
        (non-terminal) requests are all kept; terminal snapshots keep
        only the newest `terminal_keep` (the bounded idempotency
        window)."""
        out: list[dict] = []
        if self.epoch:
            # the fencing epoch must survive compaction: without this
            # head record a rotation would forget the fence and a stale
            # owner's discarded appends could replay on the next boot
            out.append({"k": "epoch", "e": self.epoch})
        out.append({"k": "boots", "n": self.boots,
                    "clean": self.clean_shutdown})
        out.extend([{"k": "pause_state", "reason": self.paused},
                    {"k": "quarantine_state",
                     "submeshes": {str(k): v for k, v in
                                   self.quarantined.items()}}])
        entries = sorted(self.requests.values(),
                         key=lambda e: e.get("seq", 0))
        terminal = [e for e in entries if e.get("terminal") is not None]
        if terminal_keep < 0:
            drop: set = set()
        else:
            # [:-0] would slice to [], silently keeping everything —
            # keep=0 must mean "no idempotency window", so spell the
            # kept tail explicitly
            keep = terminal[-terminal_keep:] if terminal_keep else []
            drop = {e["rid"] for e in terminal} - {e["rid"]
                                                   for e in keep}
        out.extend({"k": "restore", "entry": e} for e in entries
                   if e["rid"] not in drop)
        # tombstones for the aged-out terminals: a crash between this
        # segment's fsync and the old segments' unlink replays the old
        # history first, and these are what keep the dropped entries
        # dropped (the documented replays-to-the-same-state invariant)
        out.extend({"k": "forget", "rid": rid} for rid in sorted(drop))
        return out


class RequestLedger:
    """One serving process's durable journal (see module docstring).

    Constructing it REPLAYS any existing ledger in `root` into
    ``self.state`` (read ``state`` / ``replayed`` / ``truncated``
    before appending this lifetime's records). An unusable directory
    raises: the caller asked for durability, and a ledger that silently
    degraded would turn an acknowledged admission into a lie.
    """

    def __init__(self, root: str | os.PathLike, registry=None,
                 segment_records: int = SEGMENT_RECORDS_DEFAULT,
                 terminal_keep: int = TERMINAL_KEEP_DEFAULT,
                 fsync: bool = True, lease=None, on_fenced=None):
        self._lease = lease         # LeaseKeeper fencing this ledger's
        #                             appends (None = single-host mode,
        #                             no epoch stamps)
        self._on_fenced = on_fenced  # fired once, outside the lock
        self.fenced = False
        self.fence_reason: str | None = None
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.segment_records = max(2, int(segment_records))
        self.terminal_keep = int(terminal_keep)
        self.fsync = fsync
        self._lock = threading.Lock()
        self._fh = None                 # guarded-by: self._lock
        self._seg_index = 0             # guarded-by: self._lock
        self._seg_records = 0           # guarded-by: self._lock
        self._rotate_at = self.segment_records  # guarded-by: self._lock
        self._closed = False            # guarded-by: self._lock
        self._last_append_t: float | None = None
        self.state = LedgerState()
        self._prior_clean = False   # the replayed clean_shutdown flag,
        #                             captured before this lifetime's
        #                             boot record clears it
        self._prior_boots = 0       # boots replayed (0 = fresh ledger)
        self.records = 0                # appended this lifetime
        self.replayed = 0               # good records replayed at boot
        self.truncated = 0              # corrupt-tail records discarded
        self.quarantined_segments = 0   # whole segments set aside
        self.compactions = 0
        self.write_errors = 0           # failed appends (durability
        #                                 degraded, loudly — see
        #                                 journal())
        self._m_records = self._m_replayed = self._m_truncated = None
        self._m_errors = None
        if registry is not None:
            self._m_records = registry.counter(
                "tts_ledger_records_total",
                "request-ledger records appended (fsync'd) by kind")
            self._m_replayed = registry.counter(
                "tts_ledger_replayed_total",
                "ledger records replayed at boot")
            self._m_truncated = registry.counter(
                "tts_ledger_truncated_total",
                "corrupt-tail ledger records discarded at replay")
            self._m_errors = registry.counter(
                "tts_ledger_errors_total",
                "failed ledger appends (ENOSPC/IO) — crash-durability "
                "degraded until the disk recovers")
        self._replay()

    # ----------------------------------------------------------- replay

    def _segments(self) -> list[pathlib.Path]:
        return sorted(p for p in self.root.iterdir()
                      if p.name.startswith(SEGMENT_PREFIX)
                      and p.name.endswith(SEGMENT_SUFFIX))

    def _replay(self) -> None:
        segments = self._segments()
        corrupt_at: tuple[pathlib.Path, int] | None = None
        for i, seg in enumerate(segments):
            if corrupt_at is not None:
                # everything after the first corruption is suspect —
                # a later segment was written after bytes this replay
                # refused; set it aside rather than apply history with
                # a hole in it
                self._quarantine_segment(seg)
                continue
            data = seg.read_bytes()
            pos = good_end = 0
            while pos < len(data):
                nl = data.find(b"\n", pos)
                raw, nxt = ((data[pos:], len(data)) if nl < 0
                            else (data[pos:nl], nl + 1))
                if raw:
                    rec = _parse_line(raw)
                    if rec is None:
                        corrupt_at = (seg, good_end)
                        break
                    self.state.apply(rec)
                    self.replayed += 1
                pos = good_end = nxt
            if corrupt_at is None:
                continue
            # count every discarded line in the torn region
            bad = [ln for ln in data[good_end:].split(b"\n") if ln]
            self.truncated += len(bad)
            self._truncate_segment(seg, good_end)
        if self._m_replayed is not None and self.replayed:
            self._m_replayed.inc(self.replayed)
        if self._m_truncated is not None and self.truncated:
            self._m_truncated.inc(self.truncated)
        segments = self._segments()
        if segments:
            last = segments[-1]
            with self._lock:
                self._seg_index = int(
                    last.name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)])
                self._seg_records = sum(
                    1 for ln in last.read_bytes().split(b"\n") if ln)
        self._prior_clean = self.state.clean_shutdown
        self._prior_boots = self.state.boots
        if self.replayed or self.truncated:
            tracelog.event("ledger.replay", dir=str(self.root),
                           replayed=self.replayed,
                           truncated=self.truncated,
                           quarantined_segments=self.quarantined_segments,
                           boots=self.state.boots,
                           prior_shutdown=("clean" if self._prior_clean
                                           else "crash"),
                           requests=len(self.state.requests))

    def _truncate_segment(self, seg: pathlib.Path, offset: int) -> None:
        """Cut the torn tail off in place (best effort: a read-only
        ledger still replays its good prefix)."""
        try:
            with open(seg, "r+b") as f:
                f.truncate(offset)
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:
            tracelog.event("ledger.truncate_failed", path=seg.name,
                           error=repr(e))
        else:
            tracelog.event("ledger.truncated", path=seg.name,
                           offset=offset, discarded=self.truncated)

    def _quarantine_segment(self, seg: pathlib.Path) -> None:
        self.quarantined_segments += 1
        try:
            os.replace(seg, str(seg) + QUARANTINE_SUFFIX)
        except OSError:
            pass
        tracelog.event("ledger.segment_quarantined", path=seg.name)

    # ----------------------------------------------------------- append

    def _seg_path(self, index: int) -> pathlib.Path:
        return self.root / f"{SEGMENT_PREFIX}{index:08d}{SEGMENT_SUFFIX}"

    def _open_active(self) -> None:   # holds: self._lock
        if self._fh is None:
            if self._seg_index == 0:
                self._seg_index = 1
            self._fh = open(self._seg_path(self._seg_index), "ab")

    def _write(self, data: bytes) -> None:
        self._fh.write(data)
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())

    def journal(self, kind: str, **fields) -> None:
        """Journal one record durably (fsync'd before returning) and
        fold it into the live state mirror. A no-op after close() —
        late executor-thread records on a non-waiting shutdown lose
        only their journaling.

        A write/fsync error (ENOSPC, a failing mount) does NOT raise:
        raising out of the server's lifecycle paths would hang
        `result()` waiters mid-_finalize or strand an already-admitted
        request unacknowledged — worse than the durability gap itself.
        Instead the record is still applied to the live mirror and the
        failure is surfaced three ways (`ledger.write_error` event,
        `tts_ledger_errors_total`, `write_errors` in snapshot: the
        durability promise is degraded until the disk recovers).

        Under a lease (fleet mode) every record is stamped with the
        owner's fencing epoch, and a lost lease FENCES the ledger: the
        record is neither written nor applied, every later journal is a
        no-op (zero commits by construction), and ``on_fenced`` fires
        once. Fencing does not raise here for the same reason write
        errors don't — the typed ``LeaseLost`` surfaces on the admission
        and checkpoint paths instead."""
        rec = {"k": kind, "t": time.time(), **fields}
        if self._lease is not None:
            if self.fenced:
                return
            try:
                self._lease.check()
            except LeaseLost as e:
                self._fence(str(e) or "lease lost", kind)
                return
            rec["e"] = self._lease.epoch
        compacted = error = None
        with self._lock:
            if self._closed:
                return
            try:
                self._open_active()
                self._write(_line(rec))
                self._seg_records += 1
                self._last_append_t = time.monotonic()
            except OSError as e:
                error = repr(e)
                self.write_errors += 1
            # the live mirror stays correct either way — this lifetime
            # keeps serving accurately; only crash-durability degrades
            self.state.apply(rec)
            self.records += 1
            if error is None and self._seg_records >= self._rotate_at:
                try:
                    compacted = self._compact_locked()
                except OSError as e:
                    error = f"compaction: {e!r}"
                    self.write_errors += 1
        if compacted is not None:
            # emitted OUTSIDE the ledger lock: the recorder has its own
            # lock and the two must never nest in both orders
            tracelog.event("ledger.compacted", **compacted)
        if error is not None:
            if self._m_errors is not None:
                self._m_errors.inc()
            tracelog.event("ledger.write_error", kind=kind, error=error)
        if self._m_records is not None:
            self._m_records.inc(kind=kind)

    def _fence(self, reason: str, kind: str) -> None:
        """Mark the ledger fenced (idempotent) and fire `on_fenced`
        once. After this every journal() is a no-op: a fenced-out
        stale owner commits NOTHING, by construction."""
        with self._lock:
            if self.fenced:
                return
            self.fenced = True
            self.fence_reason = reason
        tracelog.event("ledger.fenced", dir=str(self.root),
                       kind=kind, reason=reason)
        if self._on_fenced is not None:
            try:
                self._on_fenced(reason)
            except Exception as e:  # noqa: BLE001 — journal never raises
                tracelog.event("ledger.fence_callback_error",
                               error=repr(e))

    def _compact_locked(self) -> dict:   # holds: self._lock
        """Rotate to a fresh segment seeded with absolute state, then
        delete the old ones (caller holds the lock; returns the event
        payload the caller emits after releasing it). Crash-safe: the
        new segment is complete and fsync'd before anything is removed,
        and its records overwrite rather than accumulate on replay.

        Deliberately SYNCHRONOUS: the rewrite is bounded by live state
        (live requests + the terminal_keep window + tombstones), not by
        segment size, and the `_rotate_at` doubling keeps it rare. The
        event's `seconds` field is the observed stall; if a fleet's
        live state ever makes it hurt, a double-buffered background
        compactor is the follow-on — not worth the swap-in complexity
        until a measurement says so."""
        t0 = time.monotonic()
        old = self._segments()
        self._seg_index += 1
        new_path = self._seg_path(self._seg_index)
        # unique temp + atomic rename: a peer scanning the directory
        # mid-compaction (FailoverWatcher, an adopting survivor) sees
        # either the old segment set or the complete new segment, never
        # a torn half-written one (`_segments` skips dot-temp names)
        tmp = new_path.with_name(
            f".{new_path.name}.{os.getpid()}-{threading.get_ident()}.tmp")
        stamp = ({} if self._lease is None or self.fenced
                 else {"e": self._lease.epoch})
        try:
            with open(tmp, "wb") as f:
                n = 0
                for rec in self.state.to_records(self.terminal_keep):
                    f.write(_line({"t": time.time(), **stamp, **rec}))
                    n += 1
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, new_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._fsync_dir()
        if self._fh is not None:
            self._fh.close()
        self._fh = open(new_path, "ab")
        self._seg_records = n
        # a big live state compacts into a big segment: require real
        # headroom before the next rotation, or a state whose size
        # rivals the bound would re-compact on nearly every append
        self._rotate_at = max(self.segment_records, 2 * n)
        for seg in old:
            if seg != new_path:
                try:
                    os.unlink(seg)
                except OSError:
                    pass
        self._fsync_dir()
        self.compactions += 1
        # aged-out terminals leave the live mirror too, or the NEXT
        # compaction would resurrect them from state
        dropped = len(self.state.requests)
        self.state = self._reload_state(new_path)
        dropped -= len(self.state.requests)
        return {"segment": new_path.name, "records": n,
                "dropped_terminals": max(dropped, 0),
                "old_segments": len(old),
                "seconds": round(time.monotonic() - t0, 4)}

    @staticmethod
    def _reload_state(path: pathlib.Path) -> LedgerState:
        state = LedgerState()
        for raw in path.read_bytes().split(b"\n"):
            if raw:
                rec = _parse_line(raw)
                if rec is not None:
                    state.apply(rec)
        return state

    def _fsync_dir(self) -> None:
        try:
            fd = os.open(self.root, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass    # platform without dir fsync: the entry fsyncs stand

    # ------------------------------------------------------------ misc

    def lag_s(self) -> float | None:
        """Seconds since the last durable append (None before any):
        how far behind the journal could be at worst if the process died
        right now."""
        t = self._last_append_t
        return None if t is None else round(time.monotonic() - t, 3)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._fh is not None:
                try:
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                except OSError:
                    pass
                self._fh.close()
                self._fh = None

    def snapshot(self) -> dict:
        """JSON-safe stats for status_snapshot()'s `ledger` key."""
        with self._lock:
            extra = {}
            if (self._lease is not None or self.state.epoch
                    or self.state.fenced_discards):
                extra = {"epoch": self.state.epoch,
                         "fenced": self.fenced,
                         "fence_reason": self.fence_reason,
                         "fenced_discards": self.state.fenced_discards,
                         "takeovers": self.state.takeovers}
            return {"dir": str(self.root),
                    **extra,
                    "records": self.records,
                    "replayed": self.replayed,
                    "truncated": self.truncated,
                    "write_errors": self.write_errors,
                    "quarantined_segments": self.quarantined_segments,
                    "compactions": self.compactions,
                    "restarts": self.state.boots - 1
                    if self.state.boots else 0,
                    # what the replay said about the PRIOR lifetime
                    # (None on a fresh ledger): "clean" = it drained,
                    # "crash" = it died without the drain marker
                    "last_shutdown": (None if self._prior_boots == 0
                                      else ("clean"
                                            if self._prior_clean
                                            else "crash")),
                    "lag_s": self.lag_s()}
