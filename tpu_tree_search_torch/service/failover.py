"""Fleet failover: watch peer ledger leases, adopt the expired ones.

Reproduces `tpu_tree_search/service/failover.py` (`FailoverWatcher`: the
scan, the takeover, the bounded ``actions`` journal, `ACTIONS_CAP`,
``tts_takeovers_total{outcome}`` and `snapshot()`). Stdlib only.

The request ledger makes an admission durable across one server's
lifetimes; at fleet scale the host itself is what dies. So every peer runs
a :class:`FailoverWatcher` that scans a shared fleet root
(``TTS_FLEET_DIR``, one subdirectory per server's ledger) for leases
(`service/lease.py`) that EXPIRED without being released, and runs the
takeover protocol:

1. **CAS the epoch**: ``LeaseKeeper.takeover`` claims exactly
   ``current_epoch + 1`` through an O_EXCL claim file; two peers racing
   one expired lease get exactly one adopter, the loser backs off.
2. **Adopt**: ``SearchServer.adopt_ledger`` replays the orphan through the
   ledger's boot path (truncation to the last good record included),
   admits its QUEUED/ACTIVE requests again on the survivor with budgets,
   exclusions and spool ids intact, serves DONE tags again without a
   solve, and journals ``forget`` tombstones into the orphan so a
   rebooted original owner replays an empty live set.
3. **Hold the lease**: the adopter keeps renewing the orphan's lease, so a
   stale original owner that restarts finds a LIVE foreign lease and
   boots fenced, and no second peer adopts again.

The watcher always runs when a fleet dir is configured, but the DEFAULT
(``TTS_FAILOVER`` unset) is **observe-only**: peer-down detection,
journaling and metrics happen, no takeover executes, and the server
behaves exactly as a server without a watcher. ``TTS_FAILOVER=1`` arms
the takeover path.

Observability: ``failover.peer_down`` and ``failover.adopted`` trace
events, ``tts_takeovers_total{outcome}``, the bounded ``actions``
journal, and :meth:`snapshot` under ``status_snapshot()``'s ``failover``
key (the health layer's ``peer_down`` rule reads the per-peer lease
ages).
"""

from __future__ import annotations

import pathlib
import threading
import time

from ..obs import tracelog
from ..utils import config as cfg
from . import lease as lease_mod
from .ledger import SEGMENT_PREFIX, SEGMENT_SUFFIX

__all__ = ["FailoverWatcher"]

ACTIONS_CAP = 64    # bounded action journal (the remediation cap)


def _has_segments(d: pathlib.Path) -> bool:
    try:
        return any(p.name.startswith(SEGMENT_PREFIX)
                   and p.name.endswith(SEGMENT_SUFFIX)
                   for p in d.iterdir())
    except OSError:
        return False


class FailoverWatcher:
    """One peer's scanner over the shared fleet root (see module
    docstring). ``act=None`` resolves ``TTS_FAILOVER`` (default:
    observe-only). The scan period defaults to TTL/2 so an expired
    lease is noticed — and, armed, adopted — inside 2x the TTL."""

    def __init__(self, server, fleet_dir, own_root=None,
                 act: bool | None = None,
                 scan_period_s: float | None = None, registry=None):
        self.server = server
        self.fleet_dir = pathlib.Path(fleet_dir)
        self.own_root = (pathlib.Path(own_root).resolve()
                         if own_root else None)
        self.act = bool(cfg.env_flag(cfg.FAILOVER_FLAG)
                        if act is None else act)
        ttl = cfg.env_float("TTS_LEASE_TTL_S")
        self.scan_period_s = float(
            scan_period_s if scan_period_s is not None
            else max(ttl / 2.0, 0.05))
        self.scans = 0              # guarded-by: self._lock
        self.takeovers = 0          # guarded-by: self._lock
        self.observed = 0           # guarded-by: self._lock
        self.errors = 0             # guarded-by: self._lock
        self.actions: list[dict] = []     # guarded-by: self._lock
        self.peers: list[dict] = []   # last scan — guarded-by: self._lock
        # (dir, epoch) pairs already acted on / observed: one action
        # per expired incarnation, not one per scan tick
        self._noted: set[tuple[str, int]] = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._takeovers_c = None
        if registry is not None:
            self._takeovers_c = registry.counter(
                "tts_takeovers_total",
                "expired peer leases handled by the FailoverWatcher, "
                "by outcome (adopted|observed|lost_race|error)")

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="tts-failover-watcher", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.scan_period_s):
            try:
                self.scan_once()
            except Exception as e:  # noqa: BLE001 — the watcher is a
                # resilience daemon; one bad scan must not kill it
                tracelog.event("failover.scan_error", error=repr(e))

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)

    # --------------------------------------------------------------- scan

    def scan_once(self) -> list[dict]:
        """One sweep of the fleet root. Returns (and retains, for
        snapshot/health) the per-peer lease view; expired unreleased
        leases trigger the peer-down path."""
        peers: list[dict] = []
        try:
            subdirs = sorted(p for p in self.fleet_dir.iterdir()
                             if p.is_dir())
        except OSError as e:
            tracelog.event("failover.fleet_dir_error",
                           dir=str(self.fleet_dir), error=repr(e))
            subdirs = []
        for d in subdirs:
            try:
                if self.own_root is not None \
                        and d.resolve() == self.own_root:
                    continue
            except OSError:
                continue
            info = lease_mod.read_lease(d)
            if info is None:
                # a ledger directory with segments but no lease is a
                # single-server ledger: surfaced, never adopted —
                # without an epoch to CAS there is no safe takeover
                if _has_segments(d):
                    peers.append({"dir": str(d), "owner": None,
                                  "epoch": None, "age_s": None,
                                  "released": False, "expired": False,
                                  "leaseless": True})
                continue
            expired = info.expired()
            peers.append({"dir": str(d), "owner": info.owner,
                          "epoch": info.epoch,
                          "age_s": round(info.age_s(), 3),
                          "ttl_s": info.ttl_s,
                          "released": info.released,
                          "expired": expired})
            if expired and not info.released:
                self._peer_down(d, info)
        with self._lock:
            self.peers = peers
            self.scans += 1
        return peers

    def _peer_down(self, d: pathlib.Path, info) -> None:
        key = (str(d), info.epoch)
        with self._lock:
            if key in self._noted:
                return
            self._noted.add(key)
        tracelog.event("failover.peer_down", dir=str(d),
                       owner=info.owner, epoch=info.epoch,
                       age_s=round(info.age_s(), 3),
                       mode="act" if self.act else "observe")
        if not self.act:
            # observe-only (the default): the detection is journaled,
            # the action is not taken — the TTS_REMEDIATE discipline
            self._record(d, info, "observed", None)
            return
        try:
            result = self.server.adopt_ledger(
                str(d), current_epoch=info.epoch)
            outcome = result.get("outcome", "error")
            detail = {k: v for k, v in result.items() if k != "outcome"}
        except Exception as e:  # noqa: BLE001 — a failed takeover must
            # not kill the watcher; retry on the next expiry observation
            outcome, detail = "error", {"error": repr(e)}
            with self._lock:
                # un-note so the next scan retries this incarnation
                self._noted.discard(key)
        self._record(d, info, outcome, detail)

    def _record(self, d: pathlib.Path, info, outcome: str,
                detail: dict | None) -> None:
        action = {"t": time.time(), "dir": str(d), "owner": info.owner,
                  "epoch": info.epoch, "outcome": outcome,
                  **(detail or {})}
        with self._lock:
            self.actions.append(action)
            del self.actions[:-ACTIONS_CAP]
            if outcome == "adopted":
                self.takeovers += 1
            elif outcome == "observed":
                self.observed += 1
            elif outcome == "error":
                self.errors += 1
        if self._takeovers_c is not None:
            self._takeovers_c.inc(outcome=outcome)
        if outcome != "observed":
            tracelog.event("failover.takeover", **action)

    # ----------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """JSON-safe view for status_snapshot()'s `failover` key (the
        health `peer_down` rule reads it)."""
        with self._lock:
            return {"fleet_dir": str(self.fleet_dir),
                    "mode": "act" if self.act else "observe",
                    "scan_period_s": self.scan_period_s,
                    "scans": self.scans,
                    "takeovers": self.takeovers,
                    "observed": self.observed,
                    "errors": self.errors,
                    "peers": [dict(p) for p in self.peers],
                    "actions": [dict(a) for a in self.actions]}
