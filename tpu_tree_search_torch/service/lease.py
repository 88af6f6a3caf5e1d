"""Lease-fenced ledger ownership: the fleet-failover primitive.

Reproduces `tpu_tree_search/service/lease.py` (`LeaseLost`, `LeaseInfo`,
`LeaseKeeper`, `read_lease`, `claim_epoch`, `suspend_renewals`,
`owner_id`) with the same file format, byte for byte: either package reads
and renews the other's lease. Stdlib only; it never touches the card.

Every SearchServer that opens a request ledger inside a fleet directory
takes a **lease** on it: one fsync'd, CRC-stamped JSON file
(``lease.json``) in the ledger directory with the owner id, a
monotonically increasing **fencing epoch**, the TTL and the last renewal
time, renewed by a daemon thread at about TTL/3. Peers
(`service/failover.FailoverWatcher`) scan the fleet root for ledgers whose
lease has expired and adopt them; the epoch is what makes that safe:

- **Exactly one adopter**: bumping the epoch goes through an
  ``O_CREAT|O_EXCL`` *claim file* (``lease.claim-<epoch>``). The one
  writer the kernel lets create it wins; the loser backs off. A temp file
  and a rename cannot arbitrate two racing writers (both renames succeed);
  an exclusive create can.
- **Self-fencing**: a stale owner that wakes from a pause (the
  ``pause_server`` drill) discovers the bumped epoch at its next renewal
  or :meth:`LeaseKeeper.check` and refuses further commits with a typed
  :class:`LeaseLost`. ``check()`` reads the FILE again whenever the last
  successful renewal is older than the TTL, so the fence does not depend
  on the renewal daemon winning a thread race after the wake.
- **Epoch stamps outlive the lease**: every ledger append and checkpoint
  save carries the owner's epoch (`service/ledger.py`,
  `engine/checkpoint.py`), so a write that slips out during the
  revalidation window is discarded at replay or refused at save.

Writes: a unique temp name per writer, the payload's CRC32, flush, fsync
and an atomic rename. A corrupt lease file is quarantined
(``lease.json.corrupt``) and treated as absent; the next acquirer creates
it again at a bumped epoch.

On one host the lease records the owner's pid, and a reader on the same
host treats a dead pid's lease as expired at once (a dead process holds no
lease): a hard-killed server restarted on the same ledger acquires again
without waiting out the TTL.
"""

from __future__ import annotations

import dataclasses
import errno
import json
import os
import pathlib
import socket
import threading
import time
import weakref
import zlib

from ..obs import tracelog
from ..utils import config as cfg

__all__ = ["LeaseLost", "LeaseInfo", "LeaseKeeper", "read_lease",
           "claim_epoch", "suspend_renewals", "owner_id"]

LEASE_NAME = "lease.json"
CLAIM_PREFIX = "lease.claim-"
QUARANTINE_SUFFIX = ".corrupt"


class LeaseLost(RuntimeError):
    """This process no longer owns the lease (epoch bumped by an
    adopter, owner changed, or held by a live peer at boot). Commits
    must stop: the request ledger refuses appends, checkpoint saves
    refuse to land, and the server exits its scheduler tick cleanly."""


def owner_id() -> str:
    """A per-process owner identity. Includes the pid so a same-host
    reader can liveness-check it, and a random suffix so a recycled
    pid cannot impersonate a previous incarnation."""
    return (f"{socket.gethostname()}:{os.getpid()}:"
            f"{os.urandom(4).hex()}")


@dataclasses.dataclass(frozen=True)
class LeaseInfo:
    """One parsed lease file."""

    owner: str
    epoch: int
    ttl_s: float
    renewed_unix: float
    host: str
    pid: int
    released: bool = False

    def age_s(self, now: float | None = None) -> float:
        return max(0.0, (time.time() if now is None else now)
                   - self.renewed_unix)

    def expired(self, now: float | None = None) -> bool:
        """Past the TTL — or provably dead: released cleanly, or owned
        by a no-longer-running pid on THIS host (the same-host restart
        fast path; cross-host readers wait out the TTL)."""
        if self.released:
            return True
        if self.age_s(now) > self.ttl_s:
            return True
        if self.host == socket.gethostname() and not _pid_alive(self.pid):
            return True
        return False


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except OSError as e:
        # EPERM = alive but not ours; ESRCH = gone
        return e.errno == errno.EPERM
    return True


def _lease_path(root) -> pathlib.Path:
    return pathlib.Path(root) / LEASE_NAME


def read_lease(root) -> LeaseInfo | None:
    """Parse the lease file under `root`. Never raises: absent returns
    None; a corrupt/truncated file is QUARANTINED (renamed
    ``*.corrupt``) and treated as absent — the ledger/checkpoint
    integrity discipline."""
    path = _lease_path(root)
    try:
        raw = path.read_bytes()
    except FileNotFoundError:
        return None
    except OSError as e:
        tracelog.event("lease.read_error", path=str(path), error=repr(e))
        return None
    try:
        obj = json.loads(raw.decode())
        rec = obj["r"]
        body = json.dumps(rec, sort_keys=True,
                          separators=(",", ":")).encode()
        if zlib.crc32(body) != int(obj["c"]):
            raise ValueError("lease CRC mismatch")
        return LeaseInfo(owner=str(rec["owner"]), epoch=int(rec["epoch"]),
                         ttl_s=float(rec["ttl_s"]),
                         renewed_unix=float(rec["renewed_unix"]),
                         host=str(rec.get("host", "")),
                         pid=int(rec.get("pid", 0)),
                         released=bool(rec.get("released", False)))
    except Exception as e:  # noqa: BLE001 — torn/truncated/garbled
        qpath = str(path) + QUARANTINE_SUFFIX
        try:
            os.replace(path, qpath)
        except OSError:
            qpath = None
        tracelog.event("lease.quarantine", path=str(path),
                       quarantined_to=qpath, error=repr(e))
        return None


def _write_lease(root, info: LeaseInfo) -> None:
    """CRC-stamp + unique temp + fsync + atomic rename (the AOTCache
    write discipline): a concurrent reader sees the old lease or the
    new one, never a torn mix, and two writers never interleave a
    temp file."""
    rec = {"owner": info.owner, "epoch": info.epoch,
           "ttl_s": info.ttl_s, "renewed_unix": info.renewed_unix,
           "host": info.host, "pid": info.pid,
           "released": info.released}
    body = json.dumps(rec, sort_keys=True, separators=(",", ":")).encode()
    blob = json.dumps({"c": zlib.crc32(body), "r": rec},
                      sort_keys=True).encode()
    path = _lease_path(root)
    tmp = path.with_name(
        f".{path.name}.{os.getpid()}-{threading.get_ident()}.tmp")
    try:
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def claim_epoch(root, epoch: int) -> bool:
    """Atomically claim the right to publish `epoch`: create
    ``lease.claim-<epoch>`` with O_CREAT|O_EXCL. Exactly one caller
    per epoch gets True — the compare-and-swap two peers racing one
    expired lease are arbitrated by. The loser does NOT retry at a
    higher epoch (that would mint a second adopter); it re-scans later
    and finds a fresh lease."""
    path = pathlib.Path(root) / f"{CLAIM_PREFIX}{epoch:08d}"
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    except OSError as e:
        tracelog.event("lease.claim_error", path=str(path), error=repr(e))
        return False
    try:
        os.write(fd, owner_id().encode())
        os.fsync(fd)
    finally:
        os.close(fd)
    return True


def _max_claim(root) -> int:
    """Highest epoch any claim file records. The lease file can vanish
    (corruption -> quarantine) while claim files survive — a booter
    must bid ABOVE every epoch ever claimed, or its CAS loses forever
    against a tombstone claim and fencing could regress."""
    best = 0
    try:
        for p in pathlib.Path(root).iterdir():
            if p.name.startswith(CLAIM_PREFIX):
                try:
                    best = max(best, int(p.name[len(CLAIM_PREFIX):]))
                except ValueError:
                    pass
    except OSError:
        pass
    return best


def _gc_claims(root, keep_from: int) -> None:
    """Best-effort cleanup of claim files below `keep_from` (takeovers
    are rare; this just keeps the ledger dir tidy)."""
    try:
        for p in pathlib.Path(root).iterdir():
            if p.name.startswith(CLAIM_PREFIX):
                try:
                    if int(p.name[len(CLAIM_PREFIX):]) < keep_from:
                        p.unlink()
                except (ValueError, OSError):
                    pass
    except OSError:
        pass


# Every live keeper registers here so the pause_server drill
# (utils/faults.py) can freeze renewals process-wide: a real GC pause /
# partition stops ALL threads, so a drill that sleeps only the executor
# thread while the renewal daemon keeps the lease fresh would never
# create the split-brain geometry the drill exists to pin.
_keepers: "weakref.WeakSet[LeaseKeeper]" = weakref.WeakSet()


def suspend_renewals(seconds: float) -> None:
    """Freeze every registered keeper's renewal daemon for `seconds`
    (the pause_server drill's hook). After the freeze the next renewal
    re-reads the lease file and self-fences if the epoch moved."""
    until = time.monotonic() + seconds
    for k in list(_keepers):
        k._suspend_until = max(k._suspend_until, until)
    tracelog.event("lease.renewals_suspended", seconds=seconds,
                   keepers=len(list(_keepers)))


class LeaseKeeper:
    """Owns one ledger directory's lease: acquires it (epoch bump via
    the claim-file CAS), renews it on a daemon thread, and fences this
    process the moment the file says someone else owns it.

    ``acquire()`` raises :class:`LeaseLost` when the lease is HELD by a
    live other owner — a booting server must not steal a ledger an
    adopter is serving (the stale-A-restarts geometry); an expired /
    released / dead-pid lease is re-acquired at a bumped epoch.
    ``takeover(target_epoch)`` is the peer-adoption variant: claim
    exactly ``current+1`` once, no retry — False means another peer
    won the race."""

    def __init__(self, root, owner: str | None = None,
                 ttl_s: float | None = None, registry=None,
                 on_lost=None):
        self.root = pathlib.Path(root)
        self.owner = owner or owner_id()
        self.ttl_s = float(ttl_s if ttl_s is not None
                           else cfg.env_float("TTS_LEASE_TTL_S"))
        self.epoch = 0
        self.renewals = 0           # guarded-by: self._lock
        self.lost_reason: str | None = None   # guarded-by: self._lock
        self._on_lost = on_lost
        self._lock = threading.Lock()
        self._fenced = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # monotonic time of the last successful renewal: check() trusts
        # the in-memory state only this long (the TTL), then revalidates
        # against the file — the fence survives a paused renewal daemon
        self._renewed_mono = time.monotonic()
        self._suspend_until = 0.0   # pause_server drill (suspend_renewals)
        self._epoch_g = self._renew_c = self._lost_c = None
        if registry is not None:
            self._epoch_g = registry.gauge(
                "tts_lease_epoch",
                "fencing epoch of the ledger lease this server holds")
            self._renew_c = registry.counter(
                "tts_lease_renewals_total",
                "successful ledger-lease renewals")
            self._lost_c = registry.counter(
                "tts_lease_lost_total",
                "lease losses (epoch bumped by an adopter / owner "
                "changed): the server self-fenced")
        _keepers.add(self)

    # ------------------------------------------------------- acquire

    def acquire(self) -> "LeaseKeeper":
        """Take the lease (boot path). Raises LeaseLost if a live other
        owner holds it; otherwise bumps the epoch through the claim
        CAS and publishes the lease file."""
        for _ in range(64):     # bounded: concurrent booters interleave
            info = read_lease(self.root)
            if info is not None and not info.expired():
                raise LeaseLost(
                    f"ledger {self.root} lease held by {info.owner} "
                    f"(epoch {info.epoch}, age {info.age_s():.2f}s < "
                    f"ttl {info.ttl_s:g}s)")
            target = max(info.epoch if info is not None else 0,
                         _max_claim(self.root)) + 1
            if not claim_epoch(self.root, target):
                # another booter claimed this epoch between our read
                # and our claim; re-read and try the next one
                time.sleep(0.01)
                continue
            self.epoch = target
            self._publish(renew=False)
            _gc_claims(self.root, keep_from=target)
            self._start_renewal()
            tracelog.event("lease.acquired", dir=str(self.root),
                           owner=self.owner, epoch=self.epoch,
                           ttl_s=self.ttl_s)
            return self
        raise LeaseLost(f"could not claim an epoch on {self.root} "
                        "(claim contention)")

    def takeover(self, current_epoch: int) -> bool:
        """Peer-adoption CAS: claim exactly ``current_epoch + 1``.
        False = another peer won (exactly one adopter per epoch by
        construction — no retry at a higher epoch)."""
        target = current_epoch + 1
        if not claim_epoch(self.root, target):
            return False
        self.epoch = target
        self._publish(renew=False)
        _gc_claims(self.root, keep_from=target)
        self._start_renewal()
        tracelog.event("lease.taken_over", dir=str(self.root),
                       owner=self.owner, epoch=self.epoch)
        return True

    def _publish(self, renew: bool) -> None:
        _write_lease(self.root, LeaseInfo(
            owner=self.owner, epoch=self.epoch, ttl_s=self.ttl_s,
            renewed_unix=time.time(), host=socket.gethostname(),
            pid=os.getpid()))
        self._renewed_mono = time.monotonic()
        if self._epoch_g is not None:
            self._epoch_g.set(self.epoch)
        if renew:
            with self._lock:
                self.renewals += 1
            if self._renew_c is not None:
                self._renew_c.inc()

    # --------------------------------------------------------- renew

    def _start_renewal(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._renew_loop, name=f"lease-{self.root.name}",
            daemon=True)
        self._thread.start()

    def _renew_loop(self) -> None:
        period = max(self.ttl_s / 3.0, 0.05)
        while not self._stop.wait(period):
            if time.monotonic() < self._suspend_until:
                continue    # pause_server drill: the 'GC pause'
            try:
                self.renew()
            except LeaseLost:
                return      # fenced: the daemon's job is done
            except OSError as e:
                # transient fleet-storage hiccup: keep trying inside
                # the TTL; check() revalidates before trusting us
                tracelog.event("lease.renew_error", dir=str(self.root),
                               error=repr(e))

    def renew(self) -> None:
        """Re-read the lease file and, if it is still ours, refresh the
        renewal stamp. The re-read IS the fence: an adopter's bumped
        epoch (or changed owner) is discovered here and fences this
        process with a typed LeaseLost."""
        if self._fenced.is_set():
            raise LeaseLost(self.lost_reason or "lease lost")
        info = read_lease(self.root)
        if (info is None or info.owner != self.owner
                or info.epoch != self.epoch):
            self._fence(
                f"lease on {self.root} now "
                + (f"owned by {info.owner} at epoch {info.epoch}"
                   if info is not None else "absent/quarantined")
                + f" (ours was epoch {self.epoch})")
        self._publish(renew=True)

    def check(self) -> None:
        """Cheap fence check for commit paths (ledger appends,
        checkpoint saves). In-memory while the last renewal is younger
        than the TTL; past it — a paused daemon, exactly the
        split-brain window — revalidates against the file before
        letting the commit through."""
        if self._fenced.is_set():
            raise LeaseLost(self.lost_reason or "lease lost")
        if time.monotonic() - self._renewed_mono > self.ttl_s:
            self.renew()

    @property
    def fenced(self) -> bool:
        return self._fenced.is_set()

    def _fence(self, reason: str) -> None:
        with self._lock:
            already = self._fenced.is_set()
            self.lost_reason = reason
        self._fenced.set()
        if not already:
            if self._lost_c is not None:
                self._lost_c.inc()
            tracelog.event("failover.fenced", dir=str(self.root),
                           owner=self.owner, epoch=self.epoch,
                           reason=reason)
            cb = self._on_lost
            if cb is not None:
                try:
                    cb(reason)
                except Exception as e:  # noqa: BLE001 — a fence
                    # callback must never mask the fence itself
                    tracelog.event("failover.fence_callback_error",
                                   error=repr(e))
        raise LeaseLost(reason)

    # ------------------------------------------------------- release

    def release(self) -> None:
        """Clean shutdown: stop renewing and mark the lease released
        so peers do not 'adopt' a cleanly drained ledger. A fenced
        keeper leaves the file alone — it belongs to the adopter."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        if self._fenced.is_set():
            return
        info = read_lease(self.root)
        if info is not None and info.owner == self.owner \
                and info.epoch == self.epoch:
            try:
                _write_lease(self.root, dataclasses.replace(
                    info, renewed_unix=time.time(), released=True))
            except OSError as e:
                tracelog.event("lease.release_error",
                               dir=str(self.root), error=repr(e))
        tracelog.event("lease.released", dir=str(self.root),
                       owner=self.owner, epoch=self.epoch)

    def snapshot(self) -> dict:
        with self._lock:
            return {"dir": str(self.root), "owner": self.owner,
                    "epoch": self.epoch, "ttl_s": self.ttl_s,
                    "renewals": self.renewals,
                    "fenced": self._fenced.is_set(),
                    "lost_reason": self.lost_reason}
