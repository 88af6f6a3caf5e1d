"""Persistent tuning cache: probe once per (shape, bound, topology).

Reproduces `tpu_tree_search/tune/cache.py`: the same file format (`MAGIC`,
a little-endian u64 header length, a JSON header holding the fingerprint,
the key, the creation time, the payload's length and CRC32, then the JSON
payload), the same file names (`_key_digest`), writes through a temporary
file with fsync and an atomic rename, corrupt entries quarantined under
per-writer names (`*.corrupt`), `entries()` rescanned at most every
`ENTRIES_TTL_S`, `snapshot()` and the hit, miss, mismatch, error,
quarantine and write counters. Either package loads the other's entry
when their fingerprints agree.

The fingerprint (`tuning_fingerprint`) keeps the JAX rule: hardware and
topology only, no software version, because a measured chunk optimum
survives a software bump and breaks when the hardware changes. A
wrong-fingerprint entry is ignored (and overwritten by the next probe),
never consumed.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import struct
import threading
import time
import zlib

import torch

from ..obs import tracelog

__all__ = ["TuningCache", "decode", "tuning_fingerprint"]

MAGIC = b"TTSTUNE1\n"
_HDR_LEN = struct.Struct("<Q")
QUARANTINE_SUFFIX = ".corrupt"


def tuning_fingerprint(extra: dict | None = None, device="cuda") -> dict:
    """The hardware and topology a tuned optimum is valid on: the
    platform of `device` ("cuda" or "cpu"), the visible card count, each
    card's name with its SM count, and the process count (the
    `torch.distributed` group's size, 1 without one, as JAX reads
    `jax.process_count()`). On the CPU it asks nothing of `torch.cuda`."""
    from ..engine.device import resolve_device
    from ..parallel import mesh

    dev = resolve_device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        kinds = set()
        for i in range(n):
            props = torch.cuda.get_device_properties(i)
            kinds.add(f"{props.name} ({props.multi_processor_count} SMs)")
        fp = {"platform": "cuda", "device_count": n,
              "device_kinds": sorted(kinds)}
    else:
        fp = {"platform": "cpu", "device_count": 1, "device_kinds": ["cpu"]}
    fp["process_count"] = mesh.process_count()
    if extra:
        fp.update(extra)
    return fp


def _key_digest(key: tuple) -> str:
    """Stable digest of a tuning key (the JAX package's, so the file names
    match). The fingerprint stays out of the name: a hardware change
    overwrites a stale entry in place."""
    raw = json.dumps([str(k) for k in key]).encode()
    return hashlib.sha256(raw).hexdigest()[:32]


def decode(blob: bytes) -> tuple[dict, dict]:
    """An entry file's (header, payload). Raises on a bad magic, a
    truncated payload or a CRC mismatch; checks no fingerprint."""
    if blob[:len(MAGIC)] != MAGIC:
        raise ValueError("bad magic")
    off = len(MAGIC)
    (hdr_len,) = _HDR_LEN.unpack_from(blob, off)
    off += _HDR_LEN.size
    header = json.loads(blob[off:off + hdr_len].decode())
    payload_raw = blob[off + hdr_len:]
    if len(payload_raw) != int(header["payload_len"]):
        raise ValueError("truncated payload")
    if zlib.crc32(payload_raw) != int(header["payload_crc32"]):
        raise ValueError("payload CRC mismatch")
    return header, json.loads(payload_raw.decode())


class TuningCache:
    """Disk tier under the Autotuner. `load(key)` returns the stored
    payload dict (or None: absent, wrong fingerprint, or corrupt);
    `store(key, payload)` persists atomically. `device` is the one the
    entries are probed on (its fingerprint is checked on every load)."""

    ENTRIES_TTL_S = 5.0   # entries() rescans the directory at most this often

    def __init__(self, root: str | os.PathLike, registry=None,
                 fingerprint_extra: dict | None = None, device="cuda"):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.fingerprint = tuning_fingerprint(fingerprint_extra, device)
        self.hits = 0            # guarded-by: self._lock
        self.misses = 0          # guarded-by: self._lock
        self.mismatches = 0      # guarded-by: self._lock
        self.errors = 0          # guarded-by: self._lock
        self.quarantined = 0     # guarded-by: self._lock
        self.writes = 0          # guarded-by: self._lock
        # unguarded on purpose (an atomic tuple swap; a stale count is
        # fine for a stats field): see entries()
        self._entries_cache: tuple | None = None
        self._lock = threading.Lock()
        self._hits_c = self._misses_c = None
        if registry is not None:
            self._hits_c = registry.counter(
                "tts_tuner_cache_hits_total",
                "tuned dispatch params replayed from the tuning cache "
                "(zero probes paid)")
            self._misses_c = registry.counter(
                "tts_tuner_cache_misses_total",
                "tuning-cache lookups with no loadable entry (absent, "
                "wrong-fingerprint, or quarantined corrupt)")

    def path_for(self, key: tuple) -> pathlib.Path:
        return self.root / f"{_key_digest(key)}.tune"

    def load(self, key: tuple) -> dict | None:
        """The stored payload for `key`, or None. Never raises: a corrupt
        entry is quarantined, a wrong-fingerprint one ignored, and the
        caller probes as if the cache were empty."""
        path = self.path_for(key)
        try:
            blob = path.read_bytes()
        except FileNotFoundError:
            self._count("_misses_c", "misses")
            return None
        except OSError as e:
            self._count("_misses_c", "errors")
            tracelog.event("tuner_cache.read_error", path=path.name,
                           error=repr(e))
            return None
        try:
            header, payload = decode(blob)
        except Exception as e:  # noqa: BLE001 — torn, truncated or garbled
            self._quarantine(path, repr(e))
            return None
        if header.get("fingerprint") != self.fingerprint:
            with self._lock:
                self.mismatches += 1
            self._count("_misses_c", "misses")
            tracelog.event("tuner_cache.mismatch", path=path.name,
                           theirs=header.get("fingerprint"),
                           ours=self.fingerprint)
            return None
        self._count("_hits_c", "hits")
        tracelog.event("tuner_cache.hit", path=path.name,
                       key=header.get("key"))
        return payload

    def _quarantine(self, path: pathlib.Path, error: str) -> None:
        self._count("_misses_c", "errors")
        # a per-writer name, counter-suffixed: writers quarantining the
        # same entry never replace each other's forensic copy (only this
        # thread mints names under its pid-tid prefix)
        base = f"{path.name}.{os.getpid()}-{threading.get_ident()}"
        qpath = str(path.with_name(base + QUARANTINE_SUFFIX))
        n = 0
        while os.path.exists(qpath):
            n += 1
            qpath = str(path.with_name(f"{base}.{n}{QUARANTINE_SUFFIX}"))
        try:
            os.replace(path, qpath)
            with self._lock:
                self.quarantined += 1
            self._entries_cache = None   # one fewer .tune on disk
        except OSError:
            qpath = None
        tracelog.event("tuner_cache.quarantine", path=path.name,
                       quarantined_to=qpath, error=error)

    def store(self, key: tuple, payload: dict, key_repr: str = "") -> None:
        """Persist `payload` for `key`: CRC stamp, temporary file + fsync +
        atomic rename (a reader sees the old bytes or the new, never a
        torn file)."""
        payload_raw = json.dumps(payload, sort_keys=True).encode()
        header = json.dumps({
            "v": 1, "fingerprint": self.fingerprint, "key": key_repr,
            "created_unix": time.time(),
            "payload_len": len(payload_raw),
            "payload_crc32": zlib.crc32(payload_raw),
        }).encode()
        path = self.path_for(key)
        tmp = path.with_name(
            f".{path.name}.{os.getpid()}-{threading.get_ident()}.tmp")
        try:
            with open(tmp, "wb") as f:
                f.write(MAGIC)
                f.write(_HDR_LEN.pack(len(header)))
                f.write(header)
                f.write(payload_raw)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        with self._lock:
            self.writes += 1
        self._entries_cache = None       # the count may have changed
        tracelog.event("tuner_cache.store", path=path.name,
                       key=key_repr, bytes=len(payload_raw))

    def _count(self, counter_attr: str, field: str) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)
        c = getattr(self, counter_attr)
        if c is not None:
            c.inc()

    def entries(self) -> int:
        """Entry-file count, rescanned at most every ENTRIES_TTL_S."""
        now = time.monotonic()
        cached = self._entries_cache
        if cached is not None and now - cached[0] < self.ENTRIES_TTL_S:
            return cached[1]
        try:
            n = sum(1 for p in self.root.iterdir() if p.suffix == ".tune")
        except OSError:
            n = 0
        self._entries_cache = (now, n)
        return n

    def snapshot(self) -> dict:
        """JSON-safe stats (the tuner's `snapshot()["cache"]`)."""
        n = self.entries()
        with self._lock:
            return {"dir": str(self.root), "entries": n,
                    "hits": self.hits, "misses": self.misses,
                    "mismatches": self.mismatches,
                    "errors": self.errors,
                    "quarantined": self.quarantined,
                    "writes": self.writes}
