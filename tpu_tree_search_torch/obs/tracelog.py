"""Structured span/event log — the flight recorder's write path.

A copy of `tpu_tree_search/obs/tracelog.py` (stdlib only): the port's
checkpoint layer records the same spans and events under the same names.

A process-wide, thread-safe recorder of what the search runtime did and
when: ``event(name, **attrs)`` records a point-in-time fact,
``span(name, **attrs)`` brackets a duration (context manager; one record
at exit carrying the start timestamp and the measured duration). Records
land in a bounded ring buffer (old records drop silently — the recorder
must never become the memory leak it exists to debug) and, when a sink
is configured, are appended as JSON-lines to a file as they happen, so a
killed process leaves a durable record up to its last write. The sink is
size-capped too (``TTS_TRACE_MAX_MB``, default 64, 0 disables): at the
cap it rotates to a single ``.1`` sibling and restarts, so a month-long
serve session's recorder is bounded on disk as well as in RAM.

Record schema (one JSON object per line in the sink)::

    {"kind": "span" | "event",
     "name": "request.dispatch",
     "ts":   12.345678,          # seconds on this recorder's monotonic
                                 # clock (t0 = recorder creation)
     "dur":  0.25,               # spans only: seconds
     "seq":  417,                # process-wide ordering tiebreak
     "pid":  31337, "thread": "tts-service-exec-0",
     ...flat attributes: request_id, submesh, segment, ...}

The sink file starts with one ``{"kind": "meta", ...}`` line mapping the
monotonic clock to wall time (``t0_unix``), so offline readers can
reconstruct absolute times.

Ambient context: :func:`context` installs thread-local attributes merged
into every record the thread emits while inside it. The service wraps
each request's executor thread in ``context(request_id=..., submesh=...)``
so the engine-level spans it drives (segments, checkpoint saves, retry
events) are attributable to the request WITHOUT threading ids through
every engine API.

Module-level :func:`span` / :func:`event` write to the process-global
recorder (lazily built; ``TTS_TRACE_FILE`` configures its sink,
``TTS_TRACE_RING`` its capacity). Tests swap the global with
:func:`install` for isolation.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time

__all__ = ["TraceLog", "get", "install", "span", "event", "context",
           "span_at", "current_context"]


def _json_safe(v):
    """Attrs must serialize without surprises; anything exotic becomes
    its repr rather than poisoning the whole sink line."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    try:                       # numpy scalars and friends
        return v.item()
    except (AttributeError, ValueError):
        return repr(v)


class _Span:
    """Handle yielded by :meth:`TraceLog.span`; carries the measured
    duration after exit (``.dur``) and accepts late attributes via
    :meth:`set` (e.g. a result computed inside the span)."""

    __slots__ = ("name", "attrs", "t_start", "dur")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.t_start = 0.0
        self.dur = 0.0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class TraceLog:
    """Thread-safe bounded span/event recorder with an optional JSONL
    file sink. See the module docstring for the record schema."""

    def __init__(self, capacity: int = 16384,
                 sink_path: str | os.PathLike | None = None,
                 max_sink_bytes: int | None = None):
        self.t0 = time.monotonic()
        self.t0_unix = time.time()
        self._lock = threading.Lock()
        self._buf: collections.deque[dict] = collections.deque(
            maxlen=max(int(capacity), 1))   # guarded-by: self._lock
        self._seq = itertools.count()
        self._tls = threading.local()
        self._sink = None        # guarded-by: self._lock
        self._sink_bytes = 0     # guarded-by: self._lock
        self.rotations = 0       # guarded-by: self._lock
        # size-capped rotation (TTS_TRACE_MAX_MB, 0 disables): at the
        # cap the sink rolls to a `.1` sibling and restarts — a long
        # serve session's recorder is bounded at ~2x the cap on disk
        if max_sink_bytes is None:
            try:
                from ..utils.config import env_float
                mb = env_float("TTS_TRACE_MAX_MB")
            except ImportError:  # keep the recorder usable solo
                mb = 64.0
            max_sink_bytes = int(mb * (1 << 20))
        self.max_sink_bytes = max(int(max_sink_bytes), 0)
        self.dropped = 0           # guarded-by: self._lock
        #                            (records evicted from the ring)
        # fan-out listeners (the durable obs-store sink subscribes
        # here): called OUTSIDE the lock with the finished record — a
        # slow listener must not serialize the recorder — and a raising
        # listener is dropped, never propagated
        self._listeners: list = []
        if sink_path:
            self.set_sink(sink_path)

    def add_listener(self, fn) -> None:
        """Subscribe `fn(record)` to every emitted record."""
        self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    # ------------------------------------------------------------- sink

    def set_sink(self, path: str | os.PathLike | None) -> None:
        """Start (or stop, with None) appending records to a JSONL file.
        Opening writes the meta line that anchors the monotonic clock."""
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None
            if path is None:
                return
            path = os.fspath(path)
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            try:
                self._sink_bytes = os.path.getsize(path)
            except OSError:
                self._sink_bytes = 0
            self._sink = open(path, "a", buffering=1)   # line-buffered
            meta = json.dumps({"kind": "meta", "t0_unix": self.t0_unix,
                               "pid": os.getpid()}) + "\n"
            self._sink.write(meta)
            self._sink_bytes += len(meta)
            self._sink_path = path

    def _rotate_locked(self) -> None:    # holds: self._lock
        """Roll the sink to `<path>.1` (replacing any previous rollover)
        and restart it fresh; caller holds the lock. A rotation failure
        downgrades to sink-off — the recorder must never raise."""
        path = self._sink_path
        try:
            self._sink.close()
            os.replace(path, path + ".1")
            self._sink_bytes = 0
            self._sink = open(path, "a", buffering=1)
            meta = json.dumps(
                {"kind": "meta", "t0_unix": self.t0_unix,
                 "pid": os.getpid(), "rotation": self.rotations + 1})
            self._sink.write(meta + "\n")
            self._sink_bytes += len(meta) + 1
            self.rotations += 1
        except (OSError, ValueError):
            self._sink = None

    @property
    def sink_path(self) -> str | None:
        return getattr(self, "_sink_path", None) if self._sink else None

    # ---------------------------------------------------------- context

    @contextlib.contextmanager
    def context(self, **attrs):
        """Thread-local ambient attributes merged into every record this
        thread emits inside the block (nestable; inner wins on clash)."""
        stack = getattr(self._tls, "ctx", None)
        if stack is None:
            stack = self._tls.ctx = []
        stack.append({k: _json_safe(v) for k, v in attrs.items()})
        try:
            yield
        finally:
            stack.pop()

    def _ambient(self) -> dict:
        out = {}
        for layer in getattr(self._tls, "ctx", ()):
            out.update(layer)
        return out

    def current_context(self) -> dict:
        """This thread's merged ambient attributes — the hand-off for
        work delegated to ANOTHER thread (the async checkpoint writer
        re-installs it so its records keep the request identity)."""
        return dict(self._ambient())

    # ------------------------------------------------------------ write

    def _emit(self, rec: dict) -> None:
        with self._lock:
            rec["seq"] = next(self._seq)
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(rec)
            if self._sink is not None:
                try:
                    line = json.dumps(rec) + "\n"
                    self._sink.write(line)
                    self._sink_bytes += len(line)
                    if self.max_sink_bytes \
                            and self._sink_bytes >= self.max_sink_bytes:
                        self._rotate_locked()
                except (OSError, ValueError):
                    # a torn sink (disk full, closed fd) must never take
                    # the search down; the ring buffer keeps recording
                    self._sink = None
        for fn in list(self._listeners):
            try:
                fn(rec)
            except Exception:
                self.remove_listener(fn)

    def event(self, name: str, **attrs) -> dict:
        """Record a point-in-time event; returns the record."""
        rec = {"kind": "event", "name": name,
               "ts": round(time.monotonic() - self.t0, 6),
               "pid": os.getpid(),
               "thread": threading.current_thread().name,
               **self._ambient(),
               **{k: _json_safe(v) for k, v in attrs.items()}}
        self._emit(rec)
        return rec

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Bracket a duration. One record is emitted at exit (so the
        ring holds only completed work); its ``ts`` is the span START.
        An exception inside the span is recorded as ``error=<repr>`` and
        re-raised — a failed operation leaves a trace, not a hole."""
        sp = _Span(name, {k: _json_safe(v) for k, v in attrs.items()})
        ambient = self._ambient()
        t_start = time.monotonic()
        sp.t_start = t_start - self.t0
        try:
            yield sp
        except BaseException as e:
            sp.attrs.setdefault("error", repr(e))
            raise
        finally:
            sp.dur = time.monotonic() - t_start
            self._emit({"kind": "span", "name": name,
                        "ts": round(sp.t_start, 6),
                        "dur": round(sp.dur, 6),
                        "pid": os.getpid(),
                        "thread": threading.current_thread().name,
                        **ambient, **sp.attrs})

    def span_at(self, name: str, t_start: float, t_end: float,
                **attrs) -> None:
        """Emit a completed span with EXPLICIT monotonic timestamps
        (``time.monotonic()`` values). The overlapped segment driver
        needs this: its ``segment`` spans cover [dispatch, results
        ready] — an interval that straddles other host work and the
        NEXT segment's dispatch, so no ``with`` block can bracket it.
        Consecutive spans emitted this way may overlap in wall time;
        gap analyses (tools/search_report.py) clamp negatives to 0."""
        self._emit({"kind": "span", "name": name,
                    "ts": round(t_start - self.t0, 6),
                    "dur": round(max(t_end - t_start, 0.0), 6),
                    "pid": os.getpid(),
                    "thread": threading.current_thread().name,
                    **self._ambient(),
                    **{k: _json_safe(v) for k, v in attrs.items()}})

    # ------------------------------------------------------------- read

    def records(self) -> list[dict]:
        """Snapshot of the ring buffer, oldest first."""
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


# ----------------------------------------------------------- global log

_global: TraceLog | None = None
_global_lock = threading.Lock()


def get() -> TraceLog:
    """The process-global recorder (built lazily from TTS_TRACE_FILE /
    TTS_TRACE_RING on first use)."""
    global _global
    with _global_lock:
        if _global is None:
            try:
                from ..utils.config import env_int, env_str
                capacity = env_int("TTS_TRACE_RING")
                sink = env_str("TTS_TRACE_FILE")
            except ImportError:     # keep the recorder usable solo
                capacity, sink = 16384, None
            _global = TraceLog(capacity=capacity, sink_path=sink)
        return _global


def install(log: TraceLog | None) -> TraceLog:
    """Swap the process-global recorder (tests; None re-arms the lazy
    env-driven build). Returns the previous one, if any."""
    global _global
    with _global_lock:
        prev = _global
        _global = log
        return prev


def span(name: str, **attrs):
    """`get().span(...)` — the instrumentation sites' one-liner."""
    return get().span(name, **attrs)


def event(name: str, **attrs) -> dict:
    """`get().event(...)` — the instrumentation sites' one-liner."""
    return get().event(name, **attrs)


def context(**attrs):
    """`get().context(...)` — ambient attributes for this thread."""
    return get().context(**attrs)


def span_at(name: str, t_start: float, t_end: float, **attrs) -> None:
    """`get().span_at(...)` — explicit-timestamp span emission."""
    get().span_at(name, t_start, t_end, **attrs)


def current_context() -> dict:
    """`get().current_context()` — this thread's ambient attributes."""
    return get().current_context()
