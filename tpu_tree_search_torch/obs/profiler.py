"""On-demand profiler capture: the process's ONE profiling door.

Reproduces `tpu_tree_search/obs/profiler.py` on ``torch.profiler``.
``torch.profiler`` is process-global: a second profiler started while one
runs raises inside torch, and two captures would interleave their
activity. :class:`ProfilerSession` serializes them behind a non-blocking
lock: one capture at a time, and a second caller gets
:class:`ProfilerBusyError` at once (the HTTP front end maps it to ``409
Conflict``) instead of an exception from inside torch.

Every profiler entry point of the port goes through here: ``POST
/profile`` on a live ``serve`` process (obs/httpd), the ``profile``
command and ``profile_step``; no other module calls ``torch.profiler``.

On the card a capture records ``ProfilerActivity.CPU`` and
``ProfilerActivity.CUDA``, on the CPU only ``ProfilerActivity.CPU``, with
the CPU ops of every thread (``profile_all_threads``): a capture started
on the HTTP handler's thread sees the executor threads' work. CUPTI
records the card's activity for the whole process, kernels replayed from
CUDA graphs included. ``stop`` exports the trace as gzipped Chrome JSON
in JAX's artifact layout,
``<capture>/plugins/profile/<run>/<host>.trace.json.gz``, which
``obs/chrome_trace.load_profile_trace`` reads. Each capture is itself
flight-recorded (a ``profiler.capture`` event with the artifact path and
the window's seconds) and counted (``tts_profile_captures_total``).
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time

from . import metrics, tracelog

__all__ = ["ProfilerBusyError", "ProfilerSession", "session", "trace",
           "capture"]


class ProfilerBusyError(RuntimeError):
    """A capture is already running (the profiler is process-global and
    strictly one-at-a-time); retry after it stops."""


def _profile():
    """A ``torch.profiler.profile`` of this process: the card's activity
    when torch sees one, and the CPU ops of every thread."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))


def _export(prof, log_dir: str) -> None:
    """Write the stopped profiler's trace into JAX's artifact layout."""
    run = os.path.join(log_dir, "plugins", "profile",
                       time.strftime("%Y_%m_%d_%H_%M_%S"))
    os.makedirs(run, exist_ok=True)
    path = os.path.join(run, f"{socket.gethostname()}.trace.json.gz")
    prof.export_chrome_trace(path)


class ProfilerSession:
    """Thread-safe one-at-a-time wrapper over ``torch.profiler``.

    ``start(log_dir)`` / ``stop()`` bracket a capture by hand (the HTTP
    endpoint and the CLI use :meth:`capture`, the tools the :meth:`trace`
    context manager). A second ``start`` while a capture runs raises
    :class:`ProfilerBusyError` without touching torch.
    """

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        self._log_dir: str | None = None
        self._t_start = 0.0
        self._registry = registry
        self._prof = None

    @property
    def active(self) -> bool:
        return self._log_dir is not None

    @property
    def log_dir(self) -> str | None:
        return self._log_dir

    def _counter(self):
        reg = self._registry if self._registry is not None \
            else metrics.default()
        return reg.counter("tts_profile_captures_total",
                           "completed on-demand profiler captures")

    # ------------------------------------------------------------ start/stop

    def start(self, log_dir: str | os.PathLike) -> str:
        """Begin a capture into `log_dir` (created if needed); returns the
        artifact root. Raises ProfilerBusyError when one is already
        running, never disturbing it."""
        if not self._lock.acquire(blocking=False):
            raise ProfilerBusyError(
                f"a profiler capture is already running "
                f"(into {self._log_dir!r})")
        log_dir = os.fspath(log_dir)
        try:
            os.makedirs(log_dir, exist_ok=True)
            prof = _profile()
            prof.start()
        except BaseException:
            self._lock.release()
            raise
        self._prof = prof
        self._log_dir = log_dir
        self._t_start = time.monotonic()
        return log_dir

    def stop(self) -> str:
        """End the running capture and export its trace; returns the
        artifact root (the directory ``load_profile_trace`` reads).
        Raises RuntimeError when no capture is running."""
        if self._log_dir is None:
            raise RuntimeError("no profiler capture is running")
        log_dir, prof = self._log_dir, self._prof
        dur = time.monotonic() - self._t_start
        try:
            prof.stop()
            _export(prof, log_dir)
        finally:
            self._prof = None
            self._log_dir = None
            self._lock.release()
        tracelog.event("profiler.capture", logdir=log_dir,
                       duration_s=round(dur, 3))
        self._counter().inc()
        return log_dir

    # ------------------------------------------------------------ high level

    @contextlib.contextmanager
    def trace(self, log_dir: str | os.PathLike):
        """Capture around a code block (the tools' idiom: warm up, then
        trace exactly the timed window)."""
        self.start(log_dir)
        try:
            yield
        finally:
            self.stop()

    def capture(self, duration_s: float,
                log_dir: str | os.PathLike) -> str:
        """Timed capture: start, sleep `duration_s` while the workload
        runs on its own threads, stop. Returns the artifact root. The
        primitive behind ``POST /profile``: whatever the process runs in
        the window lands in the trace."""
        self.start(log_dir)
        try:
            time.sleep(max(float(duration_s), 0.0))
        finally:
            log_dir = self.stop()
        return log_dir

    def fresh_dir(self, root: str | os.PathLike) -> str:
        """A unique capture directory under `root` (each capture gets its
        own, so artifacts never interleave). The directory is CREATED
        here, a reservation and not just a name, so two racing callers
        are never handed the same path."""
        root = os.fspath(root)
        os.makedirs(root, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        base = os.path.join(root, f"capture-{stamp}")
        path, n = base, 0
        while True:
            try:
                os.makedirs(path, exist_ok=False)
                return path
            except FileExistsError:
                n += 1
                path = f"{base}-{n}"


# ------------------------------------------------------- process singleton

_session: ProfilerSession | None = None
_session_lock = threading.Lock()


def session() -> ProfilerSession:
    """THE process-wide profiler session (torch's profiler is global, so
    its guard must be too)."""
    global _session
    with _session_lock:
        if _session is None:
            _session = ProfilerSession()
        return _session


def trace(log_dir: str | os.PathLike):
    """``session().trace(...)``, the tools' one-liner."""
    return session().trace(log_dir)


def capture(duration_s: float, log_dir: str | os.PathLike) -> str:
    """``session().capture(...)``: timed capture on demand."""
    return session().capture(duration_s, log_dir)
