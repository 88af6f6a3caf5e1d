"""Resource sampler: device-memory and host-RSS gauges + trace lanes.

Reproduces `tpu_tree_search/obs/resource.py` (`ResourceSampler`,
`sample_now`, `GAUGES`): the same gauges, help strings, labels and
`resource.sample` trace events. A :class:`ResourceSampler` publishes,
per device of `utils/device_info.memory_snapshot`,

- ``tts_device_bytes_in_use{device=,platform=}``: a card's allocated
  bytes (`torch.cuda.memory_stats`), or on the CPU the process's
  resident set (JAX sums its live arrays there; see `utils/device_info`);
- ``tts_device_bytes_peak{device=,platform=}``: the caching allocator's
  peak on a card, else the high-water of this process's samples;
- ``tts_device_bytes_limit{device=,platform=}``: the card's memory
  (absent on the CPU);
- ``tts_host_rss_bytes``: the process's resident set

into a metrics registry, and records each sweep as a
``resource.sample`` event in the trace log (memory lanes next to the
pool/steal lanes of a traced run).

Two ways to drive it: a daemon thread on a fixed cadence (the serve
path: the search server owns one and retires its series on close), or
one-shot :func:`sample_now` calls (`engine/distributed.search` samples
at every segment's heartbeat, so a traced run gets a per-segment memory
timeline). Device introspection itself lives in `utils/device_info.py`.
"""

from __future__ import annotations

import threading

from ..utils import device_info
from . import metrics, tracelog

__all__ = ["ResourceSampler", "sample_now", "GAUGES"]

# every gauge a sampler writes — retired per-sampler via retire()
GAUGES = ("tts_device_bytes_in_use", "tts_device_bytes_peak",
          "tts_device_bytes_limit", "tts_host_rss_bytes")

# peak-allocation high-water per device id, PROCESS-wide: the peak is a
# fact about the process's allocator, not about whichever sampler (or
# registry) happened to observe it, so one-shot heartbeat samples and
# per-server daemon samplers accumulate into the same table
_PEAKS: dict[str, int] = {}
_PEAKS_LOCK = threading.Lock()

# daemon samplers currently running in this process. While one is
# active, one-shot heartbeat sweeps (sample_now) record their trace
# event but skip the gauge writes: the serve-session /metrics
# concatenates the server registry and the process-global one, and the
# same series name appearing in both is an invalid Prometheus
# exposition (duplicate samples).
_ACTIVE_DAEMONS = 0


class ResourceSampler:
    """Periodic (or on-demand) device-memory / host-RSS publisher.

    `registry` defaults to the process-global one; the search server
    passes its per-server registry so ``/metrics`` carries the gauges.
    `period_s <= 0` disables the thread — :meth:`sample` still works
    on demand. `platform` ("cpu", "gpu" or None) is the backend whose
    memory is read (`utils/device_info.memory_snapshot`).
    """

    def __init__(self, registry=None, period_s: float = 0.0,
                 trace: bool = True, autostart: bool = True,
                 platform: str | None = None):
        self.registry = registry if registry is not None \
            else metrics.default()
        self.period_s = float(period_s)
        self.platform = platform
        self.trace = trace
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._g_use = self.registry.gauge(
            "tts_device_bytes_in_use",
            "per-device live allocation (backend memory_stats, or live "
            "jax-array bytes where the backend reports none)")
        self._g_peak = self.registry.gauge(
            "tts_device_bytes_peak",
            "per-device peak allocation (backend-reported, else the "
            "high-water of this process's samples)")
        self._g_limit = self.registry.gauge(
            "tts_device_bytes_limit",
            "per-device allocator budget (absent without one)")
        self._g_rss = self.registry.gauge(
            "tts_host_rss_bytes", "host process resident set size")
        if autostart and self.period_s > 0:
            self.start()

    # ------------------------------------------------------------- sampling

    def sample(self, publish: bool = True) -> dict:
        """One sweep: read, publish gauges (unless ``publish=False`` —
        trace event only), record the trace event. Returns the sample
        (the heartbeat hook forwards it)."""
        devices = device_info.memory_snapshot(self.platform)
        rss = device_info.host_rss_bytes()
        with self._lock:
            for d in devices:
                key = str(d["id"])
                labels = {"device": key, "platform": d["platform"]}
                use = d.get("bytes_in_use")
                if use is not None:
                    peak = d.get("peak_bytes_in_use")
                    with _PEAKS_LOCK:
                        if peak is None:
                            peak = max(_PEAKS.get(key, 0), use)
                        _PEAKS[key] = max(_PEAKS.get(key, 0), peak)
                    d["peak_bytes_in_use"] = peak
                    if publish:
                        self._g_use.set(use, **labels)
                        self._g_peak.set(peak, **labels)
                if publish and d.get("bytes_limit") is not None:
                    self._g_limit.set(d["bytes_limit"], **labels)
            if publish and rss is not None:
                self._g_rss.set(rss)
        sample = {"host_rss_bytes": rss, "devices": devices}
        if self.trace:
            tracelog.event("resource.sample", **sample)
        return sample

    # -------------------------------------------------------------- thread

    def start(self) -> None:
        global _ACTIVE_DAEMONS
        with self._lock:
            if self._thread is not None or self.period_s <= 0:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="tts-resource-sampler")
            with _PEAKS_LOCK:
                _ACTIVE_DAEMONS += 1
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 — a failed sweep (backend
                pass           # racing shutdown) must not kill the thread

    def stop(self) -> None:
        global _ACTIVE_DAEMONS
        self._stop.set()
        th = self._thread
        if th is not None:
            th.join(timeout=5)
            with _PEAKS_LOCK:
                _ACTIVE_DAEMONS -= 1
        self._thread = None

    def retire(self) -> None:
        """Drop every series this sampler published (the cardinality
        valve the server pulls on close, same rule as the per-request
        phase/telemetry series)."""
        for name in GAUGES:
            self.registry.remove_matching(name)

    def close(self) -> None:
        self.stop()
        self.retire()


# cached one-shot samplers for the heartbeat hook (sample_now fires
# once per segment — no per-sweep object construction on that path).
# The scratch instance exists because even CREATING the gauges in the
# exposed default registry would add duplicate # TYPE lines next to a
# daemon's registry; its registry is never exposed anywhere.
_oneshot: "ResourceSampler | None" = None
_scratch: "ResourceSampler | None" = None


def sample_now(registry=None, trace: bool = True,
               platform: str | None = None) -> dict:
    """One-shot sweep into `registry` (default: the process-global one)
    — the segmented engine's heartbeat hook, which names its workers'
    `platform` (a search on CPU workers samples the CPU on a host with
    cards too). While a daemon sampler is active in the process (a
    serve session), the sweep records only the trace event: the daemon
    owns the gauges, and the same series in two exposed registries
    would be an invalid exposition."""
    global _oneshot, _scratch
    with _PEAKS_LOCK:
        publish = _ACTIVE_DAEMONS == 0
    if registry is not None:
        return ResourceSampler(registry=registry, period_s=0.0,
                               trace=trace, autostart=False,
                               platform=platform).sample(publish=publish)
    if not publish:
        if _scratch is None:
            _scratch = ResourceSampler(registry=metrics.Registry(
                "scratch"), period_s=0.0, autostart=False)
        sampler = _scratch
    else:
        # re-resolve when tests swap the process-global registry
        if _oneshot is None \
                or _oneshot.registry is not metrics.default():
            _oneshot = ResourceSampler(period_s=0.0, autostart=False)
        sampler = _oneshot
    sampler.trace, sampler.platform = trace, platform
    return sampler.sample(publish=publish)
