"""In-process asynchronous search server.

Reproduces `tpu_tree_search/service/server.py` (`SearchServer`, `_Slot`):
admission, the scheduler (`_tick`: deadlines, dispatch, preemption), the
executor threads (`_dispatch`/`_execute`, `_on_finished`), the retry tier
(`_handle_dispatch_failure` with the remediation verdict), megabatching
(`_tick_megabatch`, `_dispatch_batch`, `_execute_batch`,
`_on_batch_finished`), boot pre-warm (`prewarm_boot`), the remediation
hooks, and the observability wiring (`ResourceSampler`, `HealthMonitor`,
`ObsStore` under TTS_OBS_STORE, `LaneLedger`/`CapacityModel` under
TTS_CAPACITY, a `ProgressEstimator` per request under TTS_PROGRESS), and
the durability layer: the request ledger (`ledger_dir`, TTS_LEDGER:
`_replay_boot`, `_readmit_replayed`, a `journal` call at every state
transition JAX journals), fleet failover (`fleet_dir`, TTS_FLEET_DIR, a
fenced lease and a `FailoverWatcher`; `adopt_ledger`, `_self_fence`, the
lease epoch stamped on every checkpoint), portfolio racing (`portfolio`
>= 2, TTS_PORTFOLIO: `_submit_portfolio` and the `PortfolioCoordinator`)
and `journeys()`, with JAX's request and status snapshots.

Architecture::

    submit() --admission--> RequestQueue --scheduler--> submesh slots
                                              |             |
                                        preempt/deadline    executor thread
                                              |             per dispatch:
                                        stop_event ----> distributed.search
                                                          (segmented, ckpt)

- The workers (`devices`, by default every visible card) are partitioned
  into equal submeshes (`parallel/mesh.partition_submeshes`); each serves
  one request at a time with the unmodified engine, so a served request's
  counts are those of a standalone `distributed.search` on that many
  workers. A slot's `device_ids` are its workers' positions in the list,
  as JAX's device ids are, and name it in the executor-cache keys.
- The scheduler thread assigns the highest-priority queued request to a
  free submesh, stops over-deadline requests and preempts a running
  lower-priority request when a higher-priority one waits with no free
  submesh. Stops land at segment boundaries; the stopped state is
  checkpointed first, so a preempted request resumes, on any submesh.
- The executor cache (`service/executors.py`) holds one loop a key:
  every instance of a class served at one bound on one submesh replays the
  graph the first request captured (serve many, capture once).
- A failed dispatch (a transient error escaping the engine's own retry
  tier) re-dispatches the request with exponential backoff;
  `service_retry_attempts` failures turn it FAILED.

Executor threads and CUDA graphs: each dispatch runs on a thread of its
own, so one thread may capture while another replays or steps eagerly.
Captures are serialized by `engine/device.CAPTURE_LOCK` (the kernels'
capture counts and the graph cache are process-wide) and each checks only
its own thread (`capture_error_mode="thread_local"`), so the other
threads' work during it does not invalidate it.

Durability on the card: `journal()` fsyncs on the scheduler and executor
threads, which also replay CUDA graphs; as in JAX it runs at the same
transitions and under the same lock. A hard kill during a replay loses only
that segment: the restart resumes from the last complete checkpoint
(`checkpoint.load_resilient`, its `.prev` fallback).

Left out, refusing with `NotImplementedError` naming ROADMAP A9d: the disk
executor cache (`aot_cache_dir`, TTS_AOT_CACHE); its snapshot key
(`aot_cache`) is None, as in JAX while it is off. The `ledger`, `failover`
and `portfolio` keys are None while those parts are off, as in JAX.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import pathlib
import shutil
import socket
import tempfile
import threading
import time

import numpy as np

from ..obs import capacity as obs_capacity
from ..obs import health as obs_health
from ..obs import metrics as obs_metrics
from ..obs import resource as obs_resource
from ..obs import store as obs_store_mod
from ..obs import tracelog
from ..utils import config as cfg
from ..utils import faults
from ..utils.retry import backoff_delay
from .executors import ExecutorCache
from .lease import LeaseLost
from .queueing import AdmissionError, AdmissionPaused, RequestQueue
from .request import (CANCELLED, DEADLINE, DONE, FAILED, FAILURE_LOG_CAP,
                      PREEMPTED, QUEUED, RUNNING, TERMINAL_STATES,
                      RequestRecord, SearchRequest)

__all__ = ["SearchServer", "AdmissionError", "SearchRequest"]


def _prior_spent_s(checkpoint_path: str) -> float:
    """Accumulated execution seconds recorded in an existing checkpoint
    under this tag (the `spent_s` meta key both the service and the
    legacy campaign worker write), or 0.0 when there is none / it is
    unreadable — budget continuity must never block a submission."""
    for cand in (checkpoint_path, checkpoint_path + ".prev"):
        try:
            with np.load(cand) as z:
                return float(z["meta_spent_s"])
        except Exception:  # noqa: BLE001 — missing/torn/legacy file
            continue
    return 0.0


def _prior_progress_est(checkpoint_path: str) -> list | None:
    """Progress-estimator state vector (obs/estimate's to_list) riding
    an existing checkpoint under this tag, or None when there is none /
    it predates the estimator — like spent_s, estimate continuity must
    never block a submission."""
    for cand in (checkpoint_path, checkpoint_path + ".prev"):
        try:
            with np.load(cand) as z:
                return [float(x) for x in z["meta_progress_est"]]
        except Exception:  # noqa: BLE001 — missing/torn/pre-estimator
            continue
    return None


class _Slot:
    """One submesh (its worker devices, and their positions in the
    server's device list, `device_ids`) and the request running on it."""

    def __init__(self, index: int, devices: list, device_ids: list):
        self.index = index
        self.devices = list(devices)
        self.device_ids = [int(i) for i in device_ids]
        self.record: RequestRecord | None = None
        # megabatch occupancy: the full member list of a batched
        # dispatch (record stays the first member so single-request
        # readers keep working); None for a solo dispatch
        self.batch: list | None = None
        self.thread: threading.Thread | None = None
        self.stop_event: threading.Event | None = None
        # submesh quarantine (service/remediate): a quarantined slot is
        # held out of the partition — the scheduler never dispatches to
        # it — until the controller's canary probe readmits it
        self.quarantined: bool = False
        self.quarantined_since: float | None = None
        self.quarantine_reason: str | None = None

    @property
    def records(self) -> list:
        """Every request occupying this slot — the batch member list
        under a batched dispatch, the single record solo, [] free.
        THE slot-occupancy enumeration (close/deadline/heartbeat paths
        all iterate it; hand-rolled copies drift)."""
        if self.batch is not None:
            return self.batch
        return [self.record] if self.record is not None else []


class SearchServer:
    """Async search-as-a-service over a partitioned device mesh.

    Lifecycle: construct (optionally inside a ``with`` block), `submit()`
    requests, `status()`/`result()` them, `close()`. The scheduler
    thread starts immediately unless ``autostart=False`` (submissions
    then queue up until `start()` — useful for admission-control tests
    and for pre-loading a batch before serving begins).

    `devices` are the workers (torch devices, repeats allowed: several
    workers on one card, or on the CPU); None takes every visible card.
    """

    def __init__(self, n_submeshes: int = 1, devices=None,
                 workdir: str | None = None,
                 max_queue_depth: int = cfg.SERVICE_QUEUE_DEPTH_DEFAULT,
                 segment_iters: int = cfg.SERVICE_SEGMENT_ITERS_DEFAULT,
                 checkpoint_every: int = cfg.SERVICE_CHECKPOINT_EVERY_DEFAULT,
                 poll_s: float = cfg.SERVICE_POLL_S_DEFAULT,
                 service_retry_attempts: int =
                 cfg.SERVICE_RETRY_ATTEMPTS_DEFAULT,
                 service_retry_base_s: float =
                 cfg.SERVICE_RETRY_BASE_S_DEFAULT,
                 autostart: bool = True,
                 phase_profile=None,
                 resource_sample_s: float | None = None,
                 health_interval_s: float | None = None,
                 overlap: bool | None = None,
                 share_incumbent: bool | None = None,
                 aot_cache_dir: str | None = None,
                 tune_cache_dir: str | None = None,
                 tune_at_boot: bool | None = None,
                 remediate: bool | None = None,
                 ledger_dir: str | None = None,
                 fleet_dir: str | None = None,
                 failover: bool | None = None,
                 megabatch: bool | None = None,
                 batch_max: int | None = None,
                 batch_age_s: float | None = None):
        from ..engine.distributed import _not_ported
        from ..parallel.mesh import partition_submeshes

        # the part still to port, refused before anything starts
        if aot_cache_dir or cfg.env_str(cfg.AOT_CACHE_ENV):
            raise _not_ported(
                "the disk executor cache (aot_cache_dir, TTS_AOT_CACHE)",
                "A9d", "SearchServer")
        groups = partition_submeshes(n_submeshes, devices=devices)
        per = len(groups[0])
        self.slots = [_Slot(i, g, range(i * per, (i + 1) * per))
                      for i, g in enumerate(groups)]
        # resolved EARLY because the workdir default depends on it:
        # durability needs checkpoints that survive the restart, so a
        # ledger server without an explicit workdir keeps them UNDER
        # the ledger dir (a fresh temp dir per lifetime would replay
        # budgets but restart every search from its root)
        if ledger_dir is None:
            ledger_dir = cfg.env_str(cfg.LEDGER_ENV)
        if workdir is None and ledger_dir:
            workdir = os.path.join(ledger_dir, "workdir")
        self.workdir = pathlib.Path(
            workdir if workdir is not None
            else tempfile.mkdtemp(prefix="tts_service_"))
        self.workdir.mkdir(parents=True, exist_ok=True)
        # Per-SERVER metrics registry (obs/metrics): request/queue/cache
        # metrics must not bleed between servers in one process (the
        # test suite runs many); engine-level metrics (checkpoints,
        # retries, faults) stay in the process-global default registry.
        self.metrics = obs_metrics.Registry("tts_service")
        self._m_submitted = self.metrics.counter(
            "tts_requests_submitted_total", "requests admitted")
        self._m_terminal = self.metrics.counter(
            "tts_requests_total", "requests by terminal state")
        self._m_preempt = self.metrics.counter(
            "tts_preemptions_total",
            "running requests stopped and checkpointed for requeue")
        self._m_redispatch = self.metrics.counter(
            "tts_redispatches_total",
            "submesh-failure re-dispatches (retry tier)")
        self._m_spent = self.metrics.histogram(
            "tts_request_spent_seconds",
            "accumulated execution time of terminal requests")
        self._m_queue_wait = self.metrics.histogram(
            "tts_queue_wait_seconds",
            "admit/requeue -> dispatch wait by accounting tenant (the "
            "health layer's queue_wait SLO reads its windowed "
            "all-tenants p99)")
        self._m_drain_idle = self.metrics.histogram(
            "tts_batch_drain_idle_seconds",
            "per closed megabatch: lane-seconds members sat frozen "
            "waiting for batchmates to drain (the continuous-batching "
            "motivation number)")
        # under megabatching, requests waiting in the batch-former are
        # still WAITING — the depth gauge (and the admission bound in
        # submit()) must count them, or an overloaded megabatch server
        # would read as idle while its former grows without bound
        self.metrics.gauge(
            "tts_queue_depth", "requests waiting for a submesh"
            ).set_fn(lambda: len(self.queue)
                     + (len(self.former)
                        if getattr(self, "former", None) is not None
                        else 0))
        # a gauge (callback over queue.rejected), so no `_total` suffix:
        # the counter convention would promise rate()-safe reset
        # detection this scrape-time mirror cannot give
        self.metrics.gauge(
            "tts_queue_rejected",
            "admission-control rejections (validation/overflow/closed)"
            ).set_fn(lambda: self.queue.rejected)
        self.metrics.gauge(
            "tts_queue_peak_depth",
            "high-water queue depth since server start"
            ).set_fn(lambda: self.queue.peak_depth)
        self.metrics.gauge(
            "tts_submeshes", "submesh slots partitioned at startup"
            ).set_fn(lambda: len(self.slots))
        self.metrics.gauge(
            "tts_submeshes_busy", "submeshes currently running a request"
            ).set_fn(lambda: sum(1 for s in self.slots
                                 if s.record is not None))
        self.queue = RequestQueue(max_queue_depth)
        self.cache = ExecutorCache(registry=self.metrics)
        # adaptive dispatch (tune/): the Autotuner resolves a request's
        # OPEN knobs (chunk=None / balance_period=None) from the
        # persistent tuning cache, falling back to the measured-
        # defaults table — never probing on the request path. Probing
        # happens at boot (prewarm_boot with tune_at_boot / TTS_TUNE);
        # a warm cache dir replays with zero probes.
        if tune_cache_dir is None:
            tune_cache_dir = cfg.env_str(cfg.TUNE_CACHE_ENV)
        self.tune_at_boot = (cfg.env_flag(cfg.TUNE_ENV)
                             if tune_at_boot is None
                             else bool(tune_at_boot))
        self.tuner = None
        if tune_cache_dir or self.tune_at_boot:
            from ..tune import Autotuner
            tune_dev = self.slots[0].devices[0]
            try:
                self.tuner = Autotuner(cache_dir=tune_cache_dir,
                                       registry=self.metrics,
                                       device=tune_dev)
            except OSError as e:
                # an unusable cache dir degrades to an IN-MEMORY tuner
                # (boot probes still work, they just don't persist)
                tracelog.event(
                    "tuner.cache_disabled", dir=str(tune_cache_dir),
                    reason=f"tune cache dir unusable: {e!r}; tuned "
                           "optima live in-process only this lifetime")
                self.tuner = Autotuner(registry=self.metrics,
                                       device=tune_dev)
            if not tune_cache_dir:
                # --tune without --tune-cache must still probe at boot
                # (in-process memo only) — a documented flag that
                # silently did nothing would be a dead kill-switch
                tracelog.event(
                    "tuner.memory_only",
                    reason="tune_at_boot without a tune cache dir: "
                           "probed optima are not persisted")
        # resource observability: per-device bytes-in-use/peak + host
        # RSS gauges on THIS server's registry (so /metrics carries
        # them) plus memory counter lanes in the trace log; the daemon
        # thread samples on its own cadence, close() retires the series
        if resource_sample_s is None:
            resource_sample_s = cfg.env_float("TTS_RESOURCE_SAMPLE_S")
        self.resources = obs_resource.ResourceSampler(
            registry=self.metrics, period_s=resource_sample_s,
            platform=("gpu" if self.slots[0].devices[0].type == "cuda"
                      else "cpu"))
        if resource_sample_s > 0:
            # one sweep up front: the gauges must exist from the first
            # scrape, not only after the first period elapses
            try:
                self.resources.sample()
            except Exception:  # noqa: BLE001 — observability extra
                pass
        # Raw-speed knobs (None = the TTS_OVERLAP / TTS_SHARE_INCUMBENT
        # env flags). `overlap` pipelines every served request's
        # segments (async counter fetch + writer-thread checkpoints —
        # engine/checkpoint's overlapped driver); `share_incumbent`
        # builds the process-wide best-bound board so concurrent
        # same-instance requests tighten each other's pruning
        # (engine/incumbent.py — the reference's MPI best-makespan
        # exchange, served-form).
        self.overlap = (cfg.env_flag(cfg.OVERLAP_FLAG)
                        if overlap is None else bool(overlap))
        if share_incumbent is None:
            share_incumbent = cfg.env_flag(cfg.SHARE_INCUMBENT_FLAG)
        self.incumbents = None
        if share_incumbent:
            from ..engine.incumbent import IncumbentBoard
            self.incumbents = IncumbentBoard()
        # Request megabatching (engine/megabatch + service/batching):
        # the admission queue becomes a batch-former — same-shape-class
        # requests run as ONE batched loop per submesh.
        # Default off (TTS_MEGABATCH) = the solo scheduler exactly;
        # every batched request is bit-identical to its solo run.
        self.megabatch = (cfg.env_flag(cfg.MEGABATCH_FLAG)
                          if megabatch is None else bool(megabatch))
        self.former = None
        if self.megabatch:
            from .batching import BatchFormer
            self.former = BatchFormer(
                batch_max if batch_max is not None
                else cfg.env_int("TTS_BATCH_MAX"),
                batch_age_s if batch_age_s is not None
                else cfg.env_float("TTS_BATCH_AGE_S"))
        self._batch_seq = itertools.count()
        self._m_batches = self.metrics.counter(
            "tts_batches_formed_total",
            "batches closed by the former (reason=size|age)")
        self._m_batch_size = self.metrics.histogram(
            "tts_batch_size", "requests per closed batch",
            # integer-size buckets: the latency default (0.001..300 s)
            # would fold every size 3..8 batch into one le=10 bucket
            buckets=(1, 2, 4, 8, 16, 32, 64, 128))
        self._m_batch_req = self.metrics.counter(
            "tts_batch_requests_total",
            "requests dispatched through a multi-request batch")
        self.segment_iters = segment_iters
        self.checkpoint_every = checkpoint_every
        self.poll_s = poll_s
        self.service_retry_attempts = service_retry_attempts
        self.service_retry_base_s = service_retry_base_s
        # live per-worker phase attribution (utils/phase_timing): None
        # = off; a {"bound","step","compact","per_eval"} unit-cost dict
        # = attribute every heartbeat with it; True = MEASURE unit costs
        # once per (shape, lb, chunk) on first dispatch (adds seconds of
        # profiling to that dispatch — an opt-in production knob)
        self.phase_profile = phase_profile
        self._prof_cache: dict[tuple, dict] = {}
        # online progress/ETA estimation (obs/estimate; static, read
        # once): off = NO estimator objects, gauges, snapshot keys,
        # checkpoint-meta keys or predictive rules — bit-identical to
        # the pre-estimator server
        self.progress_enabled = cfg.env_flag("TTS_PROGRESS")
        # fleet capacity & utilization (obs/capacity; static, read
        # once): off = NO lane ledger, capacity model, lane events/
        # counters, capacity gauges, snapshot key or saturation rule —
        # bit-identical to the pre-capacity server. Constructed after
        # the obs store resume below so a restarted server seeds lane
        # history from the replayed counters.
        self.capacity_enabled = cfg.env_flag("TTS_CAPACITY")
        self.lane_ledger = None
        self.capacity = None
        self.records: dict[str, RequestRecord] = {}  # guarded-by: self._lock
        self._lock = threading.RLock()
        self._seq = itertools.count()
        self._t0 = time.monotonic()
        self._closing = threading.Event()
        self._scheduler: threading.Thread | None = None
        # the operational judge (obs/health): SLO/anomaly rules over
        # this server's registries + snapshot on a daemon interval,
        # surfaced as tts_alerts gauges and alert.* events.
        # interval None resolves to TTS_HEALTH_INTERVAL_S inside the
        # monitor; <= 0 disables the daemon (evaluate_now() still
        # works for tests).
        self.health = obs_health.HealthMonitor(
            server=self, registry=self.metrics,
            interval_s=health_interval_s)
        # admission pause valve (the remediation controller's
        # compile_storm action; None = admitting). A paused server
        # REJECTS submit() with the reason while the file spool holds
        # its backlog unserved
        self._paused_reason: str | None = None  # guarded-by: self._lock
        # self-healing (service/remediate): subscribes to the monitor
        # above, so it must construct after it. remediate=None resolves
        # TTS_REMEDIATE; the default (off) is OBSERVE-ONLY — detection
        # and journaling run, zero actions are taken, behavior is
        # bit-identical to the pre-remediation server
        from .remediate import RemediationController
        self.remediation = RemediationController(
            self, enabled=remediate, registry=self.metrics)
        # bound-portfolio racing (service/portfolio): always constructed
        # (a pure coordination object; zero cost when no request carries
        # `portfolio`). Must exist BEFORE the ledger replays: replayed
        # races reconcile through it.
        from .portfolio import PortfolioCoordinator
        self.portfolio = PortfolioCoordinator(self)
        # crash-safe serving (service/ledger): a write-ahead journal of
        # every request state transition, replayed here at boot so a
        # hard-killed server's queued and active requests are admitted
        # again with budgets, exclusions and failure logs intact,
        # terminal results are served again without a solve, and
        # standing quarantines and admission pauses survive. Unset ->
        # off, and every ledger code path below is vacuous. An unusable
        # ledger dir RAISES instead of degrading: the caller asked for
        # durability. (ledger_dir was resolved at the top: the workdir
        # default depends on it.)
        self.ledger = None
        self.replayed_spool: dict[str, str] = {}
        self._recovered = {"queued": 0, "active": 0, "held": 0,
                           "terminal": 0}
        # fleet failover (service/lease + service/failover): inside a
        # shared fleet root this server's ledger is owned through a
        # fenced LEASE, acquired BEFORE the ledger replays, so a boot
        # against a ledger a live adopter is serving comes up FENCED
        # (serves nothing, commits nothing, exits clean) instead of
        # splitting its brain. Unset fleet dir -> every lease and
        # watcher path below is vacuous.
        if fleet_dir is None:
            fleet_dir = cfg.env_str(cfg.FLEET_DIR_ENV)
        self.lease = None
        self.watcher = None
        self.fenced = False
        self._fence_reason: str | None = None
        self._adopted: list = []    # LeaseKeepers of adopted ledgers
        #                             (kept renewing: a restarted stale
        #                             owner must find a LIVE lease)
        if ledger_dir:
            from .ledger import RequestLedger
            if fleet_dir:
                from .lease import LeaseKeeper
                keeper = LeaseKeeper(ledger_dir, registry=self.metrics,
                                     on_lost=self._self_fence)
                try:
                    keeper.acquire()
                    self.lease = keeper
                except LeaseLost as e:
                    self.fenced = True
                    self._fence_reason = str(e)
                    tracelog.event("failover.boot_fenced",
                                   dir=str(ledger_dir), reason=str(e))
            if not self.fenced:
                self.ledger = RequestLedger(ledger_dir,
                                            registry=self.metrics,
                                            lease=self.lease,
                                            on_fenced=self._self_fence)
                self._replay_boot()
                self.ledger.journal("boot", pid=os.getpid(),
                                    submeshes=len(self.slots))
        # set BEFORE the watcher starts: its takeover thread journals
        # our ledger-dir name as the `adopter` forward pointer
        self._ledger_dir = ledger_dir or None
        self._fleet_dir = fleet_dir or None
        if fleet_dir and not self.fenced:
            from .failover import FailoverWatcher
            self.watcher = FailoverWatcher(
                self, fleet_dir, own_root=ledger_dir,
                act=failover, registry=self.metrics)
            self.watcher.start()
        # flight recorder (obs/store): a durable metric/event store,
        # replayed here so dashboards, health history and whitelisted
        # tts_* counters RESUME across restarts and takeovers, and the
        # slo_* burn rules window over
        # history older than this process. Unset TTS_OBS_STORE -> every
        # store code path below is vacuous — bit-identical (test-pinned)
        self.obs_store = None
        store_dir = cfg.env_str(cfg.OBS_STORE_ENV)
        if store_dir and not self.fenced:
            # the writer id must be STABLE across restarts (counter
            # resume keys on it) and DISTINCT across fleet peers: the
            # host plus the ledger family when there is one
            writer = socket.gethostname()
            if ledger_dir:
                writer += f"-{pathlib.Path(ledger_dir).name}"
            else:
                writer += f"-{os.getpid()}"
            try:
                self.obs_store = obs_store_mod.ObsStore(
                    store_dir, writer, registry=self.metrics,
                    segment_records=cfg.env_int(
                        "TTS_OBS_STORE_SEGMENT_RECORDS"),
                    retain_s=cfg.env_float("TTS_OBS_STORE_RETAIN_S"),
                    queue_depth=cfg.env_int("TTS_OBS_STORE_QUEUE"))
            except OSError as e:
                # an unwritable store degrades to store-less serving —
                # observability must not take the server down (the
                # ledger's opposite stance is about DATA durability)
                tracelog.event("obs_store.disabled", dir=store_dir,
                               error=repr(e))
            if self.obs_store is not None:
                replayed = self.obs_store.records_replayed()
                seeded = obs_store_mod.resume_counters(
                    self.metrics, replayed, self.obs_store.writer)
                self.health.store = self.obs_store
                self.health.seed_history(
                    [r for r in replayed if r.get("k") == "sample"
                     and r.get("w") == self.obs_store.writer])
                tracelog.get().add_listener(self.obs_store.on_trace_event)
                interval = (resource_sample_s
                            if resource_sample_s is not None
                            else cfg.env_float("TTS_RESOURCE_SAMPLE_S"))
                if interval > 0:
                    self.obs_store.start_sampling(self._obs_sample,
                                                  interval)
                tracelog.event(
                    "obs_store.open", dir=store_dir,
                    writer=self.obs_store.writer,
                    replayed=self.obs_store.replayed,
                    truncated=self.obs_store.truncated,
                    counters_seeded=seeded)
        if self.capacity_enabled:
            # AFTER the obs-store resume above: the lane ledger seeds
            # its per-state accumulators from the replayed
            # tts_lane_seconds_total series (store unset = a fresh
            # ledger, same construction)
            self.lane_ledger = obs_capacity.LaneLedger(
                self.metrics, [s.index for s in self.slots])
            for _, key, val in self.metrics.counter(
                    obs_capacity.LANE_SECONDS_METRIC,
                    obs_capacity.LANE_SECONDS_DOC).samples():
                labels = dict(key)
                if "lane" in labels and "state" in labels:
                    try:
                        self.lane_ledger.seed(int(labels["lane"]),
                                              labels["state"],
                                              float(val))
                    except (TypeError, ValueError):
                        pass    # a foreign writer's malformed series
            self.capacity = obs_capacity.CapacityModel(self.metrics)
        tracelog.event("server.start", submeshes=len(self.slots),
                       devices_per_submesh=len(self.slots[0].devices),
                       workdir=str(self.workdir),
                       megabatch=self.megabatch,
                       overlap=self.overlap,
                       share_incumbent=self.incumbents is not None,
                       remediate=self.remediation.enabled,
                       ledger=ledger_dir or None,
                       fleet_dir=fleet_dir or None,
                       fenced=self.fenced)
        if autostart:
            self.start()

    @property
    def counters(self) -> dict:
        """Lifecycle counters, now a VIEW over the metrics registry (the
        pre-obs hand-rolled dict, kept as the JSON snapshot schema and
        for callers that read e.g. ``srv.counters["preemptions"]``)."""
        t = self._m_terminal
        # value_matching, not value: terminal series carry a tenant
        # label, so the lifecycle view sums across tenants
        return {"submitted": int(self._m_submitted.value()),
                "done": int(t.value_matching(state="done")),
                "cancelled": int(t.value_matching(state="cancelled")),
                "deadline": int(t.value_matching(state="deadline")),
                "failed": int(t.value_matching(state="failed")),
                "preemptions": int(self._m_preempt.value()),
                "redispatches": int(self._m_redispatch.value())}

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        with self._lock:
            if self._scheduler is None and not self._closing.is_set():
                self._scheduler = threading.Thread(
                    target=self._scheduler_loop, daemon=True,
                    name="tts-service-scheduler")
                self._scheduler.start()

    def close(self, wait: bool = True) -> None:
        """Stop serving: running requests are stopped at their next
        segment boundary and left PREEMPTED with a fresh checkpoint (a
        new server with the same workdir + tags resumes them); queued
        requests are CANCELLED, except under a ledger, where they stay
        QUEUED: a ledger server's shutdown is a DRAIN, and its backlog
        is admitted again on the next boot. Unblocks every `result()`
        waiter either way."""
        if not self._closing.is_set():
            tracelog.event("server.close")
        self._closing.set()
        with self._lock:
            for slot in self.slots:
                for rec in slot.records:
                    if rec.stop_reason is None:
                        rec.stop_reason = "shutdown"
                if slot.records and slot.stop_event is not None:
                    slot.stop_event.set()
            if self.former is not None:
                # held batch members are live admitted requests: hand
                # them back to the record loop below (CANCELLED without
                # a ledger, kept QUEUED for replay with one)
                self.former.drain()
        if wait:
            if self._scheduler is not None:
                self._scheduler.join()
            for slot in self.slots:
                th = slot.thread
                if th is not None:
                    th.join()
        with self._lock:
            for rec in self.records.values():
                if rec.state == QUEUED and self.ledger is None:
                    self._finalize(rec, CANCELLED, error="server shutdown")
                rec.done_event.set()
        # the failover watcher stops scanning before the lease goes
        if self.watcher is not None:
            self.watcher.close()
        # stop the resource sampler and retire its gauge series — a
        # closed server must not keep publishing (or holding) them
        self.resources.close()
        # same valve for the health daemon and its tts_alerts series
        self.health.close()
        # close the lane ledger's final open intervals into the counter
        # (BEFORE the obs store's last sample below, so the persisted
        # lane seconds include them) and retire the capacity gauges
        if self.lane_ledger is not None:
            for slot in self.slots:
                self._lane_sync(slot)
            self.lane_ledger.flush()
        if self.capacity is not None:
            self.capacity.close()
        # and the remediation worker (its journal stays readable)
        self.remediation.close()
        # the ledger closes after every executor thread's final
        # preempt/terminal record landed: a `drain` marker stamps the
        # shutdown as graceful (its absence at replay = a hard kill)
        if self.ledger is not None:
            self.ledger.journal("drain", pid=os.getpid())
            self.ledger.close()
        # release leases: our own (marked `released` so peers do not
        # adopt a cleanly drained ledger; a fenced keeper leaves the file
        # to its adopter) and every adopted orphan's
        if self.lease is not None:
            self.lease.release()
        for keeper in self._adopted:
            keeper.release()
        # the obs store drains LAST so the close-path events above
        # (server.close, lease.released) are on disk for the next
        # lifetime's replay
        if self.obs_store is not None:
            if self.lane_ledger is not None:
                # one final sample so the just-flushed lane counters
                # land on disk for the next lifetime's ledger seed (a
                # kill -9 keeps the last periodic sample instead —
                # conservation then counts the lost tail as replayed
                # time it never saw, which is exactly the truth)
                self.obs_store.sample_now(self._obs_sample)
            tracelog.get().remove_listener(self.obs_store.on_trace_event)
            self.obs_store.flush()
            self.obs_store.close()

    def _obs_sample(self) -> dict:
        """One durable metrics snapshot (obs/store `sample` record):
        whitelisted counters (the resume set), the history-ring gauge
        signals, and the health rings' latest values."""
        counters, gauges = [], []
        if self.lane_ledger is not None:
            # close open lane intervals into the counter first, so the
            # persisted lane seconds are current as of this sample
            self.lane_ledger.flush()
        for m in self.metrics.metrics():
            if m.kind == "counter" \
                    and m.name in obs_store_mod.RESUME_COUNTERS:
                counters.extend([n, dict(k), v]
                                for n, k, v in m.samples())
        for reg in (self.metrics, obs_metrics.default()):
            for m in reg.metrics():
                if m.kind == "gauge" \
                        and m.name in obs_store_mod.SAMPLE_GAUGES:
                    gauges.extend([n, dict(k), v]
                                  for n, k, v in m.samples())
        return {"counters": counters, "gauges": gauges,
                "history": self.health.history_sample()}

    def journeys(self, tag: str | None = None) -> list[dict]:
        """Stitched request journeys (obs/journey) over this server's
        ledger, every fleet peer's ledger, and the durable store."""
        from ..obs import journey as journey_mod
        store_dir = (str(self.obs_store.root)
                     if self.obs_store is not None else None)
        return journey_mod.find_journeys(
            ledger_dirs=[self._ledger_dir] if self._ledger_dir else [],
            fleet_dir=self._fleet_dir, store=store_dir, tag=tag)

    def __enter__(self) -> "SearchServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ client API

    def submit(self, request: SearchRequest, *,
               spool_id: str | None = None,
               _portfolio_member: bool = False) -> str:
        """Admit a request; returns its id. Raises AdmissionError (with
        `.reason`) when the queue is full, the request is invalid, or
        the server is closed — rejection is immediate and explicit, the
        client never learns about overload from a timeout.

        With a ledger, admission is a DURABILITY promise: the admit
        record is journaled (fsync'd) before this returns, so a request
        acknowledged here survives an immediate hard kill. A tag whose
        recorded terminal is DONE re-serves idempotently: the original
        request id is returned with its recorded result instead of
        re-solving. `spool_id`
        (the file-spool front-end's id) rides the admit record so a
        restarted serve loop can reconnect result-file delivery."""
        if self._closing.is_set():
            self.queue.rejected += 1
            tracelog.event("request.reject", reason="server closed")
            raise AdmissionError("server closed")
        if self.fenced:
            # a fenced server owns nothing: its ledger belongs to an
            # adopter, so an admission here could never be durable —
            # the typed refusal tells the client to resubmit to the
            # peer that holds the lease
            self.queue.rejected += 1
            tracelog.event("request.reject",
                           reason=f"fenced: {self._fence_reason}")
            raise LeaseLost(f"server fenced: {self._fence_reason}")
        paused = self.admission_paused()
        if paused is not None:
            # the remediation controller's compile_storm valve: an
            # explicit retry-later rejection (the typed subclass tells
            # the spool to HOLD), cleared when the alert resolves
            self.queue.rejected += 1
            tracelog.event("request.reject",
                           reason=f"admission paused: {paused}")
            raise AdmissionPaused(f"admission paused: {paused}")
        reason = request.validate()
        if reason is not None:
            self.queue.rejected += 1
            tracelog.event("request.reject",
                           reason=f"invalid request: {reason}")
            raise AdmissionError(f"invalid request: {reason}")
        if not _portfolio_member:
            # bound-portfolio racing: an explicit `portfolio: K` (or
            # the TTS_PORTFOLIO server default, capped at the
            # admission bound) fans out instead of queueing. Members
            # resubmit through this method with the guard flag — the
            # env default must not fan a member out recursively
            k = request.portfolio
            if k is None:
                k = cfg.env_int(cfg.PORTFOLIO_ENV, 0)
                k = min(k, cfg.env_int("TTS_PORTFOLIO_MAX",
                                       cfg.PORTFOLIO_MAX_DEFAULT))
            if k and k >= 2:
                return self._submit_portfolio(request, int(k),
                                              spool_id=spool_id)
        with self._lock:
            done, same = self._done_with_tag(request)
            if same:
                return done.id
            if done is not None:
                tracelog.event("request.tag_reused_different_problem",
                               request_id=done.id, tag=request.tag)
            seq = next(self._seq)
            rid = f"req-{seq:04d}"
            tag = request.tag or rid
            path = str(self.workdir / f"{tag}.ckpt.npz")
            holder = next(
                (r for r in self.records.values()
                 if r.checkpoint_path == path
                 and r.state not in TERMINAL_STATES), None)
            if holder is not None:
                # two live requests sharing one checkpoint family would
                # interleave snapshot writes and retire each other's
                # files; resubmit-to-extend is only meaningful once the
                # prior request is terminal
                self.queue.rejected += 1
                tracelog.event("request.reject", tag=tag,
                               reason=f"tag active on {holder.id}")
                raise AdmissionError(
                    f"tag {tag!r} is already active on request "
                    f"{holder.id} ({holder.state}); wait for it to "
                    "finish or cancel it first")
            if self.former is not None:
                # the admission bound covers the WHOLE wait line: heap
                # + former-held members (the scheduler drains the heap
                # into the former every tick, so the heap alone would
                # never fill and backpressure would silently vanish)
                held = len(self.former)
                if held + len(self.queue) >= self.queue.max_depth:
                    self.queue.rejected += 1
                    reason = (f"queue full: {held} batching + "
                              f"{len(self.queue)} queued at the "
                              f"admission bound {self.queue.max_depth};"
                              " retry later or raise the bound")
                    tracelog.event("request.reject", reason=reason)
                    raise AdmissionError(reason)
            rec = RequestRecord(
                id=rid, request=request, submitted_t=time.monotonic(),
                seq=seq, checkpoint_path=path,
                # a pre-existing checkpoint under this tag carries its
                # accumulated execution clock (the meta both this
                # service and the legacy campaign worker write): the
                # compute deadline is CUMULATIVE across resumes, so a
                # resubmitted tag gets the remainder of a larger
                # budget, not a fresh one
                spent_prev_s=_prior_spent_s(path))
            self._progress_seed(rec)
            try:
                self.queue.admit(rec)      # raises AdmissionError if full
            except AdmissionError as e:
                tracelog.event("request.reject", reason=str(e))
                raise
            self.records[rid] = rec
            self._m_submitted.inc()
            if self.ledger is not None:
                # journaled BEFORE the id is returned: once the caller
                # sees this admission, the request survives a hard kill
                from .spool import payload_from_request
                self.ledger.journal(
                    "admit", rid=rid, tag=tag, seq=seq,
                    payload=payload_from_request(request),
                    spool_id=spool_id,
                    tenant=request.tenant,
                    spent_s=round(rec.spent_prev_s, 3))
            tracelog.event("request.admit", request_id=rid, tag=tag,
                           priority=request.priority,
                           deadline_s=request.deadline_s,
                           tenant=request.tenant,
                           resumable=rec.spent_prev_s > 0)
            if self.capacity is not None:
                self.capacity.on_admit(self._shape_class(request),
                                       request.tenant)
            return rid

    def _done_with_tag(self, request: SearchRequest) -> tuple:
        """(the DONE record holding `request`'s tag or None, whether it
        solved the same problem) under a ledger (caller holds the lock).
        A same-problem duplicate is served the recorded result instead of
        solving again (crash-duplicated submissions and client retries
        are absorbed; DEADLINE/FAILED tags still resubmit-to-extend); a
        reused tag carrying another instance or bound must solve."""
        if self.ledger is None or not request.tag:
            return None, False
        done = next((r for r in self.records.values()
                     if r.state == DONE
                     and (r.request.tag or r.id) == request.tag), None)
        if done is None:
            return None, False
        prior = done.request
        same = (prior.problem == request.problem
                and np.array_equal(np.asarray(prior.p_times),
                                   np.asarray(request.p_times))
                and prior.lb_kind == request.lb_kind
                and prior.init_ub == request.init_ub)
        if same:
            tracelog.event("request.reserved_terminal", request_id=done.id,
                           tag=request.tag)
        return done, same

    def _submit_portfolio(self, request: SearchRequest, k: int, *,
                          spool_id: str | None) -> str:
        """Admit a ``portfolio: K`` request: create the (never-queued,
        never-dispatched) PARENT record, fan out K member sub-requests
        over distinct configurations (service/portfolio.plan_members),
        journal the parent->member linkage, and arm the race. The
        parent id is what the client polls/awaits; it finalizes DONE
        with the first member to complete a proof (losers cancel), or
        inherits the least-bad outcome when none does."""
        import dataclasses as _dc

        from .. import problems
        from . import portfolio as portfolio_mod
        prob = problems.get(request.problem)
        # pin the resolved K on the parent request (it may have come
        # from the TTS_PORTFOLIO server default): the journaled admit
        # payload must replay the same race width on the next boot
        request = _dc.replace(request, portfolio=int(k))
        with self._lock:
            # the solo path's idempotent re-serve: a duplicate DONE tag
            # returns the recorded result instead of re-racing
            done, same = self._done_with_tag(request)
            if same:
                return done.id
            seq = next(self._seq)
            rid = f"req-{seq:04d}"
            tag = request.tag or rid
            path = str(self.workdir / f"{tag}.ckpt.npz")
            holder = next(
                (r for r in self.records.values()
                 if r.checkpoint_path == path
                 and r.state not in TERMINAL_STATES), None)
            if holder is not None:
                self.queue.rejected += 1
                tracelog.event("request.reject", tag=tag,
                               reason=f"tag active on {holder.id}")
                raise AdmissionError(
                    f"tag {tag!r} is already active on request "
                    f"{holder.id} ({holder.state}); wait for it to "
                    "finish or cancel it first")
            parent = RequestRecord(
                id=rid, request=request,
                submitted_t=time.monotonic(), seq=seq,
                checkpoint_path=path,
                spent_prev_s=_prior_spent_s(path))
            self.records[rid] = parent
            self._m_submitted.inc()
            if self.ledger is not None:
                from .spool import payload_from_request
                self.ledger.journal(
                    "admit", rid=rid, tag=tag, seq=seq,
                    payload=payload_from_request(request),
                    spool_id=spool_id,
                    spent_s=round(parent.spent_prev_s, 3))
            tracelog.event("request.admit", request_id=rid, tag=tag,
                           priority=request.priority,
                           deadline_s=request.deadline_s,
                           portfolio=k,
                           resumable=parent.spent_prev_s > 0)
            plan = portfolio_mod.plan_members(
                request, prob, k, parent_tag=tag, tuner=self.tuner,
                n_workers=len(self.slots[0].devices))
            members: list = []
            try:
                for mreq, config in plan:
                    mrid = self.submit(mreq, _portfolio_member=True)
                    mrec = self.records[mrid]
                    mrec.portfolio_parent = rid
                    mrec.portfolio_config = dict(config)
                    members.append((mrid, config))
            except AdmissionError as e:
                # partial fan-out (queue filled mid-race): a half
                # portfolio is not the race the client asked for —
                # unwind the admitted members and refuse the parent
                for mrid, _ in members:
                    mrec = self.records.get(mrid)
                    if mrec is not None \
                            and mrec.state not in TERMINAL_STATES:
                        self._finalize(mrec, CANCELLED,
                                       error="portfolio fan-out aborted")
                self._finalize(
                    parent, FAILED,
                    error=f"portfolio fan-out failed at member "
                          f"{len(members)} of {k}: {e}")
                raise
            if self.ledger is not None:
                self.ledger.journal(
                    "portfolio", rid=rid,
                    members=[{"rid": m, "config": c}
                             for m, c in members])
            self.portfolio.register(parent, members)
            return rid

    def status(self, request_id: str) -> dict:
        """JSON-safe lifecycle/progress snapshot of one request."""
        return self._rec(request_id).snapshot()

    # --------------------------------------------------------- pre-warm

    def prewarm_boot(self, spec: str | None = None,
                     spool_dir: str | None = None,
                     concurrency: int | None = None) -> dict:
        """Boot pre-warm: ready the loops of the expected traffic BEFORE
        the first request, so warm capacity exists from second zero (on
        a card each key's graph is captured once, here).

        `spec` is a comma-separated list of tokens: ``taillard`` (the
        standard Taillard shape families, config.
        PREWARM_TAILLARD_FAMILIES), ``spool`` (every shape found in the
        spool backlog — requests already waiting get their executables
        first), and/or explicit ``JxM`` (jobs x machines) entries.
        None/empty resolves to ``"spool,taillard"`` — the backlog's
        shapes are warmed FIRST (that traffic is already committed;
        an aborted mid-warm boot must not have spent its time on
        speculative families while waiting requests got nothing).
        Each shape is
        warmed per SUBMESH (distinct device sets are distinct executor
        keys) in the server's overlap mode (donated-pool variant when
        the pipelined driver will run). Bounded concurrency
        (TTS_PREWARM_CONCURRENCY) and idempotent — an already-warm key
        reports "warm" and costs a dict lookup.

        Returns a JSON-safe summary {shapes, warms, by: {disk, compile,
        warm, skipped}, seconds, errors}; "compile" counts fresh captures
        (loops built on the CPU) and "disk" stays 0 until the disk tier
        (ROADMAP A9d)."""
        import concurrent.futures as cf

        from ..engine import distributed
        from ..problems.pfsp import PFSPInstance
        from .request import SearchRequest

        spec = (spec or "").strip() or "spool,taillard"
        chunk_default = SearchRequest.__dataclass_fields__[
            "chunk"].default
        shapes: list[dict] = []
        seen: set[tuple] = set()

        def add(jobs, machines, lb=1, chunk=chunk_default,
                capacity=None, p_times=None, balance_period=4,
                min_seed=32, problem="pfsp", rung_profile=None):
            k = (problem, jobs, machines, lb, chunk, capacity,
                 balance_period)
            if k in seen:
                return
            seen.add(k)
            shapes.append({"jobs": jobs, "machines": machines,
                           "lb": lb, "chunk": chunk,
                           "capacity": capacity, "p_times": p_times,
                           "balance_period": balance_period,
                           "min_seed": min_seed, "problem": problem,
                           "rung_profile": rung_profile})

        for token in (t.strip().lower() for t in spec.split(",")):
            if not token:
                continue
            if token == "taillard":
                for jobs, machines in cfg.PREWARM_TAILLARD_FAMILIES:
                    add(jobs, machines, **self._tuned_kwargs(jobs,
                                                             machines))
            elif token == "spool":
                from ..tune import defaults as tune_defaults
                for req in self._spool_backlog(spool_dir):
                    p = np.asarray(req.p_times)
                    bchunk, bperiod = req.chunk, req.balance_period
                    bprofile = None
                    if bchunk is None or bperiod is None:
                        # a {"tuned": true} backlog request leaves its
                        # knobs open; warm the values DISPATCH will
                        # resolve to — the tuner (probing now when
                        # tune_at_boot, so the dispatch-time cache
                        # lookup replays this boot's winner) else the
                        # serving defaults tier
                        tk = self._tuned_kwargs(p.shape[1], p.shape[0],
                                                lb=req.lb_kind,
                                                problem=req.problem)
                        dflt = tune_defaults.params_for(
                            "serving", p.shape[1], p.shape[0],
                            problem=req.problem)
                        # dispatch (distributed.search) enters its
                        # tuner-resolve block whenever EITHER knob is
                        # open and attaches rung_modes from that same
                        # cache lookup unconditionally — mirror it
                        # exactly, or an explicit-chunk request with
                        # an open balance_period warms profile-less
                        # keys dispatch never asks for
                        bprofile = tk.get("rung_profile")
                        if bchunk is None:
                            bchunk = tk.get("chunk", dflt.chunk)
                        if bperiod is None:
                            bperiod = tk.get("balance_period",
                                             dflt.balance_period)
                    add(p.shape[1], p.shape[0], lb=req.lb_kind,
                        chunk=bchunk, capacity=req.capacity,
                        p_times=p, balance_period=bperiod,
                        min_seed=req.min_seed, problem=req.problem,
                        rung_profile=bprofile)
            elif "x" in token:
                jobs, _, machines = token.partition("x")
                add(int(jobs), int(machines))
            else:
                raise ValueError(
                    f"unknown prewarm token {token!r} (want 'taillard',"
                    " 'spool' or 'JxM')")

        if concurrency is None:
            concurrency = cfg.env_int("TTS_PREWARM_CONCURRENCY")
        concurrency = max(1, concurrency)

        def warm_one(shape, slot):
            p = shape["p_times"]
            if p is None:
                # only the SHAPE and value range matter (the tables are
                # runtime args): a synthetic Taillard-range instance
                # warms the executable every real instance of the
                # class reuses
                p = PFSPInstance.synthetic(shape["jobs"],
                                           shape["machines"],
                                           seed=0).p_times
            return distributed.prewarm(
                p, lb_kind=shape["lb"], chunk=shape["chunk"],
                capacity=shape["capacity"],
                balance_period=shape["balance_period"],
                min_seed=shape["min_seed"], devices=slot.devices,
                worker_ids=slot.device_ids, loop_cache=self.cache,
                problem=shape.get("problem", "pfsp"),
                # a tuned entry's rung_modes mask changes the ladder's
                # rung set and per-rung fused key suffixes — the warm
                # must build the exact keys a tuned dispatch resolves
                rung_profile=shape.get("rung_profile"),
                # the overlapped driver replays the "donate" key's loop;
                # warm the one this server will actually run
                donate=self.overlap)

        t0 = time.monotonic()
        by = {"disk": 0, "compile": 0, "warm": 0, "skipped": 0}
        errors = 0
        with cf.ThreadPoolExecutor(
                max_workers=concurrency,
                thread_name_prefix="tts-prewarm") as pool:
            futs = [pool.submit(warm_one, shape, slot)
                    for shape in shapes for slot in self.slots]
            for fut in cf.as_completed(futs):
                try:
                    by[fut.result()] += 1
                except Exception as e:  # noqa: BLE001 — warming is an
                    # optimization: one failed shape must not abort the
                    # boot (the first real request pays its compile)
                    errors += 1
                    tracelog.event("aot_cache.prewarm_failed",
                                   error=repr(e))
        summary = {"shapes": len(shapes), "warms": len(shapes)
                   * len(self.slots), "by": by, "errors": errors,
                   "seconds": round(time.monotonic() - t0, 3)}
        tracelog.event("server.prewarm", shapes=summary["shapes"],
                       warms=summary["warms"], errors=errors,
                       seconds=summary["seconds"],
                       **{f"n_{k}": v for k, v in by.items()})
        return summary

    def _tuned_kwargs(self, jobs: int, machines: int,
                      lb: int = 1, problem: str = "pfsp") -> dict:
        """Tuned dispatch knobs for a pre-warm family shape: the
        tuning cache when warm, a PROBE at boot when `tune_at_boot`
        (persisted — the next boot replays it with zero probes), else
        nothing (the family keeps the serving default). Never raises —
        a failed probe must not abort the boot."""
        if self.tuner is None:
            return {}
        try:
            n_workers = len(self.slots[0].devices)
            params = self.tuner.resolve(jobs, machines, lb,
                                        n_workers=n_workers,
                                        allow_probe=self.tune_at_boot,
                                        problem=problem,
                                        device=self.slots[0].devices[0])
        except Exception as e:  # noqa: BLE001 — tuning is an
            # optimization; the default-knob warm still happens
            tracelog.event("tuner.boot_failed", jobs=jobs,
                           machines=machines, error=repr(e))
            return {}
        if params.source == "default":
            return {}
        return {"chunk": params.chunk,
                "balance_period": params.balance_period,
                "rung_profile": params.rung_modes}

    def _spool_backlog(self, spool_dir: str | None) -> list:
        """Parse the unserved request files waiting in the spool (their
        shapes are the most certain pre-warm targets: that traffic is
        already committed). The which-requests-are-waiting rule is
        spool.unserved_requests — shared with the serve loop so the
        two can never drift."""
        import json as _json

        from . import spool as spool_mod
        if not spool_dir:
            return []
        out = []
        for _sid, req_file in spool_mod.unserved_requests(spool_dir):
            try:
                out.append(spool_mod.request_from_payload(
                    _json.loads(req_file.read_text())))
            except Exception:  # noqa: BLE001 — a malformed backlog file
                continue       # is the serve loop's problem (it writes
                #                the REJECTED result), not warm's
        return out

    def result(self, request_id: str,
               timeout: float | None = None) -> RequestRecord:
        """Block until the request is terminal (or the server closes);
        returns its record. Raises TimeoutError if `timeout` expires
        first — the record is NOT terminal in that case."""
        rec = self._rec(request_id)
        if not rec.done_event.wait(timeout):
            raise TimeoutError(
                f"request {request_id} still {rec.state} after "
                f"{timeout}s")
        return rec

    def cancel(self, request_id: str) -> bool:
        """Cancel a request. Queued: terminal immediately. Running:
        stopped at the next segment boundary. Returns False if it was
        already terminal."""
        with self._lock:
            rec = self._rec(request_id)
            if rec.state in TERMINAL_STATES:
                return False
            if rec.state in (QUEUED, PREEMPTED):
                self._finalize(rec, CANCELLED)
                return True
            rec.stop_reason = "cancel"
            self._stop_slot_of(rec)
            return True

    def preempt(self, request_id: str, hold: bool = False) -> bool:
        """Operator preemption: stop a RUNNING request at its next
        segment boundary, checkpoint it, and requeue it — or park it
        (``hold=True``) until `release()`, e.g. to drain a request
        before maintenance. Returns False unless it was running."""
        with self._lock:
            rec = self._rec(request_id)
            if rec.state != RUNNING:
                return False
            rec.hold = hold
            if rec.stop_reason is None:
                rec.stop_reason = "preempt"
            self._stop_slot_of(rec)
            return True

    def release(self, request_id: str) -> bool:
        """Requeue a held PREEMPTED request (see `preempt(hold=True)`)."""
        with self._lock:
            rec = self._rec(request_id)
            if rec.state != PREEMPTED or not rec.hold:
                return False
            rec.hold = False
            if self.ledger is not None:
                # journaled like every other transition: a crash after
                # an operator released the request must not replay it
                # back into the parked state
                self.ledger.journal("release", rid=rec.id)
            self.queue.requeue(rec)
            return True

    # ----------------------------------------- remediation support API
    # (service/remediate.RemediationController's actuation surface; the
    # controller never reaches into server internals directly, and none
    # of these run unless an action executes — TTS_REMEDIATE=1)

    def pause_admission(self, reason: str) -> None:
        """Reject new submissions with `reason` until resumed (the
        spool front-end holds its backlog instead). Ledger-journaled:
        a crash while paused restarts PAUSED."""
        with self._lock:
            self._paused_reason = reason
            if self.ledger is not None:
                self.ledger.journal("pause", reason=reason)
        tracelog.event("server.admission_paused", reason=reason)

    def resume_admission(self) -> None:
        with self._lock:
            was, self._paused_reason = self._paused_reason, None
            if was is not None and self.ledger is not None:
                self.ledger.journal("resume")
        if was is not None:
            tracelog.event("server.admission_resumed")

    def admission_paused(self) -> str | None:
        """The pause reason, or None while admitting."""
        with self._lock:
            return self._paused_reason

    def remediate_preempt(self, request_id: str,
                          exclude_submesh: bool = True,
                          expected_submesh: int | None = None
                          ) -> tuple[bool, int | None]:
        """Controller preemption: stop a RUNNING request at its next
        segment boundary (checkpoint + requeue, like `preempt`) and —
        by default — append its current submesh to the request's
        excluded set so the resume lands elsewhere.
        `expected_submesh` (when not None) must match the request's
        CURRENT submesh — a stall observed on one submesh must not
        preempt (and exclude!) a later dispatch that already moved to
        a healthy one. Returns (preempted, excluded_submesh)."""
        with self._lock:
            rec = self.records.get(request_id)
            if rec is None or rec.state != RUNNING:
                return False, None
            if expected_submesh is not None \
                    and rec.submesh != expected_submesh:
                return False, None
            submesh = rec.submesh
            if exclude_submesh and submesh is not None:
                self.add_exclusion(rec, submesh)
            rec.hold = False
            if rec.stop_reason is None:
                rec.stop_reason = "preempt"
            for slot in self.slots:
                if slot.batch is not None and rec in slot.batch:
                    # a REMEDIATION preempt of a batched member stops
                    # the WHOLE batch: memory shedding frees nothing
                    # until the shared (D,B,...) pools release, and a
                    # stalled batch executor has stalled every member
                    # alike — all members checkpoint at the boundary
                    # and requeue (member-level stops stay the rule
                    # for cancel/deadline, see _stop_slot_of)
                    if slot.stop_event is not None:
                        slot.stop_event.set()
                    break
            else:
                self._stop_slot_of(rec)
            return True, (submesh if exclude_submesh else None)

    def add_exclusion(self, rec: RequestRecord, submesh: int) -> None:
        """Exclude `submesh` for `rec` (caller may hold the lock — it
        is an RLock). If the exclusions would cover the whole
        partition, only the newest offender is kept (on a
        single-submesh server: none at all) — a request must always
        have somewhere left to run; one that genuinely fails
        everywhere dead-letters through the failure path instead."""
        with self._lock:
            rec.excluded_submeshes.add(int(submesh))
            if len(rec.excluded_submeshes) >= len(self.slots):
                rec.excluded_submeshes = (
                    {int(submesh)} if len(self.slots) > 1 else set())
            if self.ledger is not None:
                # journaled in ABSOLUTE form: the cap above can RESET
                # the set, which a relative append would replay wrong
                self.ledger.journal(
                    "exclude", rid=rec.id,
                    excluded=sorted(rec.excluded_submeshes))

    def lowest_priority_running(self) -> str | None:
        """The shed_memory action's victim: the lowest-priority,
        youngest RUNNING request not already stopping."""
        with self._lock:
            cands = [rec for s in self.slots for rec in s.records
                     if rec.state == RUNNING
                     and rec.stop_reason is None]
            if not cands:
                return None
            return min(cands,
                       key=lambda r: (r.request.priority,
                                      -(r.started_t or 0.0))).id

    def quarantine_submesh(self, index: int, reason: str) -> None:
        """Hold a slot out of the partition (the remediation
        controller's containment decision executes here, and is
        ledger-journaled, so a crash cannot put a quarantined submesh
        back into rotation)."""
        with self._lock:
            slot = self.slots[index]
            slot.quarantined = True
            slot.quarantined_since = time.time()
            slot.quarantine_reason = reason
            if self.ledger is not None:
                self.ledger.journal("quarantine", submesh=int(index),
                                    reason=reason)
            self._lane_sync(slot)

    def readmit_submesh(self, index: int) -> None:
        """Clear a slot's quarantine (the canary probe passed)."""
        with self._lock:
            slot = self.slots[index]
            slot.quarantined = False
            slot.quarantine_reason = None
            if self.ledger is not None:
                self.ledger.journal("readmit", submesh=int(index))
            self._lane_sync(slot)

    def heartbeat_ages(self) -> dict:
        """Seconds since each RUNNING request's last engine heartbeat —
        the health layer's `stall` rule input (a wedged submesh stops
        heartbeating long before it stops holding its slot)."""
        now = time.monotonic()
        with self._lock:
            return {rec.id: now - rec.last_heartbeat_t
                    for slot in self.slots
                    for rec in slot.records
                    if rec.state == RUNNING
                    and rec.last_heartbeat_t is not None}

    # --------------------------------------------- capacity (TTS_CAPACITY)

    def _lane_state(self, slot: _Slot) -> str:
        """Resolve a slot's lane state from existing scheduler state —
        no new bookkeeping, so the resolver cannot drift from the
        transitions it observes. Priority order matters: a quarantined
        lane is quarantined whatever it still runs, a stop in flight is
        draining even if some member already froze."""
        if slot.quarantined:
            return "quarantined"
        recs = slot.records
        if not recs:
            return "idle"
        if all(r.dispatch_heartbeats == 0 for r in recs):
            return "compiling"      # dispatched, no heartbeat yet:
            #                         the build and capture window
        if ((slot.stop_event is not None and slot.stop_event.is_set())
                or any(r.stop_reason is not None
                       and r.state not in TERMINAL_STATES
                       for r in recs)):
            return "draining"   # a stop is in flight only until the
            #                     stopped member finalizes
        if slot.batch is not None \
                and any(r.state != RUNNING for r in recs):
            return "batch-frozen"   # a member finished; the rest run
            #                         the batch out (ROADMAP item 2)
        return "executing"

    def _lane_sync(self, slot: _Slot) -> None:
        """Fold `slot`'s current resolved state into the lane ledger (a
        no-op when unchanged, and entirely absent with TTS_CAPACITY=0).
        Callable with OR without the server lock: the ledger locks
        itself, and a racing resolve can at worst label a sliver of
        time with the neighboring state — conservation is untouched."""
        if self.lane_ledger is not None:
            self.lane_ledger.transition(slot.index,
                                        self._lane_state(slot))

    def _shape_class(self, request: SearchRequest) -> str:
        """The tune/defaults shape-class label of a request — the key
        the capacity model's demand and service-rate tables join on."""
        from .. import problems
        from ..tune import defaults as tune_defaults
        p = np.asarray(request.p_times)
        return tune_defaults.shape_class(
            problems.get(request.problem).slots(p), p.shape[0],
            problem=request.problem)

    def _capacity_seed(self, shape: str, p: np.ndarray,
                       lb_kind: int) -> None:
        """Seed the capacity model's service rate for `shape` from the
        same tuning tier the dispatch itself resolves through (cached
        eval's evals/s when present, the defaults table otherwise) —
        the model corrects it with observed throughput as heartbeats
        arrive, but a fresh class gets a non-degenerate E[S] from the
        very first admit."""
        if self.capacity is None:
            return
        params = None
        if self.tuner is not None:
            try:
                params = self.tuner.resolve(
                    p.shape[1], p.shape[0], lb_kind,
                    n_workers=len(self.slots[0].devices),
                    device=self.slots[0].devices[0])
            except Exception:   # noqa: BLE001 — seeding is best-effort
                params = None
        if params is None:
            from ..tune import defaults as tune_defaults
            try:
                params = tune_defaults.params_for(
                    "serving", p.shape[1], p.shape[0])
            except Exception:   # noqa: BLE001
                return
        rate = getattr(params, "evals_per_s", None)
        if rate:
            self.capacity.seed_rate(shape, float(rate))

    def capacity_snapshot(self) -> dict | None:
        """The ``GET /capacity`` document (and status_snapshot's
        ``capacity`` key): lane-state ledger detail + the shape-class
        demand/capacity model with its what-if partition table. None
        with the capacity layer off."""
        if self.capacity is None or self.lane_ledger is None:
            return None
        healthy = sum(1 for s in self.slots if not s.quarantined)
        devices = sum(len(s.device_ids) for s in self.slots)
        doc = self.capacity.snapshot(healthy, len(self.slots), devices)
        doc["lanes_detail"] = self.lane_ledger.snapshot()
        return doc

    def status_snapshot(self) -> dict:
        """One JSON-safe dict describing the whole server: queue depth
        and order, per-submesh occupancy, executor-cache hit/miss
        counters, lifecycle counters, and every request's snapshot.
        The counters and the `metrics` view are both read from the
        server's metrics registry — the snapshot is a rendering of the
        registry, not a parallel bookkeeping path."""
        with self._lock:
            return {
                "t": time.time(),
                "uptime_s": round(time.monotonic() - self._t0, 3),
                "queue": {"depth": len(self.queue),
                          "waiting": self.queue.waiting_ids(),
                          "max_depth": self.queue.max_depth,
                          "peak_depth": self.queue.peak_depth,
                          "rejected": self.queue.rejected},
                "submeshes": [
                    {"index": s.index, "devices": s.device_ids,
                     "running": s.record.id if s.record else None,
                     "batch": ([r.id for r in s.batch]
                               if s.batch is not None else None),
                     "quarantined": s.quarantined}
                    for s in self.slots],
                "megabatch": ({"enabled": True,
                               "held": self.former.waiting_ids(),
                               "max": self.former.max_size,
                               "age_s": self.former.age_s}
                              if self.former is not None else None),
                "remediation": self.remediation.snapshot(),
                "ledger": ({**self.ledger.snapshot(),
                            "recovered": dict(self._recovered)}
                           if self.ledger is not None else None),
                "failover": self._failover_snapshot(),
                "executor_cache": self.cache.snapshot(),
                # the disk executor cache is ROADMAP A9d: off
                "aot_cache": None,
                "compile_ledger": self.cache.ledger_snapshot(),
                "incumbents": (self.incumbents.snapshot()
                               if self.incumbents is not None else None),
                "tuner": (self.tuner.snapshot()
                          if self.tuner is not None else None),
                "portfolio": self._portfolio_snapshot(),
                "counters": self.counters,
                "metrics": self.metrics.to_json(),
                "requests": {rid: rec.snapshot()
                             for rid, rec in self.records.items()},
                # ABSENT (not None) with the capacity layer off: the
                # off-path snapshot is bit-identical, test-pinned
                **({"capacity": self.capacity_snapshot()}
                   if self.capacity is not None else {}),
            }

    def _portfolio_snapshot(self) -> dict | None:
        """status_snapshot()'s `portfolio` key: None when no request
        ever raced, else the race totals; per-race detail (siblings,
        winner config, cancelled counts) lives on each parent's request
        snapshot `portfolio` block."""
        parents = [r for r in self.records.values()
                   if r.portfolio_members is not None]
        if not parents:
            return None
        return {"parents": len(parents),
                "active": sum(1 for r in parents
                              if r.state not in TERMINAL_STATES),
                "won": sum(1 for r in parents if r.state == DONE),
                "cancelled_members": sum(r.portfolio_cancelled
                                         for r in parents)}

    def _failover_snapshot(self) -> dict | None:
        """status_snapshot()'s `failover` key: None outside fleet mode,
        else lease + watcher state (the health layer's `peer_down` rule
        reads it)."""
        if (self.lease is None and self.watcher is None
                and not self.fenced):
            return None
        out: dict = {"fenced": self.fenced,
                     "fence_reason": self._fence_reason,
                     "adopted": len(self._adopted)}
        if self.lease is not None:
            out["lease"] = self.lease.snapshot()
        if self.watcher is not None:
            out.update(self.watcher.snapshot())
        return out

    # ------------------------------------------------------ crash recovery
    # (service/ledger: replaying the write-ahead journal at boot)

    def _replay_boot(self) -> None:
        """Rebuild serving state from the replayed ledger: standing
        admission pause + submesh quarantines first (a crash must not
        launder a degraded configuration back to healthy), then every
        journaled request — queued/active re-admitted with budgets,
        exclusions and failure logs intact (their checkpoints make the
        resume lossless), terminal snapshots kept for idempotent
        re-serve."""
        from . import spool as spool_mod
        st = self.ledger.state
        if st.boots:
            # a monotone restart count fed from the ledger itself, so
            # it survives the registry reset a restart is
            self.metrics.counter(
                "tts_server_restarts_total",
                "server boots that replayed prior ledger state"
                ).inc(st.boots)
        if st.paused:
            with self._lock:
                self._paused_reason = st.paused
            self.remediation.restore_pause(st.paused)
            tracelog.event("ledger.pause_restored", reason=st.paused)
        for idx, reason in sorted(st.quarantined.items()):
            if not 0 <= idx < len(self.slots):
                continue        # journaled on a larger partition
            if sum(1 for s in self.slots if not s.quarantined) <= 1:
                # the last healthy slot stays in rotation — the same
                # never-zero-capacity guard remediate._quarantine
                # applies live; a shrunk partition must not replay
                # itself into a server that can never dispatch
                tracelog.event("ledger.quarantine_not_restored",
                               submesh=idx,
                               reason="last healthy submesh")
                continue
            slot = self.slots[idx]
            slot.quarantined = True
            slot.quarantined_since = time.time()
            slot.quarantine_reason = reason or "restored from ledger"
            self.remediation.restore_quarantine(idx)
        max_seq = -1
        for entry in sorted(st.requests.values(),
                            key=lambda e: e.get("seq", 0)):
            max_seq = max(max_seq, int(entry.get("seq", 0)))
            try:
                self._readmit_replayed(entry, spool_mod)
            except Exception as e:  # noqa: BLE001 — one unparseable
                # entry (schema drift, a hand-edited ledger) must not
                # strand the rest of the recovery
                tracelog.event("ledger.readmit_failed",
                               request_id=entry.get("rid"),
                               error=repr(e))
        if max_seq >= 0:
            self._seq = itertools.count(max_seq + 1)
        # re-arm replayed portfolio races AFTER every entry landed
        # (members replay after their lower-seq parent): a race the
        # crash interrupted mid-decision resolves right here — a
        # pre-kill winner decides, members of an already-terminal
        # parent cancel instead of re-running a finished race
        self.portfolio.reconcile()
        if st.requests:
            tracelog.event("ledger.recovered", restarts=st.boots,
                           **self._recovered)

    def _readmit_replayed(self, entry: dict, spool_mod) -> None:
        rid = entry["rid"]
        req = spool_mod.request_from_payload(entry.get("payload") or {})
        tag = entry.get("tag") or rid
        req.tag = tag
        if entry.get("tenant"):
            req.tenant = str(entry["tenant"])
        path = str(self.workdir / f"{tag}.ckpt.npz")
        rec = RequestRecord(
            id=rid, request=req, submitted_t=time.monotonic(),
            seq=int(entry.get("seq", 0)), checkpoint_path=path,
            # the budget clock is CUMULATIVE across the crash: the
            # journaled spent_s (heartbeat-fresh) and the checkpoint's
            # own meta both survive; trust whichever saw more
            spent_prev_s=max(float(entry.get("spent_s") or 0.0),
                             _prior_spent_s(path)),
            dispatches=int(entry.get("dispatches") or 0),
            preemptions=int(entry.get("preemptions") or 0),
            failures=int(entry.get("failures") or 0))
        self._progress_seed(rec)
        # adoption lineage survives the adopter's own restart: the
        # replayed admit record carried it (see _adopt_entry)
        rec.origin_rid = entry.get("origin_rid")
        rec.origin_owner = entry.get("origin_owner")
        rec.failure_log = [dict(f) for f in
                           entry.get("failure_log") or []]
        # restored exclusions are re-capped against THIS lifetime's
        # partition (it may be smaller than the one that journaled
        # them): indices past the partition drop, and a set that would
        # cover every slot clears — the add_exclusion invariant that a
        # request must always have somewhere left to run
        excluded = {int(s) for s in entry.get("excluded") or []
                    if 0 <= int(s) < len(self.slots)}
        if len(excluded) >= len(self.slots):
            excluded = set()
        rec.excluded_submeshes = excluded
        rec.error = entry.get("error")
        # portfolio linkage (the `portfolio` journal record stamped it
        # on the entries; _apply_restore carries it through compaction
        # verbatim) — restored BEFORE the state branch so a parent is
        # recognized and never requeued
        pf_members = entry.get("portfolio_members")
        if pf_members:
            rec.portfolio_members = [m.get("rid") for m in pf_members]
        if entry.get("portfolio_parent"):
            rec.portfolio_parent = str(entry["portfolio_parent"])
            rec.portfolio_config = entry.get("portfolio_config")
        state = entry.get("state")
        if state in TERMINAL_STATES:
            rec.state = state
            snap = entry.get("terminal") or {}
            if snap.get("result") is not None:
                rec.result = _ReplayedResult(snap["result"])
            rec.error = snap.get("error", rec.error)
            if rec.portfolio_members is not None:
                pf = snap.get("portfolio") or {}
                rec.portfolio_winner = pf.get("winner")
                rec.portfolio_config = (pf.get("winner_config")
                                        or rec.portfolio_config)
                rec.portfolio_cancelled = int(pf.get("cancelled") or 0)
            rec.done_event.set()
            self._recovered["terminal"] += 1
        elif state == PREEMPTED and entry.get("hold"):
            # an operator parked it (preempt(hold=True)); stay parked
            # until release() — a restart is not a release
            rec.state = PREEMPTED
            rec.hold = True
            self._recovered["held"] += 1
        else:
            rec.state = QUEUED
            self._recovered["active" if state == RUNNING
                            else "queued"] += 1
            if rec.portfolio_members is None:
                # a portfolio PARENT is a coordination object: it waits
                # on its members' terminals, it never queues — the
                # post-replay reconcile() re-arms its race instead
                self.queue.requeue(rec)
        with self._lock:
            self.records[rid] = rec
        if entry.get("spool_id"):
            self.replayed_spool[str(entry["spool_id"])] = rid
        tracelog.event("request.recovered", request_id=rid,
                       state=rec.state, tag=tag,
                       spent_s=round(rec.spent_prev_s, 3),
                       dispatches=rec.dispatches,
                       excluded=sorted(rec.excluded_submeshes))

    # ------------------------------------------------------ fleet failover
    # (service/lease + service/failover: fenced ownership and takeover)

    def _self_fence(self, reason: str) -> None:
        """This process no longer owns its ledger (epoch bumped by an
        adopter). Stop committing: admission refuses with LeaseLost,
        the scheduler tick exits cleanly, running requests stop at
        their next segment boundary (their preempt journals no-op on
        the fenced ledger — zero commits by construction). Idempotent;
        fired by the lease keeper's renewal daemon or the ledger's
        append-path check, whichever notices first."""
        with self._lock:
            if self.fenced:
                return
            self.fenced = True
            self._fence_reason = reason
            for slot in self.slots:
                for rec in slot.records:
                    if rec.stop_reason is None:
                        rec.stop_reason = "fenced"
                if slot.records and slot.stop_event is not None:
                    slot.stop_event.set()
        tracelog.event("server.fenced", reason=reason)

    def _ckpt_fence_meta(self) -> dict:
        """Fencing stamp for checkpoint meta. Raises LeaseLost before a
        stale owner's save can even serialize; the epoch stamp it
        returns makes engine/checkpoint refuse an epoch-stale overwrite
        on top (the fence is in the data, not just the timing).
        Vacuous ({}) outside fleet mode."""
        if self.lease is None:
            return {}
        self.lease.check()
        return {"lease_epoch": self.lease.epoch}

    def adopt_ledger(self, orphan_dir: str,
                     current_epoch: int | None = None) -> dict:
        """Take over a dead peer's ledger (the FailoverWatcher's act
        path; callable directly for drills). Protocol:

        1. CAS the fencing epoch to ``current_epoch + 1`` through the
           claim file — exactly one adopter; losing returns
           ``{"outcome": "lost_race"}`` without touching the orphan.
        2. Replay the orphan through the boot path (the ledger
           constructor truncates any torn tail to last-good) and
           journal a ``takeover`` record at the NEW epoch — any stale
           append the dead owner slips in afterwards is discarded on
           every future replay.
        3. Re-admit its QUEUED/ACTIVE requests HERE under fresh ids
           (the orphan's ``req-NNNN`` ids collide with ours) with
           budgets, exclusions, failure logs, spool ids and checkpoint
           files intact; journal each into OUR ledger (a crash here
           re-replays the adoption) and a ``forget`` tombstone into
           the orphan (a rebooted original owner replays an empty live
           set). DONE terminals register for idempotent tag re-serve.
           The orphan's standing submesh quarantines are deliberately
           NOT imported — they described the dead host's hardware.
        4. Keep renewing the orphan's lease: a restarted stale owner
           must find a LIVE foreign lease and boot fenced, and no
           second peer may re-adopt. Released at close().
        """
        from . import lease as lease_mod
        from . import spool as spool_mod
        from .lease import LeaseKeeper
        from .ledger import RequestLedger

        orphan_dir = str(orphan_dir)
        if current_epoch is None:
            info = lease_mod.read_lease(orphan_dir)
            current_epoch = info.epoch if info is not None else 0
        keeper = LeaseKeeper(orphan_dir)
        if not keeper.takeover(current_epoch):
            tracelog.event("failover.lost_race", dir=orphan_dir,
                           epoch=current_epoch + 1)
            return {"outcome": "lost_race", "dir": orphan_dir}
        moved = reserved = failed = 0
        orphan = RequestLedger(orphan_dir, lease=keeper)
        try:
            # `adopter` names OUR ledger directory: the forward pointer
            # a journey reconstructor reading the orphan needs to know
            # where the live requests went (origin_rid on our admits is
            # the matching back pointer)
            orphan.journal("takeover", owner=keeper.owner,
                           from_epoch=current_epoch, pid=os.getpid(),
                           adopter=(pathlib.Path(self._ledger_dir).name
                                    if self._ledger_dir else None))
            entries = sorted(orphan.state.requests.values(),
                             key=lambda e: e.get("seq", 0))
            for entry in entries:
                try:
                    if entry.get("state") in TERMINAL_STATES:
                        if entry.get("state") == DONE \
                                and self._adopt_terminal(entry,
                                                         spool_mod):
                            reserved += 1
                        continue
                    self._adopt_entry(entry, orphan_dir, spool_mod)
                    orphan.journal("forget", rid=entry.get("rid"))
                    moved += 1
                except Exception as e:  # noqa: BLE001 — one
                    # unparseable entry must not strand the rest of
                    # the takeover (the _replay_boot stance)
                    failed += 1
                    tracelog.event("failover.adopt_entry_failed",
                                   request_id=entry.get("rid"),
                                   error=repr(e))
        finally:
            orphan.close()
        self._adopted.append(keeper)
        result = {"outcome": "adopted", "dir": orphan_dir,
                  "epoch": keeper.epoch, "moved": moved,
                  "reserved": reserved, "failed": failed}
        tracelog.event("failover.adopted", **result)
        return result

    def _adopt_entry(self, entry: dict, orphan_dir: str,
                     spool_mod) -> str:
        """Re-admit one live orphan entry on THIS server — the
        _readmit_replayed recipe under a fresh id, journaled into our
        own ledger. The orphan's checkpoint family is copied into our
        workdir first (never clobbering an existing one) so the resume
        is lossless and budget-continuous."""
        rid_old = entry["rid"]
        req = spool_mod.request_from_payload(entry.get("payload") or {})
        tag = entry.get("tag") or rid_old
        req.tag = tag
        if entry.get("tenant"):
            req.tenant = str(entry["tenant"])
        src_dir = pathlib.Path(orphan_dir) / "workdir"
        path = str(self.workdir / f"{tag}.ckpt.npz")
        for suffix in ("", ".prev"):
            src = src_dir / f"{tag}.ckpt.npz{suffix}"
            dst = pathlib.Path(path + suffix)
            if not src.exists() or dst.exists() or src == dst:
                continue
            try:
                # copy to a unique temp then rename: our own executor
                # must never read a half-copied snapshot
                tmp = dst.with_name(f".{dst.name}.{os.getpid()}.tmp")
                shutil.copy2(src, tmp)
                os.replace(tmp, dst)
            except OSError as e:
                tracelog.event("failover.checkpoint_copy_failed",
                               src=str(src), error=repr(e))
        with self._lock:
            seq = next(self._seq)
            rid = f"req-{seq:04d}"
            rec = RequestRecord(
                id=rid, request=req, submitted_t=time.monotonic(),
                seq=seq, checkpoint_path=path,
                spent_prev_s=max(float(entry.get("spent_s") or 0.0),
                                 _prior_spent_s(path)),
                dispatches=int(entry.get("dispatches") or 0),
                preemptions=int(entry.get("preemptions") or 0),
                failures=int(entry.get("failures") or 0))
            # the copied checkpoint's meta seeds the estimate warm, so
            # an adopted request's progress continues across the
            # takeover like its budget clock does
            self._progress_seed(rec)
            # id lineage: the fresh rid continues the orphan's rid —
            # stamped on the record, its admit journal and the adopted
            # event, so the flight recorder's journey reconstructor
            # chains ONE logical request across the takeover. If the
            # entry itself was already an adoption (a second hop), the
            # ORIGINAL lineage wins: chains stay one link deep to the
            # first admit.
            rec.origin_rid = entry.get("origin_rid") or rid_old
            rec.origin_owner = (entry.get("origin_owner")
                                or pathlib.Path(orphan_dir).name)
            rec.failure_log = [dict(f) for f in
                               entry.get("failure_log") or []]
            excluded = {int(s) for s in entry.get("excluded") or []
                        if 0 <= int(s) < len(self.slots)}
            if len(excluded) >= len(self.slots):
                excluded = set()
            rec.excluded_submeshes = excluded
            rec.error = entry.get("error")
            if entry.get("state") == PREEMPTED and entry.get("hold"):
                rec.state = PREEMPTED
                rec.hold = True
            else:
                rec.state = QUEUED
            self.records[rid] = rec
            self._m_submitted.inc()
            if self.ledger is not None:
                self.ledger.journal(
                    "admit", rid=rid, tag=tag, seq=seq,
                    payload=spool_mod.payload_from_request(req),
                    spool_id=entry.get("spool_id"),
                    spent_s=round(rec.spent_prev_s, 3),
                    tenant=req.tenant,
                    origin_rid=rec.origin_rid,
                    origin_owner=rec.origin_owner)
                if rec.excluded_submeshes:
                    self.ledger.journal(
                        "exclude", rid=rid,
                        excluded=sorted(rec.excluded_submeshes))
            if rec.state == QUEUED:
                self.queue.requeue(rec)
        if entry.get("spool_id"):
            self.replayed_spool[str(entry["spool_id"])] = rid
        tracelog.event("request.adopted", request_id=rid,
                       orphan_id=rid_old, tag=tag, state=rec.state,
                       tenant=req.tenant,
                       origin_rid=rec.origin_rid,
                       origin_owner=rec.origin_owner,
                       spent_s=round(rec.spent_prev_s, 3),
                       spool_id=entry.get("spool_id"))
        return rid

    def _adopt_terminal(self, entry: dict, spool_mod) -> bool:
        """Register a DONE orphan entry for idempotent re-serve: a
        duplicate-tag submission (a crash-retried client) gets the
        recorded result instead of a re-solve, exactly as it would
        have from the dead owner. In-memory only — the orphan ledger
        keeps the durable copy."""
        tag = entry.get("tag") or entry.get("rid")
        snap = entry.get("terminal") or {}
        if snap.get("result") is None:
            return False
        with self._lock:
            if any((r.request.tag or r.id) == tag
                   for r in self.records.values()):
                return False    # the tag already lives here
            seq = next(self._seq)
            rid = f"req-{seq:04d}"
            req = spool_mod.request_from_payload(
                entry.get("payload") or {})
            req.tag = tag
            rec = RequestRecord(
                id=rid, request=req, submitted_t=time.monotonic(),
                seq=seq,
                checkpoint_path=str(self.workdir / f"{tag}.ckpt.npz"),
                spent_prev_s=float(entry.get("spent_s") or 0.0))
            rec.state = DONE
            rec.result = _ReplayedResult(snap["result"])
            rec.done_event.set()
            self.records[rid] = rec
        if entry.get("spool_id"):
            self.replayed_spool[str(entry["spool_id"])] = rid
        tracelog.event("request.adopted_terminal", request_id=rid,
                       tag=tag, spool_id=entry.get("spool_id"))
        return True

    def _ledger_budget(self, rec: RequestRecord) -> None:
        """Journal the request's cumulative execution clock, throttled
        to LEDGER_BUDGET_EVERY_S (every heartbeat would fsync at
        heartbeat rate; this bounds what a hard kill can lose to a few
        seconds of budget, never the request)."""
        if self.ledger is None:
            return
        now = time.monotonic()
        if now - rec.ledger_budget_t < cfg.LEDGER_BUDGET_EVERY_S_DEFAULT:
            return
        rec.ledger_budget_t = now
        extra = {}
        est = rec.progress.get("estimate") or {}
        if est.get("progress_ratio") is not None:
            # the journey timeline's per-lifetime progress marks ride
            # the same throttled budget record (obs/journey reads them
            # back; absent when TTS_PROGRESS=0 — record bit-identity)
            extra["progress"] = est["progress_ratio"]
        self.ledger.journal("budget", rid=rec.id,
                           spent_s=round(rec.spent_s(), 3), **extra)

    # ------------------------------------------------- progress estimation

    def _progress_seed(self, rec: RequestRecord) -> None:
        """Attach a ProgressEstimator (TTS_PROGRESS on), warm from any
        existing checkpoint's meta vector so a resumed / resharded /
        adopted request continues its estimate instead of restarting
        cold (the spent_s continuity rule, estimator-shaped)."""
        if not self.progress_enabled:
            return
        from ..obs import estimate as est_mod
        # depth hint = the instance's first shape axis (jobs / cities /
        # items): it bounds the estimator's cascade horizon so the
        # early no-pruning expansion phase cannot inflate the estimate
        # past the finite-depth tree
        depth = int(np.asarray(rec.request.p_times).shape[0])
        prior = _prior_progress_est(rec.checkpoint_path)
        est = (est_mod.ProgressEstimator.from_list(prior,
                                                   depth_hint=depth)
               if prior is not None else None)
        rec.estimator = est or est_mod.ProgressEstimator(
            depth_hint=depth)

    def _progress_rate(self, rec: RequestRecord) -> float | None:
        """ETA fallback rate before the first live window: the tuner's
        measured per-shape evals/s (memo/cache/defaults only — never a
        probe on the heartbeat path); None when unknown."""
        if self.tuner is None:
            return None
        try:
            from .. import problems
            p = np.asarray(rec.request.p_times)
            prob = problems.get(rec.request.problem)
            params = self.tuner.resolve(
                prob.slots(p), p.shape[0], lb_kind=rec.request.lb_kind,
                problem=rec.request.problem)
            return params.evals_per_s
        except Exception:  # noqa: BLE001 — a fallback must never break hb
            return None

    def _progress_update(self, rec: RequestRecord, rep) -> None:
        """Heartbeat hook: fold one segment report into the request's
        estimator, surface the estimate in the progress snapshot, and
        publish the per-request gauges once past the warmup gate."""
        est = rec.estimator
        if est is None:
            return
        est.update(tree=rep.tree, pool=rep.pool_size,
                   elapsed=rep.elapsed, telemetry=rep.telemetry)
        snap = est.snapshot(self._progress_rate(rec))
        rec.progress["estimate"] = snap
        self._progress_publish(rec, snap)
        self._portfolio_progress(rec)

    def _progress_publish(self, rec: RequestRecord, snap: dict) -> None:
        if snap.get("progress_ratio") is None:
            return
        labels = dict(request=rec.id, tag=rec.request.tag or rec.id,
                      tenant=rec.request.tenant)
        self.metrics.gauge(
            "tts_progress_ratio",
            "estimated fraction of the search tree explored").set(
            snap["progress_ratio"], **labels)
        self.metrics.gauge(
            "tts_est_tree_size",
            "estimated total search-tree size in nodes").set(
            snap["est_tree_size"], **labels)
        if snap.get("eta_s") is not None:
            self.metrics.gauge(
                "tts_eta_seconds",
                "estimated execution seconds remaining").set(
                snap["eta_s"], **labels)

    def _portfolio_progress(self, rec: RequestRecord) -> None:
        """A racing member's estimate rolls up to its parent: the race
        resolves at the FIRST finisher, so the parent reports the best
        member's view (furthest progress, its ETA)."""
        pid = rec.portfolio_parent
        if pid is None:
            return
        parent = self.records.get(pid)
        if parent is None or parent.portfolio_members is None:
            return
        best = None
        for mid in parent.portfolio_members:
            m = self.records.get(mid)
            est = (m.progress.get("estimate") or {}) if m else {}
            p = est.get("progress_ratio")
            if p is not None and (best is None
                                  or p > best["progress_ratio"]):
                best = {**est, "member": mid}
        if best is not None:
            parent.progress = {**parent.progress, "estimate": best}

    # ------------------------------------------------------------ internals

    def _rec(self, request_id: str) -> RequestRecord:
        try:
            return self.records[request_id]
        except KeyError:
            raise KeyError(f"unknown request id {request_id!r}") from None

    def _stop_slot_of(self, rec: RequestRecord) -> None:
        for slot in self.slots:
            if slot.batch is not None:
                # member-level stop: the batched engine honors the
                # record's stop_reason at the next segment boundary;
                # setting the slot event would stop the WHOLE batch
                if rec in slot.batch:
                    return
            elif slot.record is rec and slot.stop_event is not None:
                slot.stop_event.set()

    def _handle_dispatch_failure(self, rec: RequestRecord, submesh: int,
                                 error: str,
                                 no_retry: bool = False) -> bool:
        """Dispatch-failure bookkeeping shared by the solo and batched
        finish paths (failure log, event, remediation verdict,
        requeue-vs-deadletter-vs-FAILED arbitration — two hand-rolled
        copies would drift, the _record_preempt lesson). Returns True
        when the caller should requeue the record with backoff;
        otherwise it was finalized FAILED here. Caller holds the lock
        and has rolled `spent_prev_s` forward."""
        if no_retry:
            rec.failures = self.service_retry_attempts + 1
        rec.failures += 1
        rec.error = error
        rec.failure_log.append(
            {"t": time.time(), "submesh": submesh,
             "attempt": rec.dispatches, "error": error})
        del rec.failure_log[:-FAILURE_LOG_CAP]
        tracelog.event("request.dispatch_failure", request_id=rec.id,
                       submesh=submesh, attempt=rec.dispatches,
                       error=error)
        if self.ledger is not None:
            self.ledger.journal(
                "failure", rid=rec.id, submesh=submesh,
                attempt=rec.dispatches, error=error,
                failures=rec.failures,
                spent_s=round(rec.spent_prev_s, 3))
        verdict = self.remediation.on_dispatch_failure(rec, submesh,
                                                       error)
        if (verdict == "requeue"
                and rec.failures <= self.service_retry_attempts
                and not self._closing.is_set()):
            rec.state = QUEUED
            self._m_redispatch.inc()
            tracelog.event("request.redispatch", request_id=rec.id,
                           failures=rec.failures, error=error)
            return True
        if verdict == "deadletter":
            self._finalize(
                rec, FAILED,
                error=f"dead-lettered: failed on "
                      f"{len({f['submesh'] for f in rec.failure_log})} "
                      f"distinct submeshes (the fault follows the "
                      f"request); last: {error}")
        else:
            self._finalize(rec, FAILED, error=error)
        return False

    def _record_preempt(self, rec: RequestRecord,
                        reason: str | None) -> bool:
        """PREEMPTED bookkeeping — state, counter, ledger journal,
        trace event — shared by the solo executor, the batched mid-batch
        stop handler and the batched finish path. Returns
        whether the caller should requeue the record (not on
        shutdown, not while parked, not while closing). Caller holds
        the lock and has already rolled `spent_prev_s` forward."""
        rec.state = PREEMPTED
        rec.preemptions += 1
        self._m_preempt.inc()
        if self.ledger is not None:
            self.ledger.journal("preempt", rid=rec.id,
                                preemptions=rec.preemptions,
                                spent_s=round(rec.spent_prev_s, 3),
                                hold=rec.hold)
        tracelog.event("request.preempt", request_id=rec.id,
                       reason=reason or "stop",
                       preemptions=rec.preemptions, hold=rec.hold)
        return (reason != "shutdown" and not rec.hold
                and not self._closing.is_set())

    def _finalize(self, rec: RequestRecord, state: str,
                  error: str | None = None) -> None:
        """Move a record to a terminal state (caller holds the lock)."""
        rec.state = state
        rec.error = error if error is not None else rec.error
        rec.finished_t = time.monotonic()
        key = {DONE: "done", CANCELLED: "cancelled",
               DEADLINE: "deadline", FAILED: "failed"}[state]
        if rec.estimator is not None and state == DONE:
            # DONE makes the estimate exact: pin progress to 1.0 / ETA
            # to 0 in the terminal snapshot (the other terminals keep
            # the last honest estimate — an abandoned tree has no
            # truthful "fraction complete")
            rec.estimator.finalize()
            rec.progress["estimate"] = rec.estimator.snapshot()
        if self.ledger is not None:
            # the full snapshot rides the terminal record: it is what a
            # duplicate tag is served after a restart (and the forensic
            # record of HOW it ended)
            self.ledger.journal("terminal", rid=rec.id, state=state,
                                snapshot=rec.snapshot())
        self._m_terminal.inc(state=key, tenant=rec.request.tenant)
        self._m_spent.observe(rec.spent_s())
        # live-attribution series are per-request labeled; retire them
        # with the request or a long-serving process grows gauge
        # cardinality without bound. Unconditional: remove_matching on
        # a metric that was never created is a free no-op, and gating
        # it on phase_profile left series behind when the knob was
        # flipped off mid-lifetime
        self.metrics.remove_matching("tts_phase_seconds",
                                     request=rec.id)
        # same cardinality valve for the search-telemetry series
        # (engine/telemetry.publish, fed by the heartbeat below)
        from ..engine import telemetry as tele_mod
        for name in tele_mod.SERIES:
            self.metrics.remove_matching(name, request=rec.id)
        # ...and for the progress/ETA estimate family (obs/estimate):
        # the estimate lives on in the terminal snapshot, never as a
        # live series
        for name in ("tts_progress_ratio", "tts_eta_seconds",
                     "tts_est_tree_size"):
            self.metrics.remove_matching(name, request=rec.id)
        tracelog.event(f"request.{key}", request_id=rec.id,
                       tag=rec.request.tag or rec.id,
                       tenant=rec.request.tenant,
                       spent_s=round(rec.spent_s(), 3),
                       dispatches=rec.dispatches,
                       preemptions=rec.preemptions, error=rec.error)
        if self.capacity is not None and rec.result is not None:
            # a finished tree is a measured service demand: explored
            # nodes feed the shape class's evals-per-request EWMA
            self.capacity.on_terminal(
                self._shape_class(rec.request),
                getattr(rec.result, "explored_tree", None),
                service_s=rec.spent_s())
        if state == DONE:
            # retire the checkpoint family: a DONE snapshot left behind
            # would make a tag-reusing resubmission instantly "resume"
            # these counters as a fresh result (the campaign driver's
            # retire-on-done rule). Every other terminal state KEEPS
            # the files: DEADLINE so a larger-deadline resubmission of
            # the tag extends the work, and CANCELLED/FAILED because
            # the tag may name PRE-EXISTING progress this request never
            # touched (a cancelled queued request must not destroy a
            # prior run's partial checkpoint).
            self._unlink_checkpoints(rec)
        rec.done_event.set()
        # bound-portfolio racing hooks (service/portfolio; the lock is
        # an RLock, so the resolution's nested _finalize calls — a
        # member's DONE finalizing the parent, a parent's terminal
        # cancelling queued losers — re-enter here safely)
        if rec.portfolio_parent is not None:
            self.portfolio.on_member_terminal(rec)
        if rec.portfolio_members is not None:
            self.portfolio.on_parent_terminal(rec)

    def _unlink_checkpoints(self, rec: RequestRecord) -> None:
        if not rec.checkpoint_path:
            return
        for suffix in ("", ".prev", ".corrupt"):
            with contextlib.suppress(OSError):
                os.unlink(rec.checkpoint_path + suffix)

    # ---------------------------------------------------------- scheduler

    def _scheduler_loop(self) -> None:
        while not self._closing.is_set():
            self._tick()
            time.sleep(self.poll_s)

    def _tick(self) -> None:
        with self._lock:
            if self._closing.is_set():
                # close() may win the lock between our loop-condition
                # check and here; dispatching now would start a search
                # whose stop_event close() has already swept past —
                # close(wait=True) would then block on the full solve
                return
            if self.fenced:
                # a fenced scheduler tick exits cleanly: nothing may
                # dispatch (every dispatch would journal, and a fenced
                # ledger commits nothing); the adopter serves instead
                return
            now = time.monotonic()
            # 1. deadline enforcement on running requests. A batched
            # member stops ALONE (the engine honors its stop_reason at
            # the next boundary; the slot event would stop the batch)
            for slot in self.slots:
                for rec in slot.records:
                    if (rec.state == RUNNING
                            and rec.stop_reason is None
                            and rec.over_deadline(now)):
                        rec.stop_reason = "deadline"
                        if slot.batch is None:
                            slot.stop_event.set()
                # the lane ledger's periodic sweep: catches transitions
                # with no dedicated sync site (deadline/cancel stops
                # turning a lane draining, a canceled queue emptying a
                # lane) at scheduler-tick resolution
                self._lane_sync(slot)
            if self.megabatch:
                self._tick_megabatch(now)
                return
            # 2. dispatch to free submeshes. Quarantined slots are held
            # out of the partition; each pop honors the request's
            # excluded-submesh set FOR THIS SLOT (skipped entries stay
            # in line at their position). A request whose exclusions
            # cover EVERY healthy (non-quarantined) slot is eligible
            # anywhere again — trying the least-bad submesh beats
            # stranding it QUEUED forever (exclusions can come to
            # cover the partition later, when a quarantine shrinks it
            # after the add_exclusion cap was applied). With
            # remediation off both filters are vacuous and this is the
            # pre-remediation scheduler exactly.
            healthy = [s.index for s in self.slots
                       if not s.quarantined]

            def eligible_for(idx):
                def ok(r):
                    excl = r.excluded_submeshes
                    return idx not in excl \
                        or all(h in excl for h in healthy)
                return ok

            for slot in self.slots:
                if slot.record is not None or slot.quarantined:
                    continue
                idx = slot.index
                rec = self.queue.pop_best(eligible=eligible_for(idx))
                while (rec is not None and rec.over_deadline(now)
                       and rec.dispatches > 0):
                    # a preempted request can exhaust its compute budget
                    # while waiting in line; its partial result stands.
                    # A NEVER-dispatched request over budget (a resumed
                    # tag whose checkpoint already spent more than the
                    # new deadline) still gets ONE dispatch — it stops
                    # at its first segment boundary with a fresh partial
                    # result, like the legacy campaign worker, instead
                    # of finalizing with no result at all
                    self._finalize(rec, DEADLINE)
                    rec = self.queue.pop_best(
                        eligible=eligible_for(idx))
                if rec is None:
                    continue
                self._dispatch(slot, rec)
            # 3. preemption: highest waiting priority vs running
            # requests. Judged against the actual HEAD RECORD, not just
            # its priority: a free slot only suppresses preemption if
            # the head can USE it (a slot it is excluded from does not
            # help — suppressing on it would priority-invert), and a
            # victim is only worth stopping if its slot is one the head
            # can run on.
            head = self.queue.peek_best()
            if head is None:
                return
            best = head.request.priority
            running = [s.record for s in self.slots
                       if s.record is not None
                       and s.record.state == RUNNING]
            if not running or any(
                    s.record is None and not s.quarantined
                    and eligible_for(s.index)(head)
                    for s in self.slots):
                return
            candidates = [r for r in running
                          if r.stop_reason is None
                          and r.submesh is not None
                          and eligible_for(r.submesh)(head)]
            if not candidates:
                return
            victim = min(candidates,
                         key=lambda r: (r.request.priority,
                                        -(r.started_t or 0.0)))
            if best <= victim.request.priority:
                return
            # don't over-preempt: stops already in flight will free slots
            pending = sum(1 for r in running
                          if r.stop_reason in ("preempt", "deadline",
                                               "cancel"))
            waiting_higher = self.queue.count_priority_above(
                victim.request.priority)
            if waiting_higher <= pending:
                return
            victim.stop_reason = "preempt"
            self._stop_slot_of(victim)

    # ------------------------------------------------------- megabatch
    # (TTS_MEGABATCH: the admission queue becomes a batch-former and a
    # closed batch dispatches to one submesh as ONE batched loop —
    # engine/megabatch. The strict-priority preemption pass is
    # a solo-mode feature; megabatch is the throughput mode.)

    def _batch_key(self, rec: RequestRecord) -> tuple:
        """Everything the batched loop specializes on (and the
        segment geometry that must agree for lockstep boundaries) —
        two requests batch together iff these match. Fault-injected
        requests never batch: their injection is scoped to one
        request's executor, and a batch shares one."""
        req = rec.request
        if req.faults is not None or rec.solo_only:
            return ("solo", rec.id)
        return (req.problem, np.asarray(req.p_times).shape,
                req.lb_kind, req.chunk, req.capacity,
                req.balance_period, req.min_seed,
                req.segment_iters or self.segment_iters,
                req.checkpoint_every or self.checkpoint_every)

    def _tick_megabatch(self, now: float) -> None:
        """Steps 2+ of the scheduler tick in megabatch mode (lock
        held): drain the wait line into the former, close ready
        batches onto free healthy submeshes. Submesh exclusions are a
        remediation refinement the batched dispatcher does not honor
        per-slot (a batch of one — the age-closed lone request — goes
        through the ordinary solo path and keeps every solo
        semantic)."""
        while True:
            rec = self.queue.pop_best()
            if rec is None:
                break
            self.former.offer(self._batch_key(rec), rec)
        # the peak-depth high-water must see the former-held wait line
        # (the heap is drained every tick, so it alone would record ~0)
        self.queue.observe_backlog(len(self.former))
        for slot in self.slots:
            if slot.record is not None or slot.quarantined:
                continue
            batch = reason = None
            while batch is None:
                ready = self.former.pop_ready(now)
                if ready is None:
                    break
                cand, reason = ready
                live = []
                for r in cand:
                    if r.over_deadline(now) and r.dispatches > 0:
                        # the solo pop rule: budget exhausted in line,
                        # the partial result stands
                        self._finalize(r, DEADLINE)
                    else:
                        live.append(r)
                batch = live or None
            if batch is None:
                break
            close_t = time.monotonic()
            for r in batch:
                # the queue-wait SLO observes at BATCH-CLOSE: a member
                # held waiting for batchmates (or a free slot) is
                # waiting, and the health engine's queue_wait p99 must
                # see it (the per-request dispatch wait stays visible
                # in snapshots as dispatch_wait_s)
                r.batch_closed_t = close_t
                if r.queued_t:
                    wait = close_t - r.queued_t
                    self._m_queue_wait.observe(
                        wait, tenant=r.request.tenant)
                    if self.capacity is not None:
                        self.capacity.on_queue_wait(r.request.tenant,
                                                    wait)
            self._m_batches.inc(reason=reason)
            self._m_batch_size.observe(len(batch))
            if self.ledger is not None:
                self.ledger.journal("batch", members=[r.id for r in batch],
                                    reason=reason, submesh=slot.index)
            tracelog.event("batch.close", size=len(batch),
                           reason=reason, submesh=slot.index,
                           members=[r.id for r in batch])
            if len(batch) == 1:
                # a lone age-closed request runs the ordinary solo
                # path: exact solo semantics, no batched compile
                self._dispatch(slot, batch[0])
            else:
                self._m_batch_req.inc(len(batch))
                self._dispatch_batch(slot, batch)

    def _dispatch_batch(self, slot: _Slot, recs: list) -> None:
        """Start one executor thread for a closed multi-request batch
        on `slot` (lock held)."""
        bid = f"batch-{next(self._batch_seq):04d}"
        for rec in recs:
            rec.state = RUNNING
            rec.submesh = slot.index
            rec.dispatches += 1
            rec.stop_reason = None
            rec.started_t = time.monotonic()
            rec.last_heartbeat_t = rec.started_t
            rec.dispatch_heartbeats = 0
            rec.batch_id = bid
            if self.ledger is not None:
                self.ledger.journal("dispatch", rid=rec.id,
                                    submesh=slot.index,
                                    dispatch=rec.dispatches,
                                    batch=bid, batch_size=len(recs))
            tracelog.event("request.dispatch", request_id=rec.id,
                           submesh=slot.index, dispatch=rec.dispatches,
                           batch=bid, batch_size=len(recs),
                           queue_depth=len(self.queue))
            if rec.dispatches > 1:
                tracelog.event("request.resume", request_id=rec.id,
                               submesh=slot.index,
                               dispatch=rec.dispatches,
                               preemptions=rec.preemptions,
                               failures=rec.failures)
        slot.record = recs[0]
        slot.batch = list(recs)
        slot.stop_event = threading.Event()
        slot.thread = threading.Thread(
            target=self._execute_batch, args=(slot, list(recs)),
            daemon=True, name=f"tts-service-exec-{slot.index}")
        slot.thread.start()
        self._lane_sync(slot)       # -> compiling

    def _execute_batch(self, slot: _Slot, recs: list) -> None:
        from ..engine import checkpoint, megabatch
        from .. import problems

        req0 = recs[0].request
        p0 = np.asarray(req0.p_times)
        prob = problems.get(req0.problem)
        capacity = req0.capacity or prob.default_capacity(p0)
        evt = slot.stop_event
        bid = recs[0].batch_id
        # the batch key guarantees one shape class for every member
        cap_shape = (self._shape_class(req0)
                     if self.capacity is not None else None)
        if cap_shape is not None:
            self._capacity_seed(cap_shape, p0, req0.lb_kind)

        def hb(b, rep):
            rec = recs[b]
            rec.last_heartbeat_t = time.monotonic()
            rec.dispatch_heartbeats += 1
            if rec.dispatch_heartbeats == 1:
                self._lane_sync(slot)       # compiling -> executing
            if self.capacity is not None and rep.elapsed > 0:
                self.capacity.on_progress(cap_shape,
                                          rep.tree / rep.elapsed)
            # durable budget clock: throttled inside (a hard kill loses
            # at most LEDGER_BUDGET_EVERY_S of spent_s, never the
            # request; the checkpoint meta is the second witness)
            self._ledger_budget(rec)
            rec.progress = {
                "segment": rep.segment, "iters": rep.iters,
                "tree": rep.tree, "sol": rep.sol, "best": rep.best,
                "pool": rep.pool_size,
                "elapsed_s": round(rep.elapsed, 3)}
            if rep.telemetry is not None:
                from ..engine import telemetry as tele_mod
                tele_mod.publish(rep.telemetry, self.metrics,
                                 request=rec.id,
                                 tag=rec.request.tag or rec.id,
                                 tenant=rec.request.tenant)
                rec.progress["telemetry"] = {
                    k: rep.telemetry[k] for k in
                    ("pruning_rate", "frontier_depth",
                     "pool_highwater", "steal_sent", "steal_recv",
                     "improvements")}
            self._progress_update(rec, rep)

        def member_stop(b, rep):
            rec = recs[b]
            if rec.stop_reason is not None:
                return True
            if rec.over_deadline():
                rec.stop_reason = "deadline"
                return True
            return False

        handled: set = set()
        # member -> monotonic stamp of its mid-batch freeze: the time
        # from here to batch return is lane time the member's slice of
        # the submesh sat idle waiting for batchmates to drain —
        # tts_batch_drain_idle_seconds, ROADMAP item 2's motivation
        frozen: dict[int, float] = {}

        def on_member_done(b, res):
            # a drained member turns DONE the moment the engine sees
            # its pool empty — its terminal state (and result()) never
            # waits for slower batchmates
            rec = recs[b]
            with self._lock:
                handled.add(b)
                frozen[b] = time.monotonic()
                rec.spent_prev_s = rec.spent_s()
                rec.started_t = None
                rec.result = res
                rec.error = None
                self._finalize(rec, DONE)
            self._lane_sync(slot)           # -> batch-frozen

        def on_member_stopped(b, res):
            # a stopped member (cancel / deadline / member preempt)
            # finalizes AT the boundary its lanes froze, like a solo
            # request would: its result() unblocks, its spent clock
            # stops accruing batch wall time, and it leaves RUNNING so
            # the health stall rule cannot misread frozen lanes as a
            # wedged submesh while batchmates keep exploring
            rec = recs[b]
            requeue = False
            with self._lock:
                if rec.state in TERMINAL_STATES:
                    return
                handled.add(b)
                frozen[b] = time.monotonic()
                rec.spent_prev_s = rec.spent_s()
                rec.started_t = None
                reason = rec.stop_reason
                rec.result = res
                rec.error = None
                if reason == "deadline" or rec.over_deadline():
                    self._finalize(rec, DEADLINE)
                elif reason == "cancel":
                    self._finalize(rec, CANCELLED)
                else:          # preempt / shutdown / whole-batch stop
                    requeue = self._record_preempt(rec, reason)
            self._lane_sync(slot)   # -> batch-frozen (or draining)
            if requeue:
                self.queue.requeue(rec)

        specs = []
        inc_keys = [None] * len(recs)
        if self.incumbents is not None:
            from ..engine import incumbent as inc_mod
            inc_keys = [inc_mod.share_key(
                np.asarray(r.request.p_times),
                problem=r.request.problem,
                group=r.request.share_group) for r in recs]
        for rec, ikey in zip(recs, inc_keys):
            specs.append(megabatch.MemberSpec(
                table=np.asarray(rec.request.p_times),
                init_ub=rec.request.init_ub,
                checkpoint_path=rec.checkpoint_path,
                checkpoint_meta_extra=(lambda rec=rec: {
                    **(rec.request.checkpoint_meta or {}),
                    **self._ckpt_fence_meta(),
                    **({"progress_est": rec.estimator.to_list()}
                       if rec.estimator is not None else {}),
                    "spent_s": round(rec.spent_s(), 2)}),
                incumbent_key=ikey))

        results = error = None
        no_retry = False
        with tracelog.context(request_id=bid, submesh=slot.index):
            try:
                with tracelog.span(
                        "batch.dispatch", batch=len(recs),
                        problem=req0.problem, jobs=int(p0.shape[1]),
                        lb_kind=req0.lb_kind) as sp:
                    results = megabatch.serve_batch(
                        specs, problem=req0.problem,
                        lb_kind=req0.lb_kind, devices=slot.devices,
                        worker_ids=slot.device_ids,
                        chunk=req0.chunk, capacity=capacity,
                        balance_period=req0.balance_period,
                        min_seed=req0.min_seed,
                        segment_iters=(req0.segment_iters
                                       or self.segment_iters),
                        checkpoint_every=(req0.checkpoint_every
                                          or self.checkpoint_every),
                        heartbeat=hb, member_stop=member_stop,
                        on_member_done=on_member_done,
                        on_member_stopped=on_member_stopped,
                        stop_event=evt, loop_cache=self.cache,
                        incumbent_board=self.incumbents,
                        tuner=self.tuner)
                    sp.set(done=sum(1 for r in results
                                    if r is not None and r.complete))
            except megabatch.MemberIncompatible as e:
                # ONE member's resume state cannot batch (legacy
                # checkpoint dtype/telemetry width, cross-problem tag
                # — invisible to the batch key): demote THAT member to
                # the solo path and requeue every batchmate untouched
                # — nobody ran, nobody earned a failure, and a
                # batch-wide FAILED would dead-letter innocents
                tracelog.event("batch.member_incompatible",
                               request_id=recs[e.member].id,
                               batch=bid, reason=str(e))
                with self._lock:
                    recs[e.member].solo_only = True
                    for rec in recs:
                        if rec.state in TERMINAL_STATES:
                            continue
                        rec.spent_prev_s = rec.spent_s()
                        rec.started_t = None
                        rec.state = QUEUED
                        handled.add(recs.index(rec))
                if not self._closing.is_set():
                    for rec in recs:
                        if rec.state == QUEUED:
                            self.queue.requeue(rec)
            except (LeaseLost, checkpoint.StaleCheckpointError) as e:
                # fenced mid-batch: every unhandled member preempts
                # cleanly at this boundary (journals no-op on the
                # fenced ledger), the solo executor's fence path,
                # batch-wide
                with self._lock:
                    for b, rec in enumerate(recs):
                        if b in handled or rec.state in TERMINAL_STATES:
                            continue
                        rec.spent_prev_s = rec.spent_s()
                        rec.started_t = None
                        self._record_preempt(rec, "fenced")
                        handled.add(b)
                    slot.record = None
                    slot.batch = None
                    slot.stop_event = None
                    slot.thread = None
                    self._lane_sync(slot)   # -> idle
                self._self_fence(f"{type(e).__name__}: {e}")
                return
            except checkpoint.TRANSIENT_ERRORS as e:
                error = f"transient: {e!r}"      # retryable: no_retry
                #                                  stays False
            except Exception as e:  # noqa: BLE001 — FAILED terminal
                error = f"{type(e).__name__}: {e}"
                no_retry = True
            # the measured cost of run-to-drain batching: every
            # mid-batch freeze pays (batch return − freeze) seconds of
            # idle lane share. Observed once per closed batch, before
            # the per-member bookkeeping releases the slot.
            end_t = time.monotonic()
            idle = sum(end_t - t for t in frozen.values())
            if idle > 0:
                self._m_drain_idle.observe(idle)
            self._on_batch_finished(slot, recs, results, error,
                                    handled, no_retry)

    def _on_batch_finished(self, slot: _Slot, recs: list, results,
                           error: str | None, handled: set,
                           no_retry: bool = False) -> None:
        """Per-member terminal/requeue bookkeeping after a batch
        dispatch returns — the batched mirror of `_on_finished`.
        Members the engine already finalized mid-batch (DONE on drain,
        stopped at their boundary — `handled`) are skipped, so a later
        batch-wide error can never smear failure counts onto requests
        that already succeeded or were requeued."""
        requeues = []
        backoff = None
        with self._lock:
            for b, rec in enumerate(recs):
                if b in handled or rec.state in TERMINAL_STATES:
                    continue
                rec.spent_prev_s = rec.spent_s()
                rec.started_t = None
                reason = rec.stop_reason
                if error is not None:
                    if self._handle_dispatch_failure(rec, slot.index,
                                                     error,
                                                     no_retry=no_retry):
                        backoff = backoff_delay(rec.failures - 1,
                                                self.service_retry_base_s)
                        requeues.append(rec)
                    continue
                res = results[b] if results is not None else None
                rec.result = res if res is not None else rec.result
                rec.error = None
                if res is not None and res.complete:
                    self._finalize(rec, DONE)
                elif reason == "deadline" or rec.over_deadline():
                    self._finalize(rec, DEADLINE)
                elif reason == "cancel":
                    self._finalize(rec, CANCELLED)
                elif reason in ("preempt", "shutdown") or evt_set(slot):
                    if self._record_preempt(rec, reason):
                        requeues.append(rec)
                else:
                    self._finalize(
                        rec, FAILED,
                        error="batch member stopped incomplete without "
                              "a stop request (engine bug?)")
        if backoff:
            time.sleep(backoff)
        for rec in requeues:
            self.queue.requeue(rec)
        with self._lock:
            slot.record = None
            slot.batch = None
            slot.stop_event = None
            slot.thread = None
            self._lane_sync(slot)   # -> idle

    def _dispatch(self, slot: _Slot, rec: RequestRecord) -> None:
        """Start one executor thread for `rec` on `slot` (lock held)."""
        rec.state = RUNNING
        rec.submesh = slot.index
        rec.dispatches += 1
        rec.stop_reason = None
        rec.started_t = time.monotonic()
        # the queue-wait SLO observation (admit/requeue -> here) and
        # the stall rule's liveness baseline until the first heartbeat.
        # A batch-of-one dispatch already observed its wait at
        # batch-close (batch_closed_t set) — observing again would
        # double-count the member
        if rec.queued_t and rec.batch_closed_t is None:
            wait = rec.started_t - rec.queued_t
            self._m_queue_wait.observe(wait, tenant=rec.request.tenant)
            if self.capacity is not None:
                self.capacity.on_queue_wait(rec.request.tenant, wait)
        rec.last_heartbeat_t = rec.started_t
        rec.dispatch_heartbeats = 0     # this dispatch warms afresh
        # (stall judges it against the warmup threshold until the
        # engine heartbeats — a resume on a cold submesh pays a compile)
        rec.batch_id = None             # THIS dispatch is solo; a
        # stale id from an earlier batched dispatch would contradict
        # the slot's own (null) batch field in snapshots
        if self.ledger is not None:
            self.ledger.journal("dispatch", rid=rec.id,
                                submesh=slot.index,
                                dispatch=rec.dispatches)
        tracelog.event("request.dispatch", request_id=rec.id,
                       submesh=slot.index, dispatch=rec.dispatches,
                       queue_depth=len(self.queue))
        if rec.dispatches > 1:
            # re-dispatch of preempted/failed work — the flight
            # recorder's "resume" marker the span-sequence tests assert
            tracelog.event("request.resume", request_id=rec.id,
                           submesh=slot.index, dispatch=rec.dispatches,
                           preemptions=rec.preemptions,
                           failures=rec.failures)
        slot.record = rec
        slot.stop_event = threading.Event()
        slot.thread = threading.Thread(
            target=self._execute, args=(slot, rec), daemon=True,
            name=f"tts-service-exec-{slot.index}")
        slot.thread.start()
        self._lane_sync(slot)       # -> compiling

    # ----------------------------------------------------------- executor

    def _execute(self, slot: _Slot, rec: RequestRecord) -> None:
        from ..engine import checkpoint, distributed

        req = rec.request
        p = np.asarray(req.p_times)
        from .. import problems
        prob = problems.get(req.problem)
        jobs, machines = prob.slots(p), p.shape[0]
        capacity = req.capacity or prob.default_capacity(p)
        evt = slot.stop_event
        # phase attribution prices the PFSP kernels; other problems
        # skip it rather than publish numbers measured on the wrong
        # pipeline
        unit_costs = (self._unit_costs(req)
                      if self.phase_profile is not None
                      and req.problem == "pfsp" else None)
        cap_shape = None
        if self.capacity is not None:
            cap_shape = self._shape_class(req)
            self._capacity_seed(cap_shape, p, req.lb_kind)

        def hb(rep):
            rec.last_heartbeat_t = time.monotonic()
            rec.dispatch_heartbeats += 1
            if rec.dispatch_heartbeats == 1:
                self._lane_sync(slot)   # compiling -> executing
            if self.capacity is not None and rep.elapsed > 0:
                self.capacity.on_progress(cap_shape,
                                          rep.tree / rep.elapsed)
            # durable budget clock: throttled inside (a hard kill loses
            # at most LEDGER_BUDGET_EVERY_S of spent_s, never the
            # request; the checkpoint meta is the second witness)
            self._ledger_budget(rec)
            rec.progress = {
                "segment": rep.segment, "iters": rep.iters,
                "tree": rep.tree, "sol": rep.sol, "best": rep.best,
                "pool": rep.pool_size,
                "elapsed_s": round(rep.elapsed, 3)}
            if rep.telemetry is not None:
                # on-device search telemetry (TTS_SEARCH_TELEMETRY):
                # per-request labeled gauges in the server registry —
                # pruning efficiency without opening the trace (series
                # retire with the request, see _finalize) — and the
                # compact rates in the progress snapshot
                from ..engine import telemetry as tele_mod
                tele_mod.publish(rep.telemetry, self.metrics,
                                 request=rec.id, tag=req.tag or rec.id,
                                 tenant=req.tenant)
                rec.progress["telemetry"] = {
                    k: rep.telemetry[k] for k in
                    ("pruning_rate", "frontier_depth",
                     "pool_highwater", "steal_sent", "steal_recv",
                     "improvements")}
            self._progress_update(rec, rep)
            if unit_costs is not None and rep.per_worker is not None:
                self._publish_phases(rec, rep, unit_costs)

        # per-request fault injection stays thread-scoped: it must not
        # leak into requests concurrently served on other submeshes.
        # The plan object is parsed ONCE per request and reused across
        # redispatches so its injection budgets span the request's
        # lifetime (see RequestRecord.fault_plan)
        if req.faults is not None and rec.fault_plan is None:
            rec.fault_plan = faults.FaultPlan.parse(req.faults)
        scope = (faults.scoped(rec.fault_plan)
                 if req.faults is not None
                 else contextlib.nullcontext())
        res = error = None
        # every record the engine emits from this thread (segment spans,
        # checkpoint saves, retries, injected faults) carries the
        # request/submesh identity via the recorder's ambient context
        with tracelog.context(request_id=rec.id, submesh=slot.index):
            try:
                with scope, tracelog.span(
                        "request.execute", dispatch=rec.dispatches,
                        problem=req.problem,
                        jobs=jobs, machines=machines,
                        lb_kind=req.lb_kind) as ex_span:
                    inc_key = None
                    if self.incumbents is not None:
                        from ..engine import incumbent as inc_mod
                        # problem-aware namespacing lives in ONE place
                        # (incumbent.share_key): two problems with
                        # bit-identical tables never exchange bounds
                        inc_key = inc_mod.share_key(
                            p, problem=req.problem,
                            group=req.share_group)
                    res = distributed.search(
                        p, problem=req.problem,
                        lb_kind=req.lb_kind, init_ub=req.init_ub,
                        devices=slot.devices, worker_ids=slot.device_ids,
                        chunk=req.chunk,
                        capacity=capacity,
                        balance_period=req.balance_period,
                        min_seed=req.min_seed,
                        segment_iters=(req.segment_iters
                                       or self.segment_iters),
                        checkpoint_path=rec.checkpoint_path,
                        checkpoint_every=(req.checkpoint_every
                                          or self.checkpoint_every),
                        heartbeat=hb, stop_event=evt,
                        loop_cache=self.cache,
                        overlap=self.overlap,
                        # adaptive dispatch: open knobs (chunk=None /
                        # balance_period=None) resolve via the tuning
                        # cache or the defaults table inside search()
                        tuner=self.tuner,
                        incumbent_board=self.incumbents,
                        incumbent_key=inc_key,
                        # cumulative execution clock rides every
                        # checkpoint (the legacy campaign worker's
                        # spent_s key), so budgets survive preemption,
                        # server restarts and legacy<->serve handoffs
                        checkpoint_meta_extra=lambda: {
                            **(req.checkpoint_meta or {}),
                            # fencing: raises LeaseLost / stamps the
                            # epoch so a stale owner's save can never
                            # land over the adopter's (vacuous outside
                            # fleet mode)
                            **self._ckpt_fence_meta(),
                            # estimator continuity: the same rule as
                            # spent_s — a resume seeds from this vector
                            **({"progress_est":
                                rec.estimator.to_list()}
                               if rec.estimator is not None else {}),
                            "spent_s": round(rec.spent_s(), 2)})
                    ex_span.set(tree=res.explored_tree, best=res.best,
                                complete=res.complete)
            except (LeaseLost, checkpoint.StaleCheckpointError) as e:
                # fenced mid-dispatch (an adopter bumped our epoch):
                # stop cleanly at this boundary, PREEMPTED with the
                # journal no-op'ing on the fenced ledger, never FAILED.
                # The adopter admitted the request again from the
                # ledger; our copy is a husk the operator restarts
                # around.
                with self._lock:
                    rec.spent_prev_s = rec.spent_s()
                    rec.started_t = None
                    if rec.state not in TERMINAL_STATES:
                        self._record_preempt(rec, "fenced")
                    slot.record = None
                    slot.stop_event = None
                    slot.thread = None
                    self._lane_sync(slot)   # -> idle
                self._self_fence(f"{type(e).__name__}: {e}")
                return
            except checkpoint.TRANSIENT_ERRORS as e:
                error = f"transient: {e!r}"
            except Exception as e:  # noqa: BLE001 — FAILED terminal below
                error = f"{type(e).__name__}: {e}"
                rec.failures = self.service_retry_attempts + 1  # no retry
            self._on_finished(slot, rec, res, error)

    def _unit_costs(self, req) -> dict | None:
        """Resolve the phase-attribution unit costs for `req` (see the
        `phase_profile` constructor knob): a shared dict is used as-is;
        True measures utils/phase_timing.profile_phases once per
        (shape, lb, chunk) and caches it for every later request.
        Open-knob (tuned) requests profile at the chunk dispatch will
        actually resolve — never at None."""
        if isinstance(self.phase_profile, dict):
            return self.phase_profile
        p = np.asarray(req.p_times)
        chunk = req.chunk
        if chunk is None:
            chunk = self._resolved_chunk(p, req.lb_kind)
        key = (p.shape, req.lb_kind, chunk)
        with self._lock:
            prof = self._prof_cache.get(key)
        if prof is not None:
            return prof
        from ..engine import device
        from ..ops import batched
        from ..utils import phase_timing
        try:
            with tracelog.span("phase_profile", jobs=p.shape[1],
                               lb_kind=req.lb_kind, chunk=chunk):
                dev = self.slots[0].devices[0]
                tables = batched.make_tables(p, device=dev)
                state = device.init_state(
                    p.shape[1], max(1 << 12, 4 * chunk * p.shape[1]),
                    req.init_ub, p_times=p, device=dev)
                prof = phase_timing.profile_phases(
                    tables, state, req.lb_kind, chunk, warm_iters=4)
        except Exception as e:  # noqa: BLE001 — attribution is an
            # observability extra; its failure must never fail a request
            tracelog.event("phase_profile.failed", error=repr(e))
            prof = None
        with self._lock:
            self._prof_cache[key] = prof
        return prof

    def _resolved_chunk(self, p: np.ndarray, lb_kind: int) -> int:
        """The chunk an open-knob request resolves to at dispatch —
        the tuner's cache-or-defaults tier, mirrored here so anything
        that needs the concrete value BEFORE dispatch (phase
        profiling) sees the same number the engine will run."""
        if self.tuner is not None:
            try:
                return self.tuner.resolve(
                    p.shape[1], p.shape[0], lb_kind,
                    n_workers=len(self.slots[0].devices),
                    device=self.slots[0].devices[0]).chunk
            except Exception:  # noqa: BLE001 — fall to the table
                pass
        from ..tune import defaults as tune_defaults
        return tune_defaults.params_for("serving", p.shape[1],
                                        p.shape[0]).chunk

    def _publish_phases(self, rec: RequestRecord, rep, prof: dict) -> None:
        """Heartbeat hook: attribute the request's CUMULATIVE execution
        clock across kernel/genchild/balance/idle from its per-worker
        counters and publish tts_phase_seconds gauges — the live view of
        the attribution that used to exist only in end-of-run CSVs."""
        from ..utils import phase_timing
        att = phase_timing.attribute(
            prof, elapsed=rec.spent_s(),
            evals=rep.per_worker["evals"], iters=rep.per_worker["iters"])
        phase_timing.publish_attribution(att, registry=self.metrics,
                                         request=rec.id,
                                         tenant=rec.request.tenant)

    def _on_finished(self, slot: _Slot, rec: RequestRecord,
                     res, error: str | None) -> None:
        requeue = backoff = None
        with self._lock:
            rec.spent_prev_s = rec.spent_s()
            rec.started_t = None
            reason = rec.stop_reason
            if error is not None:
                # failure_log append, journal, trace event, remediation
                # verdict and requeue/deadletter/FAILED arbitration all
                # live in _handle_dispatch_failure (shared with the
                # batched finish path). On requeue the slot cools down
                # for the backoff, then the scheduler may re-dispatch
                # to a DIFFERENT submesh (the checkpoint, when one was
                # written, reshards elastically)
                if self._handle_dispatch_failure(rec, slot.index,
                                                 error):
                    backoff = backoff_delay(rec.failures - 1,
                                            self.service_retry_base_s)
                    requeue = rec
            else:
                rec.result = res
                rec.error = None     # a recovered transient is not an error
                if res.complete:
                    self._finalize(rec, DONE)
                elif reason == "deadline" or rec.over_deadline():
                    self._finalize(rec, DEADLINE)
                elif reason == "cancel":
                    self._finalize(rec, CANCELLED)
                elif reason in ("preempt", "shutdown") or evt_set(slot):
                    if self._record_preempt(rec, reason):
                        requeue = rec
                else:
                    self._finalize(
                        rec, FAILED,
                        error="search stopped incomplete without a stop "
                              "request (engine bug?)")
        if backoff:
            time.sleep(backoff)
        if requeue is not None:
            self.queue.requeue(requeue)
        with self._lock:
            slot.record = None
            slot.stop_event = None
            slot.thread = None
            self._lane_sync(slot)   # -> idle


class _ReplayedResult:
    """Duck-typed stand-in for a DistResult, rebuilt from a ledger
    terminal snapshot — enough surface for RequestRecord.snapshot()
    and in-process `result()` readers (per-worker spreads are not
    journaled; `per_device` replays empty)."""

    def __init__(self, d: dict):
        self.best = int(d.get("best") or 0)
        self.explored_tree = int(d.get("explored_tree") or 0)
        self.explored_sol = int(d.get("explored_sol") or 0)
        self.complete = bool(d.get("complete"))
        self.per_device: dict = {}


def evt_set(slot: _Slot) -> bool:
    evt = slot.stop_event
    return evt is not None and evt.is_set()
