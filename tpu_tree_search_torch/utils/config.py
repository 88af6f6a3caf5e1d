"""Environment knobs of the port.

Reproduces the accessors of `tpu_tree_search/utils/config.py` (`env_flag`,
`env_str`, `env_int`, `env_float`, `env_ints`, `set_env`) with the same
accepted spellings, and the rows of its knob registry for the knobs the
port reads (among them `LADDER_FLAG`, `TTS_LADDER`, `OVERLAP_FLAG`, the
tuner's, `TTS_DEBUG_STEP`, and the `TTS_HEALTH_*`, `TTS_SLO_*`,
`TTS_CAPACITY*` and `TTS_PROGRESS*` knobs of `obs/health`, `obs/capacity`
and `obs/estimate`, and the search server's: the `SERVICE_*` defaults,
admission, pre-warm, megabatching, remediation, the tuning cache and the
observability store): a `TTS_*` name must be registered, so a misspelt
knob raises at its first read instead of never applying. The resilience,
tuner and observability defaults (with `PROFILE_MAX_DURATION_S`) are the
JAX package's.
"""

from __future__ import annotations

import os

_TRUTHY = ("1", "true", "on", "yes")

# resilience defaults: engine/checkpoint.run_segmented's env fallbacks
RETRY_ATTEMPTS_DEFAULT = 3
RETRY_BASE_S_DEFAULT = 0.5
SEGMENT_TIMEOUT_S_DEFAULT = 0.0   # 0 = watchdog off

# flight recorder and metrics registry (obs/)
OBS_TRACE_RING_DEFAULT = 16384
OBS_TRACE_MAX_MB_DEFAULT = 64
OBS_METRIC_MAX_SERIES_DEFAULT = 2048

# the cross-request incumbent board's key bound (engine/incumbent.py)
INCUMBENT_MAX_KEYS_DEFAULT = 4096

# chunk-ladder execution (engine/ladder.py): STATIC, default off (off is
# the single-driver path); on, the segmented multi-worker driver switches
# between pre-built chunk rungs at segment boundaries from the pool
# occupancy
LADDER_FLAG = "TTS_LADDER"

# pipelined segmented execution (engine/checkpoint.run_segmented's
# overlapped driver): STATIC, default off. On, the next segment is
# dispatched before the previous segment's counters are read, and
# checkpoint compression and fsync move to a writer thread; the counts are
# the same either way
OVERLAP_FLAG = "TTS_OVERLAP"
# the checkpoint writer thread's queue bound: a dispatch thread that
# outruns the disk blocks in `enqueue` (no snapshot is ever dropped)
ASYNC_CKPT_QUEUE_DEPTH = 2

# the tuner's probe knobs (tune/): TTS_TUNE_CHUNKS / TTS_TUNE_PERIODS
# (comma lists), TTS_TUNE_WINDOW / TTS_TUNE_WARM (iterations)
TUNE_WINDOW_ITERS_DEFAULT = 24    # measured iterations per probe candidate
TUNE_WARM_ITERS_DEFAULT = 200     # warm-up iterations before the windows

# the SLO burn-rate rules (obs/health.py): the error budget, the latency
# target (0: the latency SLO is off) and budget, the fast and slow
# windows, and the burn multiple both windows must exceed
SLO_ERROR_BUDGET_DEFAULT = 0.01
SLO_LATENCY_TARGET_S_DEFAULT = 0.0
SLO_LATENCY_BUDGET_DEFAULT = 0.05
SLO_BURN_FAST_S_DEFAULT = 300.0
SLO_BURN_SLOW_S_DEFAULT = 3600.0
SLO_BURN_THRESHOLD_DEFAULT = 2.0

# the health rules' thresholds (obs/health.py); an interval <= 0 runs no
# daemon thread
OBS_HEALTH_INTERVAL_S_DEFAULT = 2.0
HEALTH_QUEUE_WAIT_P99_S_DEFAULT = 60.0
HEALTH_STALL_S_DEFAULT = 30.0
HEALTH_STALL_WARMUP_S_DEFAULT = 300.0
HEALTH_MEM_FRAC_DEFAULT = 0.92
HEALTH_COMPILE_STORM_DEFAULT = 6
HEALTH_PRUNING_MIN_RATE_DEFAULT = 0.0005
HEALTH_PRUNING_MIN_NODES_DEFAULT = 100_000
HEALTH_AUDIT_WINDOW_S_DEFAULT = 300.0

# progress estimation (obs/estimate.py): the warm-up gate (segments and
# nodes) and the EWMA weight of the newest segment's raw estimate
PROGRESS_WARMUP_SEGMENTS_DEFAULT = 3
PROGRESS_WARMUP_NODES_DEFAULT = 2000
PROGRESS_EWMA_DEFAULT = 0.3

# capacity and utilization (obs/capacity.py): the arrival-rate window,
# the service-rate EWMA weight, and the saturation rule's threshold and
# dwell
CAPACITY_WINDOW_S_DEFAULT = 300.0
CAPACITY_EWMA_DEFAULT = 0.3
HEALTH_SATURATION_DEFAULT = 0.85
HEALTH_SATURATION_FOR_S_DEFAULT = 6.0


# the search server (service/server.py) and the `serve` command: the
# admission bound, the segment length between stop checks (the reaction
# time of preemption, deadlines and cancels), the segments between
# periodic saves (a stop always saves), the scheduler's poll period and
# the re-dispatches after a failed dispatch, with their backoff base
SERVICE_QUEUE_DEPTH_DEFAULT = 64
SERVICE_SEGMENT_ITERS_DEFAULT = 512
SERVICE_CHECKPOINT_EVERY_DEFAULT = 4
SERVICE_POLL_S_DEFAULT = 0.02
SERVICE_RETRY_ATTEMPTS_DEFAULT = 2
SERVICE_RETRY_BASE_S_DEFAULT = 0.2
# the server's resource-sampler period (obs/resource; <= 0: no thread)
OBS_RESOURCE_SAMPLE_S_DEFAULT = 1.0
# the ceiling of a `POST /profile` window (obs/httpd), so that a mistyped
# duration cannot hold the process's one profiler for hours
PROFILE_MAX_DURATION_S = 300.0
# the observability store (obs/store): records a segment, retention and
# the sink queue's bound
OBS_STORE_ENV = "TTS_OBS_STORE"
OBS_STORE_SEGMENT_RECORDS_DEFAULT = 4096
OBS_STORE_RETAIN_S_DEFAULT = 86400.0
OBS_STORE_QUEUE_DEFAULT = 4096
# boot pre-warm: the spec ("spool", "taillard", "JxM"; "0"/"off"/"no"
# disables it even beside --prewarm), its parallel warms, and the Taillard
# shape families (jobs, machines) of "taillard"
PREWARM_ENV = "TTS_PREWARM"
PREWARM_CONCURRENCY_DEFAULT = 2
PREWARM_TAILLARD_FAMILIES = (
    (20, 5), (20, 10), (20, 20),
    (50, 5), (50, 10), (50, 20),
    (100, 5), (100, 10), (100, 20),
    (200, 10), (200, 20), (500, 20),
)
# the shared incumbent board of a server (engine/incumbent.py)
SHARE_INCUMBENT_FLAG = "TTS_SHARE_INCUMBENT"
# the tuning cache directory and boot-time probing (tune/)
TUNE_CACHE_ENV = "TTS_TUNE_CACHE"
TUNE_ENV = "TTS_TUNE"
# request megabatching (service/batching.py, engine/megabatch.py): a batch
# closes at TTS_BATCH_MAX members or when its oldest has waited
# TTS_BATCH_AGE_S seconds
MEGABATCH_FLAG = "TTS_MEGABATCH"
BATCH_MAX_DEFAULT = 8
BATCH_AGE_S_DEFAULT = 0.25
# remediation (service/remediate.py): off is observe-only
REMEDIATE_FLAG = "TTS_REMEDIATE"
REMEDIATE_WINDOW_S_DEFAULT = 300.0
REMEDIATE_MAX_PER_RULE_DEFAULT = 4
REMEDIATE_QUARANTINE_FAILS_DEFAULT = 3
REMEDIATE_DEADLETTER_SUBMESHES_DEFAULT = 3
REMEDIATE_PROBE_S_DEFAULT = 30.0
# the graceful SIGTERM/SIGINT drain budget of `serve`
DRAIN_TIMEOUT_S_DEFAULT = 30.0
# crash-safe serving (service/ledger.py): TTS_LEDGER names the request
# ledger's directory (every request state transition journaled, fsync'd,
# before it is acknowledged, and replayed at boot); a running request's
# spent_s is journaled at most every LEDGER_BUDGET_EVERY_S_DEFAULT seconds
LEDGER_ENV = "TTS_LEDGER"
LEDGER_BUDGET_EVERY_S_DEFAULT = 5.0
# fleet failover (service/lease.py, service/failover.py): TTS_FLEET_DIR is
# the shared root peers scan for expired leases; TTS_FAILOVER=1 arms the
# takeover (default: observe only); TTS_LEASE_TTL_S is the lease's expiry
# age (renewals at about TTL/3, scans at about TTL/2)
FLEET_DIR_ENV = "TTS_FLEET_DIR"
FAILOVER_FLAG = "TTS_FAILOVER"
LEASE_TTL_S_DEFAULT = 10.0
# the disk executor cache, still to port (ROADMAP A9d): the server refuses
# TTS_AOT_CACHE
AOT_CACHE_ENV = "TTS_AOT_CACHE"
# bound-portfolio racing (service/portfolio.py): TTS_PORTFOLIO is the K of
# requests that name none (0: off), TTS_PORTFOLIO_MAX caps it
PORTFOLIO_ENV = "TTS_PORTFOLIO"
PORTFOLIO_MAX_DEFAULT = 8


# the registered knobs and their defaults (None: no default / off)
KNOBS: dict[str, object] = {
    # new states get the search-telemetry vector (engine/telemetry.py)
    "TTS_SEARCH_TELEMETRY": False,
    # resilience (engine/checkpoint.run_segmented): in-place retries of
    # transient errors, their backoff base (seconds), the per-segment
    # wall-clock watchdog (0 = off), the fault-injection plan
    # (utils/faults.py)
    "TTS_RETRY_ATTEMPTS": RETRY_ATTEMPTS_DEFAULT,
    "TTS_RETRY_BASE_S": RETRY_BASE_S_DEFAULT,
    "TTS_SEG_TIMEOUT_S": SEGMENT_TIMEOUT_S_DEFAULT,
    "TTS_FAULTS": None,
    # checkpoint re-read audit ('full', or TTS_AUDIT_CKPT alone), and
    # raising on a failed check (obs/audit.py)
    "TTS_AUDIT": "1",
    "TTS_AUDIT_CKPT": False,
    "TTS_AUDIT_HARD": False,
    # the flight recorder's JSONL sink, ring capacity (records) and sink
    # rotation cap (MB, 0 disables); the per-metric label-set cap
    "TTS_TRACE_FILE": None,
    "TTS_TRACE_RING": OBS_TRACE_RING_DEFAULT,
    "TTS_TRACE_MAX_MB": OBS_TRACE_MAX_MB_DEFAULT,
    "TTS_METRIC_MAX_SERIES": OBS_METRIC_MAX_SERIES_DEFAULT,
    # chunk-ladder execution, and the incumbent board's bound on distinct
    # instance keys (least recently updated evicted first)
    LADDER_FLAG: False,
    # the overlapped segment driver (distributed.search(overlap=None))
    OVERLAP_FLAG: False,
    "TTS_INCUMBENT_MAX_KEYS": INCUMBENT_MAX_KEYS_DEFAULT,
    # the tuner: the candidate ladders (comma lists; unset: the tuner's
    # own), the measured and warm-up iterations of a probe, and probing
    # the winner's ladder rungs when the fused route is off
    "TTS_TUNE_CHUNKS": None,
    "TTS_TUNE_PERIODS": None,
    "TTS_TUNE_WINDOW": TUNE_WINDOW_ITERS_DEFAULT,
    "TTS_TUNE_WARM": TUNE_WARM_ITERS_DEFAULT,
    "TTS_TUNE_RUNGS": False,
    # the LB2 debug tap (engine/device.py): read once at import
    "TTS_DEBUG_STEP": False,
    # the SLO burn-rate rules (obs/health.py)
    "TTS_SLO_ERROR_BUDGET": SLO_ERROR_BUDGET_DEFAULT,
    "TTS_SLO_LATENCY_TARGET_S": SLO_LATENCY_TARGET_S_DEFAULT,
    "TTS_SLO_LATENCY_BUDGET": SLO_LATENCY_BUDGET_DEFAULT,
    "TTS_SLO_BURN_FAST_S": SLO_BURN_FAST_S_DEFAULT,
    "TTS_SLO_BURN_SLOW_S": SLO_BURN_SLOW_S_DEFAULT,
    "TTS_SLO_BURN_THRESHOLD": SLO_BURN_THRESHOLD_DEFAULT,
    # the health monitor's interval and rule thresholds (obs/health.py);
    # the perf rule's verdict file and per-tenant overrides (JSON)
    "TTS_HEALTH_INTERVAL_S": OBS_HEALTH_INTERVAL_S_DEFAULT,
    "TTS_HEALTH_QUEUE_WAIT_P99_S": HEALTH_QUEUE_WAIT_P99_S_DEFAULT,
    "TTS_HEALTH_STALL_S": HEALTH_STALL_S_DEFAULT,
    "TTS_HEALTH_STALL_WARMUP_S": HEALTH_STALL_WARMUP_S_DEFAULT,
    "TTS_HEALTH_MEM_FRAC": HEALTH_MEM_FRAC_DEFAULT,
    "TTS_HEALTH_COMPILE_STORM": HEALTH_COMPILE_STORM_DEFAULT,
    "TTS_HEALTH_PRUNING_MIN_RATE": HEALTH_PRUNING_MIN_RATE_DEFAULT,
    "TTS_HEALTH_PRUNING_MIN_NODES": HEALTH_PRUNING_MIN_NODES_DEFAULT,
    "TTS_HEALTH_AUDIT_WINDOW_S": HEALTH_AUDIT_WINDOW_S_DEFAULT,
    "TTS_HEALTH_PERF_JSON": None,
    "TTS_HEALTH_TENANT_OVERRIDES": None,
    # progress estimation (obs/estimate.py; the deadline_risk and
    # slo_latency_risk rules exist only while it is on)
    "TTS_PROGRESS": True,
    "TTS_PROGRESS_WARMUP_SEGMENTS": PROGRESS_WARMUP_SEGMENTS_DEFAULT,
    "TTS_PROGRESS_WARMUP_NODES": PROGRESS_WARMUP_NODES_DEFAULT,
    "TTS_PROGRESS_EWMA": PROGRESS_EWMA_DEFAULT,
    # capacity and utilization (obs/capacity.py; the saturation rule
    # exists only while it is on)
    "TTS_CAPACITY": True,
    "TTS_CAPACITY_WINDOW_S": CAPACITY_WINDOW_S_DEFAULT,
    "TTS_CAPACITY_EWMA": CAPACITY_EWMA_DEFAULT,
    "TTS_HEALTH_SATURATION": HEALTH_SATURATION_DEFAULT,
    "TTS_HEALTH_SATURATION_FOR_S": HEALTH_SATURATION_FOR_S_DEFAULT,
    # the search server and `serve`: submeshes, the admission bound, the
    # resource sampler, the shared incumbent board, the graceful drain
    "TTS_SUBMESHES": 1,
    "TTS_QUEUE_DEPTH": SERVICE_QUEUE_DEPTH_DEFAULT,
    "TTS_RESOURCE_SAMPLE_S": OBS_RESOURCE_SAMPLE_S_DEFAULT,
    SHARE_INCUMBENT_FLAG: False,
    "TTS_DRAIN_TIMEOUT_S": DRAIN_TIMEOUT_S_DEFAULT,
    # boot pre-warm
    PREWARM_ENV: None,
    "TTS_PREWARM_CONCURRENCY": PREWARM_CONCURRENCY_DEFAULT,
    # the tuning cache directory, and probing cold shapes at boot
    TUNE_CACHE_ENV: None,
    TUNE_ENV: False,
    # the observability store (unset: none)
    OBS_STORE_ENV: None,
    "TTS_OBS_STORE_SEGMENT_RECORDS": OBS_STORE_SEGMENT_RECORDS_DEFAULT,
    "TTS_OBS_STORE_RETAIN_S": OBS_STORE_RETAIN_S_DEFAULT,
    "TTS_OBS_STORE_QUEUE": OBS_STORE_QUEUE_DEFAULT,
    # request megabatching
    MEGABATCH_FLAG: False,
    "TTS_BATCH_MAX": BATCH_MAX_DEFAULT,
    "TTS_BATCH_AGE_S": BATCH_AGE_S_DEFAULT,
    # remediation: act (1) or observe (default), the rate valve's window
    # and cap, the failures that quarantine a submesh, the distinct
    # submeshes that dead-letter a request, the canary probe's cooldown
    REMEDIATE_FLAG: False,
    "TTS_REMEDIATE_WINDOW_S": REMEDIATE_WINDOW_S_DEFAULT,
    "TTS_REMEDIATE_MAX_PER_RULE": REMEDIATE_MAX_PER_RULE_DEFAULT,
    "TTS_REMEDIATE_QUARANTINE_FAILS": REMEDIATE_QUARANTINE_FAILS_DEFAULT,
    "TTS_REMEDIATE_DEADLETTER_SUBMESHES":
        REMEDIATE_DEADLETTER_SUBMESHES_DEFAULT,
    "TTS_REMEDIATE_PROBE_S": REMEDIATE_PROBE_S_DEFAULT,
    # the request ledger, fleet failover (the fleet root, act or observe,
    # the lease's TTL), the disk executor cache (refused until ROADMAP
    # A9d) and portfolio racing (the default K and its cap)
    LEDGER_ENV: None,
    FLEET_DIR_ENV: None,
    FAILOVER_FLAG: False,
    "TTS_LEASE_TTL_S": LEASE_TTL_S_DEFAULT,
    AOT_CACHE_ENV: None,
    PORTFOLIO_ENV: 0,
    "TTS_PORTFOLIO_MAX": PORTFOLIO_MAX_DEFAULT,
}


def _knob_default(name: str, site_default):
    """The call site's explicit default, else the registry row's; a
    `TTS_*` name must have a row."""
    if name.startswith("TTS_"):
        if name not in KNOBS:
            raise KeyError(f"unregistered knob {name!r}: every TTS_* env "
                           "var must have a row in utils/config.KNOBS")
        if site_default is None:
            return KNOBS[name]
    return site_default


def env_flag(name: str, default: bool | None = None) -> bool:
    """A boolean flag: '1'/'true'/'on'/'yes' (any case) is on; other
    values are off; unset or empty is the default."""
    default = bool(_knob_default(name, default) or False)
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    return raw in _TRUTHY


def env_str(name: str, default: str | None = None) -> str | None:
    """String knob; '' and unset both resolve to the default."""
    default = _knob_default(name, default)
    return os.environ.get(name) or default


def env_int(name: str, default: int | None = None) -> int | None:
    """Integer knob; a malformed value falls back to the default."""
    default = _knob_default(name, default)
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def env_float(name: str, default: float | None = None) -> float | None:
    """Float knob; a malformed value falls back to the default."""
    default = _knob_default(name, default)
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def env_ints(name: str, default: tuple = ()) -> tuple:
    """Comma-separated integer-list knob (the tuner's candidate ladders,
    TTS_TUNE_CHUNKS="64,256,1024"); a malformed list falls back whole."""
    _knob_default(name, None)
    raw = os.environ.get(name, "").strip()
    if not raw:
        return tuple(default)
    try:
        vals = tuple(int(t) for t in raw.split(",") if t.strip())
        return vals or tuple(default)
    except ValueError:
        return tuple(default)


def set_env(name: str, value) -> None:
    """Write a knob to the environment (registration-checked like the
    readers, so a knob cannot be spelt one way here and another where it
    is read)."""
    _knob_default(name, None)
    os.environ[name] = str(value)
