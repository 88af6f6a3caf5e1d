"""Environment knobs of the port.

Reproduces the accessors of `tpu_tree_search/utils/config.py` (`env_flag`,
`env_str`, `env_int`, `env_float`, `env_ints`, `set_env`) with the same
accepted spellings, and the rows of its knob registry for the knobs the
port reads (among them `LADDER_FLAG`, `TTS_LADDER`, the tuner's and
`TTS_DEBUG_STEP`): a `TTS_*` name must be registered, so a misspelt knob
raises at its first read instead of never applying. The resilience and
tuner defaults are the JAX package's.
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

# the tuner's probe knobs (tune/): TTS_TUNE_CHUNKS / TTS_TUNE_PERIODS
# (comma lists), TTS_TUNE_WINDOW / TTS_TUNE_WARM (iterations)
TUNE_WINDOW_ITERS_DEFAULT = 24    # measured iterations per probe candidate
TUNE_WARM_ITERS_DEFAULT = 200     # warm-up iterations before the windows


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
