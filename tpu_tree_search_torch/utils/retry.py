"""Exponential-backoff retry for transient failures.

A copy of `tpu_tree_search/utils/retry.py` (stdlib only). One helper for
every retry site: segment execution, checkpoint I/O and the per-segment
host fetch (engine/checkpoint.run_segmented). The policy is deliberately
minimal and uniform:

- only TRANSIENT error types are retried; everything else (wrong
  answers, schema errors, watchdog timeouts) propagates immediately —
  retrying a deterministic failure only delays the loud abort;
- delays grow exponentially (``base_s * 2**attempt``) with no jitter:
  the engine's retries guard a single-process resource (device runtime,
  local filesystem), not a contended fleet endpoint, and deterministic
  delays keep the fault-injection tests exact.

Every scheduled retry is recorded in the flight recorder (a ``retry``
event with the operation name, attempt number and error) and counted in
the metrics registry (``tts_retries_total{what=...}``) — one increment
per transient failure that was retried, so the fault-injection tests
can assert the counter exactly (`fail_host_fetch=1` => exactly 1).
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Sequence

__all__ = ["backoff_delay", "backoff_delays", "retry_call"]


def backoff_delay(attempt: int, base_s: float) -> float:
    """Delay before retry number `attempt` (0-based): base_s * 2**attempt."""
    return base_s * (2 ** attempt)


def backoff_delays(attempts: int, base_s: float) -> list[float]:
    """The full backoff schedule: one delay per retry (attempts - 1 of
    them — the last attempt's failure is raised, not slept on)."""
    return [backoff_delay(k, base_s) for k in range(max(attempts, 1) - 1)]


def retry_call(fn: Callable, *, what: str = "operation",
               attempts: int = 3, base_s: float = 0.5,
               transient: Sequence[type] | tuple = (OSError,),
               on_retry: Callable | None = None,
               sleep: Callable[[float], None] = time.sleep):
    """Run `fn()` with exponential-backoff retry on transient errors.

    `transient` is the tuple of exception types worth retrying; any
    other exception propagates immediately. After the final attempt the
    transient error itself is re-raised. `on_retry(attempt, delay, exc)`
    (0-based attempt) is called before each sleep; the default emits a
    RuntimeWarning so silent retries cannot mask a degrading system.
    `sleep` is injectable for deterministic tests.
    """
    transient = tuple(transient)
    attempts = max(attempts, 1)
    for attempt in range(attempts):
        try:
            return fn()
        except transient as e:
            if attempt >= attempts - 1:
                raise
            delay = backoff_delay(attempt, base_s)
            from ..obs import metrics, tracelog
            tracelog.event("retry", what=what, attempt=attempt,
                           delay_s=delay, error=repr(e))
            metrics.default().counter(
                "tts_retries_total",
                "transient-failure retries by operation").inc(what=what)
            if on_retry is not None:
                on_retry(attempt, delay, e)
            else:
                warnings.warn(
                    f"transient {what} failure "
                    f"(attempt {attempt + 1}/{attempts}): {e!r}; "
                    f"retrying in {delay:.2f}s", RuntimeWarning,
                    stacklevel=2)
            sleep(delay)
