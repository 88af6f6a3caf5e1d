"""Cross-request incumbent sharing: the process-wide best-bound board.

Reproduces `tpu_tree_search/engine/incumbent.py`: `instance_key`,
`share_key`, `IncumbentBoard` and `BoardClient`, with the same keys (the
same strings for the same table), the same fold rules and the same
counters and events.

`IncumbentBoard` maps a problem instance's identity to the best objective
any search has found on it. At every segment boundary a participating
search (`engine/distributed.search(incumbent_board=...)`) publishes its
best (a min-fold: the board only tightens), and before every dispatch it
folds the board's value into each worker's `best` on the device. A fold
only tightens pruning, which keeps the search exact: any published value
is the objective of a real solution of the same instance. `BoardClient`
audits every ceiling it hands out (`obs/audit.check_incumbent_fold`) and
counts the exchanges in `tts_incumbent_folds_total{direction}` ("out":
this search improved the board; "in": the board tightened this search).

Keying: `instance_key` hashes the instance table (shape and bytes), so
only searches on the same instance share; `group` namespaces further.
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import tracelog

__all__ = ["IncumbentBoard", "BoardClient", "instance_key", "share_key"]

# engine/device.I32_MAX, the "no incumbent yet" sentinel: not the
# objective of any solution, so it is never published
_NO_INCUMBENT = np.iinfo(np.int32).max

_FOLDS_HELP = ("cross-request incumbent exchanges by direction "
               "(out = published an improvement to the board, "
               "in = folded a tighter global bound into a search)")


def instance_key(p_times, group: str | None = None) -> str:
    """Problem-instance identity: a content hash of the instance table
    (as int64, shape included), optionally namespaced by `group`."""
    p = np.ascontiguousarray(np.asarray(p_times, dtype=np.int64))
    h = hashlib.sha1()
    h.update(np.asarray(p.shape, np.int64).tobytes())
    h.update(p.tobytes())
    digest = h.hexdigest()[:16]
    return f"{group}/{digest}" if group else digest


def share_key(table, problem: str = "pfsp",
              group: str | None = None) -> str:
    """The share-key rule: PFSP keys are the bare (or group-namespaced)
    digest; every other problem is namespaced by its registry name, so two
    problems with equal tables never exchange bounds."""
    if problem != "pfsp":
        group = f"{problem}:{group}" if group else problem
    return instance_key(table, group=group)


class IncumbentBoard:
    """Thread-safe best-bound map whose values only decrease.

    At most `max_keys` distinct keys (None: TTS_INCUMBENT_MAX_KEYS); an
    entry outlives its search, so a later search of the same instance
    starts from the known best, and past the bound the least recently
    updated key is evicted. A missing entry only forgoes that tightening."""

    def __init__(self, max_keys: int | None = None):
        from ..utils import config as _cfg
        if max_keys is None:
            max_keys = _cfg.env_int("TTS_INCUMBENT_MAX_KEYS")
        self._lock = threading.Lock()
        self._max_keys = max(1, int(max_keys))
        self._best: dict[str, int] = {}   # guarded-by: self._lock

    def publish(self, key: str, value: int, source: str = "") -> bool:
        """Min-fold `value` into the board; True iff it improved the best
        for `key`."""
        value = int(value)
        with self._lock:
            cur = self._best.get(key)
            if cur is not None and cur <= value:
                return False
            # re-insert to mark recency (dict order = update order), then
            # evict the stalest keys past the bound
            self._best.pop(key, None)
            self._best[key] = value
            while len(self._best) > self._max_keys:
                self._best.pop(next(iter(self._best)))
        obs_metrics.default().counter(
            "tts_incumbent_folds_total", _FOLDS_HELP).inc(direction="out")
        tracelog.event("incumbent.publish", key=key, value=value,
                       prev=cur, source=source or None)
        return True

    def peek(self, key: str) -> int | None:
        """The best for `key` (None: nothing published)."""
        with self._lock:
            return self._best.get(key)

    def snapshot(self) -> dict:
        """{key: best}."""
        with self._lock:
            return dict(self._best)

    def __len__(self) -> int:
        with self._lock:
            return len(self._best)


class BoardClient:
    """One search's binding to a board. The search calls `cap` before
    every dispatch and `publish` at every segment boundary; both are host
    calls."""

    def __init__(self, board: IncumbentBoard, key: str, source: str = ""):
        self.board = board
        self.key = key
        self.source = source
        self._last_cap: int | None = None   # last ceiling handed out
        self._last_best: int | None = None  # last local best seen

    def publish(self, best) -> bool:
        best = int(best)
        if best >= _NO_INCUMBENT:
            return False    # nothing found yet
        self._last_best = (best if self._last_best is None
                           else min(self._last_best, best))
        return self.board.publish(self.key, best, source=self.source)

    def cap(self) -> int | None:
        """The pruning ceiling for the next dispatch (None: no fold).

        It folds only when the board is strictly tighter than this
        search's own best: a lone search's entry is its own best, and
        folding it into every worker ahead of the balance round's own
        minimum would change each worker's counts with nothing shared. A
        ceiling looser than one handed out before means the exchange is
        broken: it is audited and clamped (the clamp stays with
        TTS_AUDIT=0)."""
        g = self.board.peek(self.key)
        if g is None or (self._last_best is not None
                         and g >= self._last_best):
            return None
        from ..obs import audit as obs_audit
        audit_on = obs_audit.enabled()
        if self._last_cap is not None and g > self._last_cap:
            if audit_on:
                obs_audit.check_incumbent_fold(self.key, self._last_cap, g)
            g = self._last_cap
        elif audit_on and (self._last_cap is None or g < self._last_cap):
            obs_audit.check_incumbent_fold(self.key, self._last_cap, g)
        if self._last_best is None or g < self._last_best:
            obs_metrics.default().counter(
                "tts_incumbent_folds_total", _FOLDS_HELP).inc(direction="in")
            tracelog.event("incumbent.fold", key=self.key, value=g,
                           local_best=self._last_best,
                           source=self.source or None)
            self._last_best = g
        self._last_cap = g
        return g
