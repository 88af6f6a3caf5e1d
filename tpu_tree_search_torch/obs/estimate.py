"""Online search-tree size / progress estimation (host-side).

Reproduces `tpu_tree_search/obs/estimate.py` (`ProgressEstimator`): the
same model, warm-up gate, smoothing and `to_list` layout, so either
package continues the other's estimate.

The operator's first question — "how far along is this request and
will it meet its deadline?" — has no answer in raw B&B counters: the
explored-node count grows monotonically but the TOTAL tree size is
unknown until the search completes, and wall time spans orders of
magnitude across instances of the same shape.  This module estimates
the total online, in the Knuth '75 / weighted-backtrack-estimator
family (Kilby, Slaney, Thiebaux & Walsh, AAAI 2006 — see PAPERS.md):
instead of probing random root-to-leaf paths, it reuses what the
engine already measures every segment.

Inputs (all already in ``SegmentReport``, zero new device work):

- the cumulative on-device telemetry block (``engine/telemetry.py``)
  when ``TTS_SEARCH_TELEMETRY`` is on: per-depth-bucket popped /
  branched / pruned counts plus the mean relative frontier depth;
- otherwise the aggregate counters every report carries — cumulative
  explored nodes (``tree``) and the live pool size.

Model: B&B exploration below the current frontier is a subcritical
branching process.  Per depth bucket ``k`` the SURVIVOR ratio

    rho_k = (branched_k - pruned_k) / popped_k

is the measured mean number of children of an expanded node that
survive pruning.  The expected total progeny of one open node at
bucket ``k`` then satisfies the cascade

    T_k = 1 + rho_k * T_{k+1}

closed at the deepest bucket with the geometric total ``1/(1-rho)``
(``rho`` clamped below 1 — a supercritical tail has no finite
expectation, so the clamp is the estimator admitting "at least this
much").  Remaining work is ``pool_size * T_f`` where ``f`` is the
bucket of the mean frontier depth; estimated total tree size is
``nodes_done + remaining``.  Without telemetry the same model is
driven by one aggregate ratio from segment deltas: each popped node
is one explored node, so ``rho = 1 + delta_pool / delta_tree``.

Estimates are EWMA-smoothed across segments and published behind a
warmup gate (min segments AND min nodes) so early wild estimates
never reach a gauge.  The PUBLISHED progress is clamped monotone
non-decreasing and strictly below 1.0 until the terminal state
force-finalizes it — so dashboards never show progress moving
backwards and 1.0 always means DONE.

The estimator is pure host-side stdlib (no torch, no numpy): the server
updates it from heartbeat callbacks and serializes its state as a
flat float vector riding checkpoint meta, so resume / elastic reshard
/ failover adoption continue the estimate instead of restarting cold.
"""

from __future__ import annotations

import math

from ..utils import config as cfg

__all__ = ["ProgressEstimator", "DEPTH_BUCKETS"]

# mirror of engine.telemetry.DEPTH_BUCKETS without importing the
# engine (this module stays stdlib-only)
DEPTH_BUCKETS = 8

# survivor-ratio clamp: above this the branching process is treated as
# (barely) subcritical so the geometric tail stays finite.  1/(1-0.95)
# = 20x multiplier at the deepest band — deliberately conservative;
# the acceptance bar is a factor-of-4 at the half-node point, and an
# over-estimate only makes progress pessimistic (never >1.0 early).
_RHO_MAX = 0.95

# serialized-state layout version (first element of to_list())
_STATE_VERSION = 1.0


class ProgressEstimator:
    """Online tree-size/progress/ETA estimate for ONE request.

    Call :meth:`update` once per segment report (cumulative counters),
    read ``progress`` / ``eta_s`` / ``est_total`` after it returns
    True (warmup passed).  :meth:`finalize` pins the terminal value.
    """

    def __init__(self, *,
                 warmup_segments: int | None = None,
                 warmup_nodes: int | None = None,
                 alpha: float | None = None,
                 depth_hint: float | None = None):
        self.warmup_segments = (
            cfg.env_int("TTS_PROGRESS_WARMUP_SEGMENTS")
            if warmup_segments is None else warmup_segments)
        self.warmup_nodes = (
            cfg.env_int("TTS_PROGRESS_WARMUP_NODES")
            if warmup_nodes is None else warmup_nodes)
        self.alpha = (cfg.env_float("TTS_PROGRESS_EWMA")
                      if alpha is None else alpha)
        # total tree depth in LEVELS when the caller knows it (jobs /
        # cities / items — the server passes the instance's first
        # shape axis).  It bounds the cascade horizon: without it the
        # deepest bucket closes with the INFINITE geometric tail, and
        # during the early no-pruning expansion phase (rho at the
        # clamp) that inflates remaining work to ~20x the pool where
        # the finite-depth closure correctly caps it at about
        # pool * levels-still-below-the-frontier
        self.depth_hint = float(depth_hint or 0.0)
        # cumulative witnesses from the latest update
        self.segments = 0          # update() calls observed
        self.nodes = 0.0           # cumulative explored nodes
        self.pool = 0.0            # live open nodes
        # EWMA state
        self.remaining = 0.0       # smoothed estimated remaining nodes
        self.rate = 0.0            # smoothed nodes/s (live segments)
        self.published = 0.0       # monotone published progress
        self.done = False          # finalize() called
        # previous-update witnesses for the aggregate-delta fallback
        # and the rate clock (elapsed resets per dispatch)
        self._prev_nodes = 0.0
        self._prev_pool = 0.0
        self._prev_elapsed = 0.0

    # ------------------------------------------------------------ update

    def update(self, *, tree: float, pool: float, elapsed: float,
               telemetry: dict | None = None) -> bool:
        """Fold one segment report (CUMULATIVE tree count, live pool,
        wall seconds since dispatch start, optional cumulative
        telemetry summarize dict).  Returns True when the estimate is
        past warmup and publishable."""
        if self.done:
            return True
        tree = float(tree)
        pool = float(pool)
        d_nodes = tree - self._prev_nodes
        d_pool = pool - self._prev_pool
        d_elapsed = float(elapsed) - self._prev_elapsed
        self.segments += 1
        self.nodes = tree
        self.pool = pool
        raw = self._raw_remaining(telemetry, d_nodes, d_pool)
        if raw is not None:
            self.remaining = (raw if self.remaining <= 0.0
                              else self.alpha * raw
                              + (1.0 - self.alpha) * self.remaining)
        # node rate over this window; elapsed restarts every dispatch,
        # so a negative delta (resume/preempt boundary) skips the rate
        # sample rather than poisoning the EWMA
        if d_elapsed > 0.0 and d_nodes >= 0.0:
            r = d_nodes / d_elapsed
            self.rate = (r if self.rate <= 0.0
                         else self.alpha * r
                         + (1.0 - self.alpha) * self.rate)
        self._prev_nodes = tree
        self._prev_pool = pool
        self._prev_elapsed = max(float(elapsed), 0.0)
        if self.ready:
            # monotone publish: never below what we already showed,
            # never 1.0 before the terminal state says so
            self.published = min(0.999,
                                 max(self.published, self._raw_progress))
        return self.ready

    def _raw_remaining(self, telemetry: dict | None,
                       d_nodes: float, d_pool: float) -> float | None:
        """One un-smoothed remaining-work estimate, or None when this
        window carries no usable signal (empty pool = nothing left;
        zero expansion = no new evidence)."""
        if self.pool <= 0.0:
            return 0.0
        if telemetry is not None:
            est = self._depth_resolved(telemetry)
            if est is not None:
                return est
        if d_nodes <= 0.0:
            return None
        rho = min(1.0 + d_pool / d_nodes, _RHO_MAX)
        if rho <= 0.0:
            # frontier collapsing faster than it pops: the open nodes
            # themselves are (about) all that remains
            return self.pool
        return self.pool / (1.0 - rho)

    def _depth_resolved(self, tele: dict) -> float | None:
        """Remaining work from the per-bucket survivor-ratio cascade;
        None when the block has no usable per-bucket counts."""
        popped = tele.get("popped")
        branched = tele.get("branched")
        pruned = tele.get("pruned")
        if not popped or not branched or not pruned:
            return None
        n = len(popped)
        rho = []
        for k in range(n):
            p = float(popped[k])
            if p <= 0.0:
                rho.append(None)       # unvisited band: no evidence
                continue
            surv = max(float(branched[k]) - float(pruned[k]), 0.0)
            rho.append(min(surv / p, _RHO_MAX))
        if all(r is None for r in rho):
            return None
        # fill unvisited bands with the nearest measured shallower
        # band (depth-correlated pruning: deeper bands prune harder,
        # so borrowing shallow ratios over-estimates — safe direction)
        last = next(r for r in rho if r is not None)
        for k in range(n):
            if rho[k] is None:
                rho[k] = last
            else:
                last = rho[k]
        # total-progeny cascade.  With a depth hint each bucket spans
        # `levels = depth / n_buckets` tree LEVELS, so a bucket's own
        # progeny is the FINITE geometric sum over those levels and it
        # passes rho^levels survivors on to the next bucket; without a
        # hint the deepest bucket closes with the infinite tail
        cascade = [0.0] * n
        levels = self.depth_hint / n if self.depth_hint > 0.0 else None

        def own(r: float) -> float:
            # sum_{i=0}^{levels-1} r^i (== levels as r -> 1)
            if levels is None:
                return 1.0
            if abs(1.0 - r) < 1e-9:
                return levels
            return (1.0 - r ** levels) / (1.0 - r)

        if levels is None:
            cascade[-1] = 1.0 / (1.0 - min(rho[-1], _RHO_MAX))
            for k in range(n - 2, -1, -1):
                cascade[k] = 1.0 + rho[k] * cascade[k + 1]
        else:
            cascade[-1] = own(rho[-1])
            for k in range(n - 2, -1, -1):
                cascade[k] = own(rho[k]) \
                    + rho[k] ** levels * cascade[k + 1]
        f = float(tele.get("frontier_depth", 0.0))
        band = min(max(int(f * (n - 1)), 0), n - 1)
        return self.pool * cascade[band]

    # -------------------------------------------------------- properties

    @property
    def ready(self) -> bool:
        """Warmup gate: both minimums met (or already finalized)."""
        return self.done or (self.segments >= self.warmup_segments
                             and self.nodes >= self.warmup_nodes)

    @property
    def _raw_progress(self) -> float:
        total = self.nodes + max(self.remaining, 0.0)
        if total <= 0.0:
            return 0.0
        return self.nodes / total

    @property
    def progress(self) -> float | None:
        """Published progress in [0, 1] — monotone non-decreasing,
        exactly 1.0 only after :meth:`finalize`.  None during warmup."""
        if self.done:
            return 1.0
        return self.published if self.ready else None

    @property
    def est_total(self) -> float | None:
        """Estimated total tree size (nodes); None during warmup."""
        if self.done:
            return self.nodes
        if not self.ready:
            return None
        return self.nodes + max(self.remaining, 0.0)

    def eta_s(self, fallback_rate: float | None = None) -> float | None:
        """Estimated seconds of execution remaining.  Uses the live
        node-rate EWMA, falling back to `fallback_rate` (the tuner's
        measured per-shape evals/s) before the first live window; None
        during warmup or with no rate at all."""
        if self.done:
            return 0.0
        if not self.ready:
            return None
        rate = self.rate if self.rate > 0.0 else (fallback_rate or 0.0)
        if rate <= 0.0:
            return None
        return max(self.remaining, 0.0) / rate

    def finalize(self) -> None:
        """Terminal pin: the search completed, so the estimate becomes
        exact — progress 1.0, remaining 0, ETA 0."""
        self.done = True
        self.remaining = 0.0
        self.published = 1.0

    # ----------------------------------------------------- serialization

    def to_list(self) -> list[float]:
        """Flat float vector for checkpoint meta (np.asarray-safe).
        Captures everything :meth:`from_list` needs to continue the
        estimate warm across resume / reshard / adoption."""
        return [_STATE_VERSION,
                float(self.segments), self.nodes, self.pool,
                self.remaining, self.rate, self.published,
                1.0 if self.done else 0.0,
                self._prev_nodes, self._prev_pool, self.depth_hint]

    @classmethod
    def from_list(cls, vec, **kw) -> "ProgressEstimator | None":
        """Rebuild from :meth:`to_list` output (any float sequence);
        None on an unrecognized/short vector — callers fall back to a
        cold estimator rather than crash on foreign meta."""
        try:
            v = [float(x) for x in vec]
        except (TypeError, ValueError):
            return None
        if len(v) < 10 or not math.isclose(v[0], _STATE_VERSION):
            return None
        est = cls(**kw)
        est.segments = int(v[1])
        est.nodes = v[2]
        est.pool = v[3]
        est.remaining = v[4]
        est.rate = v[5]
        est.published = v[6]
        est.done = v[7] >= 1.0
        est._prev_nodes = v[8]
        est._prev_pool = v[9]
        if len(v) > 10 and v[10] > 0.0:
            est.depth_hint = v[10]
        # elapsed is per-dispatch wall time: a restored estimator is
        # by definition on a NEW dispatch, so the rate clock restarts
        est._prev_elapsed = 0.0
        return est

    def snapshot(self, fallback_rate: float | None = None) -> dict:
        """JSON-safe block for the request's progress snapshot."""
        out = {"segments": self.segments}
        p = self.progress
        if p is not None:
            out["progress_ratio"] = round(p, 4)
            out["est_tree_size"] = round(self.est_total)
            eta = self.eta_s(fallback_rate)
            if eta is not None:
                out["eta_s"] = round(eta, 1)
        return out
