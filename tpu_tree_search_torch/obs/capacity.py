"""Fleet capacity & utilization observability (``TTS_CAPACITY``).

Reproduces `tpu_tree_search/obs/capacity.py` (`LaneLedger`,
`CapacityModel`): the same states, accumulators, counters, gauges and
`lane.state` events.

Two cooperating models turn the serving fleet from "busy/idle booleans"
into a measured capacity plan — the planning input ROADMAP item 7's
split/merge scheduler will consume:

- :class:`LaneLedger` — a per-submesh-slot **lane-state ledger**: an
  exact state machine (``idle`` / ``compiling`` / ``executing`` /
  ``draining`` / ``quarantined`` / ``batch-frozen``) driven from the
  scheduler's existing transition points. Every transition closes the
  open interval into a per-state accumulator AND the
  ``tts_lane_seconds_total{lane,state}`` counter, and emits a
  ``lane.state`` trace event (rendered as retrospective state slices on
  a per-lane Perfetto track by obs/chrome_trace). The audit-style
  invariant: per-lane state seconds sum EXACTLY to the lane's
  wall-clock lifetime — conservation holds under preempt, quarantine,
  failover, and mid-batch member freeze, because time is only ever
  moved from the open interval into exactly one state's accumulator.
  The counter rides the durable store's resume whitelist, so a
  restarted server seeds the ledger (:meth:`LaneLedger.seed`) and
  utilization history survives ``kill -9``; replayed seconds are
  tracked separately so the invariant stays statable per lifetime.

- :class:`CapacityModel` — a **shape-class capacity model**: per
  (problem shape class, tenant) arrival rates λ from admission events
  (sliding window, ``TTS_CAPACITY_WINDOW_S``), joined with per-class
  service rates seeded from the TuningCache's measured evals/s and
  corrected by observed segment throughput (EWMA,
  ``TTS_CAPACITY_EWMA``), and mean evals-per-request from terminals.
  E[S] = evals_per_request / evals_per_s gives per-class utilization
  ρ = λ·E[S]/c over c healthy lanes, headroom 1−ρ, and a Little's-law
  (M/M/c-flavored) predicted queue wait W_q ≈ E[S]·ρ/(c·(1−ρ)). The
  **what-if advisor** (:meth:`CapacityModel.what_if`) predicts req/s
  and queue wait for alternative submesh partitions of the same device
  count under linear per-device rate scaling.

Everything here is observation-only and lock-self-contained: callers
(the scheduler under its lock, heartbeat threads without it, the
health daemon) never need the server lock — a racing ``sync`` can at
worst label a sliver of time with the neighboring state, never lose or
double-count it. Stays import-light (stdlib + sibling obs modules).
"""

from __future__ import annotations

import collections
import threading
import time

from . import tracelog
from ..utils import config as cfg

__all__ = ["LANE_STATES", "LaneLedger", "CapacityModel",
           "LANE_SECONDS_METRIC"]

LANE_STATES = ("idle", "compiling", "executing", "draining",
               "quarantined", "batch-frozen")

LANE_SECONDS_METRIC = "tts_lane_seconds_total"
LANE_SECONDS_DOC = ("wall-clock seconds each submesh lane spent in "
                    "each scheduler state (conserved: states sum to "
                    "lane lifetime)")

# admission-stamp ring bound per (shape, tenant) class — enough for any
# window at serving arrival rates; a flood beyond it only degrades the
# λ estimate, never memory
_ADMITS_CAP = 8192


class _Lane:
    __slots__ = ("state", "since", "entered", "acc", "replayed")

    def __init__(self, now: float):
        self.state = "idle"
        self.since = now        # start of the UNACCOUNTED open interval
        self.entered = now      # when the current state was entered
        self.acc: dict[str, float] = {}
        self.replayed = 0.0     # seconds seeded from a prior lifetime


class LaneLedger:
    """Per-lane state accounting with an exact conservation invariant:
    for every lane, ``sum(seconds.values()) == lifetime_s`` (to float
    addition precision), where lifetime is seconds since construction
    plus any replayed prior-lifetime seconds."""

    def __init__(self, registry, lanes, now: float | None = None):
        now = time.monotonic() if now is None else now
        self._lock = threading.Lock()
        self.born = now
        self._counter = registry.counter(LANE_SECONDS_METRIC,
                                         LANE_SECONDS_DOC)
        self._lanes: dict[int, _Lane] = {  # guarded-by: self._lock
            int(i): _Lane(now) for i in lanes}

    # ------------------------------------------------------- accounting

    def seed(self, lane: int, state: str, seconds: float) -> None:
        """Adopt `seconds` of prior-lifetime time in `state` (resumed
        from the durable store's counter replay — the counter itself
        already carries the value, so only the accumulator and the
        replayed ledger move)."""
        with self._lock:
            ln = self._lanes.setdefault(int(lane), _Lane(self.born))
            ln.acc[state] = ln.acc.get(state, 0.0) + float(seconds)
            ln.replayed += float(seconds)

    def transition(self, lane: int, state: str,
                   now: float | None = None) -> None:
        """Move `lane` to `state`; a no-op when already there. Closes
        the open interval into the OUTGOING state's accumulator and
        counter, and emits a ``lane.state`` trace event carrying the
        full duration of the state being left (chrome_trace renders it
        as a retrospective slice)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            ln = self._lanes.setdefault(int(lane), _Lane(now))
            if state == ln.state:
                return
            prev, dur = ln.state, max(now - ln.entered, 0.0)
            self._close(ln, lane, now)
            ln.state, ln.since, ln.entered = state, now, now
        tracelog.event("lane.state", submesh=int(lane), state=state,
                       prev=prev, seconds=dur)

    def flush(self, now: float | None = None) -> None:
        """Close every lane's open interval into its accumulator and
        counter WITHOUT changing state — called before each durable
        sample so persisted counters are current, and at close so the
        final interval is never lost."""
        now = time.monotonic() if now is None else now
        with self._lock:
            for lane, ln in self._lanes.items():
                self._close(ln, lane, now)
                ln.since = now

    def _close(self, ln: _Lane, lane: int, now: float) -> None:
        # holds: self._lock
        delta = now - ln.since
        if delta <= 0:
            return
        ln.acc[ln.state] = ln.acc.get(ln.state, 0.0) + delta
        self._counter.inc(delta, lane=int(lane), state=ln.state)

    # --------------------------------------------------------- reading

    def state_of(self, lane: int) -> str:
        with self._lock:
            ln = self._lanes.get(int(lane))
            return ln.state if ln is not None else "idle"

    def snapshot(self, now: float | None = None) -> list[dict]:
        """Per-lane view: current state, per-state seconds (accumulated
        + the open interval), lifetime, replayed prior-lifetime
        seconds, utilization (executing fraction of lifetime), and the
        conservation error (≈0 by construction)."""
        now = time.monotonic() if now is None else now
        out = []
        with self._lock:
            for lane in sorted(self._lanes):
                ln = self._lanes[lane]
                secs = dict(ln.acc)
                secs[ln.state] = secs.get(ln.state, 0.0) \
                    + max(now - ln.since, 0.0)
                life = max(now - self.born, 0.0) + ln.replayed
                out.append({
                    "lane": lane,
                    "state": ln.state,
                    "seconds": {k: secs[k] for k in sorted(secs)},
                    "lifetime_s": life,
                    "replayed_s": ln.replayed,
                    "utilization": (secs.get("executing", 0.0) / life
                                    if life > 0 else 0.0),
                    "conservation_error_s":
                        sum(secs.values()) - life,
                })
        return out

    def conservation_errors(self, now: float | None = None) -> dict:
        """lane -> |sum(state seconds) − lifetime| (the audit value the
        tests pin to ~0)."""
        return {r["lane"]: abs(r["conservation_error_s"])
                for r in self.snapshot(now)}


class _ShapeStats:
    __slots__ = ("rate_seed", "rate_obs", "evals_per_req",
                 "service_obs", "terminals")

    def __init__(self):
        self.rate_seed: float | None = None   # tuner evals/s
        self.rate_obs: float | None = None    # observed evals/s EWMA
        self.evals_per_req: float | None = None
        self.service_obs: float | None = None  # measured E[S] EWMA
        self.terminals = 0


class CapacityModel:
    """Shape-class demand/capacity model (see module docstring). All
    hooks are cheap and self-locked; ``snapshot()`` also refreshes the
    ``tts_capacity_*`` gauges so the health daemon's evaluation cadence
    drives the published series."""

    def __init__(self, registry, window_s: float | None = None,
                 ewma: float | None = None,
                 now: float | None = None):
        self._lock = threading.Lock()
        self._registry = registry
        self.window_s = float(window_s if window_s is not None
                              else cfg.env_float("TTS_CAPACITY_WINDOW_S"))
        self.ewma = float(ewma if ewma is not None
                          else cfg.env_float("TTS_CAPACITY_EWMA"))
        self.born = time.monotonic() if now is None else now
        # (shape, tenant) -> deque of admission monotonic stamps
        self._admits: dict[tuple, collections.deque] = {}
        self._shapes: dict[str, _ShapeStats] = {}
        # tenant -> (EWMA observed dispatch/queue wait, count)
        self._waits: dict[str, list] = {}
        self._g_util = registry.gauge(
            "tts_capacity_utilization",
            "per-shape-class ρ = arrival demand over healthy-lane "
            "capacity (1.0 = saturated)")
        self._g_head = registry.gauge(
            "tts_capacity_headroom",
            "per-shape-class spare capacity fraction (1 − ρ)")
        self._g_wait = registry.gauge(
            "tts_capacity_predicted_wait_s",
            "Little's-law predicted queue wait per shape class")

    # ---------------------------------------------------------- hooks

    def _ewma(self, old: float | None, new: float) -> float:
        if old is None:
            return float(new)
        return (1 - self.ewma) * old + self.ewma * float(new)

    def on_admit(self, shape: str, tenant: str,
                 now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            dq = self._admits.get((shape, tenant))
            if dq is None:
                dq = self._admits[(shape, tenant)] = collections.deque(
                    maxlen=_ADMITS_CAP)
            dq.append(now)

    def seed_rate(self, shape: str, evals_per_s) -> None:
        """Adopt the TuningCache's measured evals/s for a shape class
        (the dispatch-time seed; observed throughput refines it)."""
        if not evals_per_s:
            return
        with self._lock:
            st = self._shapes.setdefault(shape, _ShapeStats())
            st.rate_seed = float(evals_per_s)

    def on_progress(self, shape: str, evals_per_s: float) -> None:
        """Observed segment throughput (heartbeat tree/elapsed)."""
        if not evals_per_s or evals_per_s <= 0:
            return
        with self._lock:
            st = self._shapes.setdefault(shape, _ShapeStats())
            st.rate_obs = self._ewma(st.rate_obs, evals_per_s)

    def on_terminal(self, shape: str, explored,
                    service_s=None) -> None:
        """A finished request's explored-node total -> per-class mean
        service demand (evals per request, EWMA). `service_s` (the
        request's cumulative execution seconds) additionally feeds a
        DIRECT measured-E[S] estimate — the fallback that keeps the
        model live when requests finish inside their first segment
        (no heartbeat throughput) and the tuner has no seed."""
        with self._lock:
            st = self._shapes.setdefault(shape, _ShapeStats())
            if explored and explored > 0:
                st.evals_per_req = self._ewma(st.evals_per_req,
                                              explored)
            if service_s is not None and service_s > 0:
                st.service_obs = self._ewma(st.service_obs, service_s)
            st.terminals += 1

    def on_queue_wait(self, tenant: str, wait_s: float) -> None:
        """Observed admission-to-dispatch wait, per tenant (the
        measured counterpart the predicted W_q is judged against)."""
        with self._lock:
            w = self._waits.setdefault(str(tenant), [None, 0])
            w[0] = self._ewma(w[0], max(float(wait_s), 0.0))
            w[1] += 1

    # -------------------------------------------------------- modeling

    def _service_s(self, st: _ShapeStats) -> float | None:
        """E[S]: mean per-request lane seconds for a shape class, from
        mean evals/request over the best rate estimate (observed EWMA
        when available, else the tuner seed)."""
        rate = st.rate_obs if st.rate_obs else st.rate_seed
        if not rate or not st.evals_per_req:
            return st.service_obs
        return st.evals_per_req / rate

    @staticmethod
    def _wait(service_s: float, rho: float, lanes: int) -> float | None:
        if rho >= 1.0 or lanes <= 0:
            return None     # saturated: the queue grows without bound
        return service_s * rho / (lanes * (1.0 - rho))

    def snapshot(self, healthy_lanes: int, total_lanes: int,
                 total_devices: int,
                 now: float | None = None) -> dict:
        """The full capacity document (/capacity, status_snapshot's
        ``capacity`` key): per-class rows, overall ρ/headroom/predicted
        wait + req/s for the current partition, per-tenant observed
        waits, and the what-if partition table. Refreshes the
        ``tts_capacity_*`` gauges as a side effect."""
        now = time.monotonic() if now is None else now
        c = max(int(healthy_lanes), 0)
        with self._lock:
            window = max(min(self.window_s, now - self.born), 1e-6)
            classes, demand, lam_total = [], 0.0, 0.0
            lam_known, s_known = 0.0, []
            for (shape, tenant), dq in sorted(self._admits.items()):
                while dq and dq[0] < now - self.window_s:
                    dq.popleft()
                lam = len(dq) / window
                lam_total += lam
                st = self._shapes.get(shape)
                s = self._service_s(st) if st is not None else None
                rho = head = wait = None
                if s is not None and c > 0:
                    demand += lam * s
                    lam_known += lam
                    s_known.append(s)
                    rho = lam * s / c
                    head = 1.0 - rho
                    wait = self._wait(s, rho, c)
                classes.append({
                    "shape": shape, "tenant": tenant,
                    "arrival_per_s": lam, "service_s": s,
                    "utilization": rho, "headroom": head,
                    "predicted_wait_s": wait,
                })
            # overall ρ is None only before ANY service estimate exists
            # (the doctor/CLI columns' documented contract) — a warmed
            # but momentarily idle fleet reports ρ=0, not "unknown".
            # With the arrival window drained, s_agg falls back to the
            # unweighted class mean so the what-if advisor stays live.
            overall = demand / c if (c > 0 and s_known) else None
            s_agg = (demand / lam_known if lam_known > 0
                     else (sum(s_known) / len(s_known)
                           if s_known else None))
            doc = {
                "healthy_lanes": c,
                "lanes": int(total_lanes),
                "devices": int(total_devices),
                "window_s": window,
                "arrival_per_s": lam_total,
                "utilization": overall,
                "headroom": (1.0 - overall
                             if overall is not None else None),
                "predicted_wait_s": (
                    self._wait(s_agg, overall, c)
                    if overall is not None else None),
                "predicted_req_per_s": (c / s_agg if s_agg else None),
                "classes": classes,
                "tenants": {t: {"observed_wait_s": w[0], "waits": w[1]}
                            for t, w in sorted(self._waits.items())},
                "what_if": self._what_if(
                    s_agg, lam_known, int(total_lanes),
                    int(total_devices)),
            }
        self._publish(classes)
        return doc

    def _what_if(self, s_agg, lam, lanes: int, devices: int) -> list:
        """Predicted req/s and queue wait for every partition of the
        SAME devices into n equal lanes (n | devices), under linear
        per-device rate scaling: per-lane E[S] scales with lane width,
        so total throughput is partition-invariant while queue wait
        favors fewer, fatter lanes — the quantified tradeoff against
        per-lane blast radius."""
        if not s_agg or lanes <= 0 or devices <= 0:
            return []
        rows = []
        for n in range(1, devices + 1):
            if devices % n:
                continue
            per = devices // n
            s_n = s_agg * (devices / lanes) / per
            rho = lam * s_n / n
            rows.append({
                "lanes": n, "devices_per_lane": per,
                "service_s": s_n,
                "predicted_req_per_s": n / s_n,
                "utilization": rho,
                "predicted_wait_s": self._wait(s_n, rho, n),
                "current": n == lanes,
            })
        return rows

    def _publish(self, classes: list[dict]) -> None:
        # outside self._lock — gauge writes take the metric's own lock
        for row in classes:
            labels = {"shape": row["shape"], "tenant": row["tenant"]}
            if row["utilization"] is not None:
                self._g_util.set(row["utilization"], **labels)
                self._g_head.set(row["headroom"], **labels)
            if row["predicted_wait_s"] is not None:
                self._g_wait.set(row["predicted_wait_s"], **labels)

    def close(self) -> None:
        """Retire the published gauge series (the per-request-family
        retirement discipline: a closed server leaves no stale
        capacity series behind in a shared registry)."""
        for name in ("tts_capacity_utilization", "tts_capacity_headroom",
                     "tts_capacity_predicted_wait_s"):
            self._registry.remove_matching(name)
