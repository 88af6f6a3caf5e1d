"""The request model and lifecycle records of the search server.

Reproduces `tpu_tree_search/service/request.py`: the states,
`TERMINAL_STATES`, `FAILURE_LOG_CAP`, `SearchRequest` (its defaults from
`tune/defaults.py`, its `validate` from the problem plugins) and
`RequestRecord` with the same `snapshot()` keys.

A `SearchRequest` is what a client says to get an instance solved: the
problem table, the bound, an optional seed incumbent, and the serving
knobs (priority, compute deadline, checkpoint tag). The server wraps each
admitted request in a `RequestRecord`, which carries its queue and run
state, the counters of its last segment and its result.

Lifecycle::

    QUEUED -> RUNNING -> DONE
                 |-> PREEMPTED -> (requeued) -> RUNNING -> ...
                 |-> DEADLINE / CANCELLED / FAILED
    QUEUED -> CANCELLED

A PREEMPTED request was checkpointed at its stop boundary, so its next
dispatch resumes it, on any submesh (the elastic reshard of
`engine/checkpoint.reshard_state`). A record also carries what the request
ledger (`ledger_budget_t`), fleet failover (`origin_rid`, `origin_owner`)
and portfolio racing (`portfolio_*`) need; their snapshot keys appear only
when they are set, as in JAX.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from ..tune import defaults as tune_defaults

# request states
QUEUED = "QUEUED"
RUNNING = "RUNNING"
PREEMPTED = "PREEMPTED"
DONE = "DONE"
CANCELLED = "CANCELLED"
DEADLINE = "DEADLINE"
FAILED = "FAILED"

TERMINAL_STATES = frozenset({DONE, CANCELLED, DEADLINE, FAILED})

FAILURE_LOG_CAP = 32        # failure_log entries kept per request


@dataclasses.dataclass
class SearchRequest:
    """One solve request.

    `deadline_s` bounds the request's ACCUMULATED EXECUTION time (summed
    across dispatches), not its wall-clock time in the queue — the same
    semantics as the campaign driver's per-instance TTS_BUDGET_S: a
    request that waited behind others is not charged for the wait. A
    request over its deadline is stopped at the next segment boundary
    and lands in the DEADLINE terminal state with its partial counters
    (and its checkpoint kept, so a later request with a larger deadline
    can resume the work via the same `tag`).

    `tag` names the request's checkpoint family inside the server's
    workdir; it defaults to the assigned request id. Reusing a tag
    across server lifetimes resumes the on-disk state.

    `faults` is a TEST-ONLY per-request fault-injection spec
    (utils/faults syntax), applied thread-scoped so it fires only in
    this request's executor — the deterministic-service-test hook.

    `problem` names the registered workload plugin (problems/base.py);
    `p_times` is then that problem's 2-D instance table (the name is
    kept for wire/schema compatibility — every transport already
    carries it). The default keeps the server a drop-in for every
    existing PFSP client.
    """

    p_times: np.ndarray
    problem: str = "pfsp"
    lb_kind: int = 1
    init_ub: int | None = None
    priority: int = 0            # higher preempts lower
    deadline_s: float | None = None
    tag: str | None = None
    # engine knobs. Defaults single-sourced in tune/defaults.py (the
    # measured table config and bench read too). chunk=None /
    # balance_period=None opts into ADAPTIVE resolution: the server's
    # tuning cache when one is configured, else the defaults table
    # (tune/tuner.Autotuner.resolve — never a probe on the request
    # path). Spool payloads say {"tuned": true} for the same.
    chunk: int | None = tune_defaults.SERVING_CHUNK_DEFAULT
    capacity: int | None = None
    balance_period: int | None = tune_defaults.BALANCE_PERIOD_DEFAULT
    min_seed: int = 32
    segment_iters: int | None = None
    checkpoint_every: int | None = None
    faults: str | None = None
    # extra meta merged into every checkpoint this request writes (the
    # campaign driver stamps inst/lb/chunk/ub_mode so the legacy
    # supervisor's config screen accepts serve-mode checkpoints)
    checkpoint_meta: dict | None = None
    # incumbent-sharing namespace (server-side TTS_SHARE_INCUMBENT /
    # share_incumbent must be on): by default every request solving the
    # SAME instance shares best-makespan bounds (engine/incumbent's
    # content-hash key); a share_group narrows that to requests naming
    # the same group — the tenant/tag-family isolation knob
    share_group: str | None = None
    # bound-portfolio racing (service/portfolio.py): K >= 2 fans this
    # request out as K sibling sub-requests over distinct
    # configurations (bound tiers, tuned chunk plans) sharing one
    # incumbent board; the first sibling to complete with a proof wins
    # and the losers cancel. None (default) = no race; the server may
    # fill in TTS_PORTFOLIO when set
    portfolio: int | None = None
    # accounting tenant: an OPAQUE label the client may stamp on the
    # request ("-" = unattributed). Rides the admit ledger record, the
    # request/phase/search metric families (behind the per-metric
    # cardinality valve) and the flight-recorder journey, so per-team
    # SLO burn and budget spend can be split without the server knowing
    # anything about the teams. Never interpreted by scheduling.
    tenant: str = "-"

    def __post_init__(self):
        # wire payloads carry portfolio as a plain int; normalize the
        # off spellings (0, 1 = a race of one = no race) to None so
        # `portfolio` is truthy exactly when a race is requested
        if self.portfolio in (0, 1):
            self.portfolio = None
        # wire payloads may carry tenant as null/""; both mean
        # unattributed — normalize so label values are never empty
        if not self.tenant:
            self.tenant = "-"

    def validate(self) -> str | None:
        """Admission-side validation; returns a rejection reason or
        None. Table-shape and lb rules come from the problem plugin —
        the single place each workload's instance format is defined."""
        from .. import problems
        try:
            prob = problems.get(self.problem)
        except KeyError:
            return (f"unknown problem {self.problem!r} "
                    f"(registered: {problems.names()})")
        p = np.asarray(self.p_times)
        if p.ndim != 2:
            return f"p_times must be a 2-D table, got shape {p.shape}"
        reason = prob.validate(p)
        if reason is not None:
            return reason
        if self.lb_kind not in prob.lb_kinds:
            return (f"lb_kind must be one of {prob.lb_kinds} for "
                    f"problem {prob.name!r}, got {self.lb_kind}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            return f"deadline_s must be positive, got {self.deadline_s}"
        if self.chunk is not None and self.chunk < 1:
            return f"chunk must be >= 1 (or None = tuned), got {self.chunk}"
        if self.portfolio is not None:
            from ..utils import config
            cap = config.env_int("TTS_PORTFOLIO_MAX",
                                 config.PORTFOLIO_MAX_DEFAULT)
            if not 2 <= self.portfolio <= cap:
                return (f"portfolio must be 2..{cap} "
                        f"(TTS_PORTFOLIO_MAX), got {self.portfolio}")
            if self.faults:
                return "portfolio cannot combine with per-request faults"
        return None


@dataclasses.dataclass
class RequestRecord:
    """Server-side lifecycle record for one admitted request."""

    id: str
    request: SearchRequest
    state: str = QUEUED
    submitted_t: float = 0.0
    queued_t: float = 0.0               # last admit/requeue time — the
                                        # queue-wait clock's start
    last_heartbeat_t: float | None = None   # last engine heartbeat (or
                                        # dispatch) — the stall rule's
                                        # liveness signal
    dispatch_heartbeats: int = 0        # heartbeats since the CURRENT
                                        # dispatch started; 0 means the
                                        # dispatch is still warming
                                        # (possibly a capture on a
                                        # cold submesh), so the stall
                                        # rule judges it against the
                                        # warmup threshold — per
                                        # DISPATCH, or a remediation
                                        # preempt that resumes on a
                                        # cold submesh would re-fire
                                        # stall during the compile and
                                        # ping-pong the request
    started_t: float | None = None      # current dispatch's start
    finished_t: float | None = None
    spent_prev_s: float = 0.0           # execution time of past dispatches
    submesh: int | None = None
    dispatches: int = 0
    preemptions: int = 0
    failures: int = 0                   # submesh failures (re-dispatched)
    # one entry per dispatch failure: {"t", "submesh", "attempt",
    # "error"} — the post-hoc diagnosis surface a dead-lettered FAILED
    # record used to lack (it carried only the LAST error string).
    # Bounded at FAILURE_LOG_CAP; always recorded, remediation on or off
    failure_log: list = dataclasses.field(default_factory=list)
    # submeshes this request must not be dispatched to again (the
    # remediation tier appends the offender on failures/stall preempts;
    # the scheduler honors it). Always empty while TTS_REMEDIATE is
    # off — the default dispatch order is then bit-identical to the
    # pre-remediation scheduler
    excluded_submeshes: set = dataclasses.field(default_factory=set)
    error: str | None = None
    checkpoint_path: str | None = None
    hold: bool = False                  # preempted-and-held (ops drain)
    # the request's PARSED fault plan (utils/faults), built once at
    # first dispatch and reused on every redispatch so injection
    # budgets (kill_submesh=SEG:N, fail_host_fetch=N) span the
    # request's whole service lifetime — a drill fault follows the
    # request like a real poisoned input, it does not re-arm per
    # dispatch. (The GLOBAL TTS_FAULTS plan keeps the per-process
    # re-arm model for respawned campaign workers.)
    fault_plan: object | None = None
    # megabatching (service/batching + engine/megabatch): the id of the
    # batch this request last dispatched in (None = solo), and the
    # batch-close timestamp — the moment the former released it. The
    # tts_queue_wait_seconds observation happens AT close (so the
    # health engine's queue_wait p99 sees the full held wait, not just
    # the post-close dispatch hop); the snapshot keeps the raw
    # admit->dispatch wait separately (dispatch_wait_s)
    batch_id: str | None = None
    batch_closed_t: float | None = None
    # set when a batch dispatch found this request's RESUME STATE
    # incompatible with batching (legacy checkpoint dtype/telemetry
    # width, cross-problem tag): the batch key never groups it again —
    # it age-closes onto the solo path, which handles (or properly
    # rejects) the legacy snapshot. In-memory only: a restart
    # re-discovers the incompatibility at the first re-batch
    solo_only: bool = False
    progress: dict = dataclasses.field(default_factory=dict)
    # online tree-size/progress/ETA estimator (obs/estimate), attached
    # at admission when TTS_PROGRESS is on — None otherwise, and with
    # it every estimator surface (gauges, snapshot keys, checkpoint
    # meta) is absent. Updated from the heartbeat thread; its state
    # vector rides checkpoint meta so resume continues it warm
    estimator: object | None = None
    # last time this request's cumulative spent_s was journaled to the
    # request ledger (service/ledger): the heartbeat hook throttles
    # budget records to LEDGER_BUDGET_EVERY_S so a fast-heartbeating
    # request does not fsync the journal at heartbeat rate
    ledger_budget_t: float = 0.0
    result: object | None = None        # DistResult (final or partial)
    seq: int = 0                        # FIFO tiebreak within a priority
    stop_reason: str | None = None      # why the current stop was asked
    # bound-portfolio racing (service/portfolio.py). A PARENT record
    # (portfolio_members set) is never queued or dispatched: it
    # finalizes from its members' terminals, first proof wins, the rest
    # cancel. A MEMBER record (portfolio_parent set) runs through the
    # ordinary scheduler; its terminal feeds the parent's race.
    portfolio_members: list | None = None   # member rids, fan-out order
    portfolio_parent: str | None = None     # parent rid on members
    portfolio_winner: str | None = None     # winning member rid (parent)
    portfolio_config: dict | None = None    # member's raced config, or
    #                                         the winner's on the parent
    portfolio_cancelled: int = 0            # losers cancelled (parent)
    # failover id lineage (SearchServer.adopt_ledger): an adopted orphan
    # is admitted again under a FRESH rid; these point back at the rid
    # it held in the dead owner's ledger (and that ledger's directory
    # name), so the journey reconstructor stitches ONE request journey
    # across the takeover. None on every locally admitted request.
    origin_rid: str | None = None
    origin_owner: str | None = None
    done_event: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    def spent_s(self, now: float | None = None) -> float:
        """Accumulated execution seconds (the deadline clock)."""
        spent = self.spent_prev_s
        if self.state == RUNNING and self.started_t is not None:
            spent += (now if now is not None else time.monotonic()) \
                - self.started_t
        return spent

    def over_deadline(self, now: float | None = None) -> bool:
        d = self.request.deadline_s
        return d is not None and self.spent_s(now) > d

    def snapshot(self) -> dict:
        """JSON-safe view for the status API."""
        out = {
            "id": self.id,
            "state": self.state,
            "problem": self.request.problem,
            "priority": self.request.priority,
            "deadline_s": self.request.deadline_s,
            "lb_kind": self.request.lb_kind,
            "shape": list(np.asarray(self.request.p_times).shape),
            "submesh": self.submesh,
            "dispatches": self.dispatches,
            "preemptions": self.preemptions,
            "failures": self.failures,
            "failure_log": [dict(f) for f in self.failure_log],
            "excluded_submeshes": sorted(self.excluded_submeshes),
            "spent_s": round(self.spent_s(), 3),
            "error": self.error,
            # flight-recorder cross-reference: filter the JSONL event
            # log / Chrome trace by these to see this request's story
            "tag": self.request.tag or self.id,
            "tenant": self.request.tenant,
            "share_group": self.request.share_group,
            "stop_reason": self.stop_reason,
            "hold": self.hold,
            # liveness for the health layer's stall rule / dashboard:
            # seconds since the engine last heartbeat this request
            # (None unless RUNNING)
            "heartbeat_age_s": (
                round(time.monotonic() - self.last_heartbeat_t, 3)
                if self.state == RUNNING
                and self.last_heartbeat_t is not None else None),
            "dispatch_heartbeats": self.dispatch_heartbeats,
            "batch": self.batch_id,
            # the raw admit/requeue -> dispatch wait of the CURRENT
            # dispatch (None until dispatched). Under megabatching the
            # histogram observes at batch-close instead, so this is
            # the snapshot's per-request witness of the full wait
            "dispatch_wait_s": (
                round(self.started_t - self.queued_t, 3)
                if self.started_t is not None and self.queued_t
                else None),
            "progress": dict(self.progress),
        }
        if self.origin_rid is not None:
            # failover lineage: present only on adopted records, so the
            # snapshot (and the terminal ledger record that embeds it)
            # names the rid and owner this request continued from
            out["origin_rid"] = self.origin_rid
            out["origin_owner"] = self.origin_owner
        if self.portfolio_members is not None:
            out["portfolio"] = {
                "k": len(self.portfolio_members),
                "members": list(self.portfolio_members),
                "winner": self.portfolio_winner,
                "winner_config": (dict(self.portfolio_config)
                                  if self.portfolio_config else None),
                "cancelled": self.portfolio_cancelled,
            }
        elif self.portfolio_parent is not None:
            out["portfolio"] = {
                "parent": self.portfolio_parent,
                "config": (dict(self.portfolio_config)
                           if self.portfolio_config else None),
            }
        res = self.result
        if res is not None:
            out["result"] = {
                "best": int(res.best),
                "explored_tree": int(res.explored_tree),
                "explored_sol": int(res.explored_sol),
                "complete": bool(res.complete),
            }
            tree = np.asarray(res.per_device.get("tree", []))
            if tree.size:
                # per-worker spread of the explored-node counters —
                # the reference's boxplot bundle (utils/stats) riding
                # the status API instead of a CSV post-pass
                from ..utils import stats
                bs = stats.compute_boxplot_stats(tree)
                out["result"]["tree_per_worker"] = dataclasses.asdict(bs)
        return out
