"""Self-healing: alert-driven remediation for the search server.

Reproduces `tpu_tree_search/service/remediate.py`
(`RemediationController`, `POLICY`): the same policy table, verdicts,
journal entries, `tts_remediations_total`, `tts_quarantined_submeshes`
and `tts_admission_paused` series, observe and act modes. It subscribes to
the port's `obs/health.HealthMonitor`; its canary probe is a
`distributed.search` on the quarantined slot's workers. A request ledger's
replay at boot restores a pause (`restore_pause`, revalidated by the
worker's `_check_restored_pause`) and a quarantine (`restore_quarantine`,
its canary probe re-armed).

A :class:`RemediationController` per `SearchServer` subscribes to the
health monitor's alert transitions and executes bounded, journaled,
rate-limited actions from a fixed rule -> action policy table:

==================  ====================================================
alert rule          action on ``firing``
==================  ====================================================
``stall``           ``preempt_requeue`` — stop the stalled request at
                    its next segment boundary (the checkpoint machinery
                    makes the stop lossless), append the offending
                    submesh to the request's **excluded-submesh set**
                    (the scheduler honors it at dispatch), and requeue;
                    the request resumes elastically on a healthy submesh
``mem_headroom``    ``shed_memory`` — preempt the lowest-priority
                    RUNNING request (its pools free between dispatches)
                    and raise the chunk-ladder memory-pressure hint
                    (engine/ladder: ramp momentum suppressed, the
                    controller holds the smallest covering rung — node
                    accounting unchanged); cleared on ``resolved``
``compile_storm``   ``pause_admission`` — new submissions are rejected
                    with an explicit "admission paused" reason (the
                    file spool HOLDS its backlog instead of rejecting
                    it) until the alert resolves
``audit``           ``quarantine_checkpoint`` — a failed
                    ``checkpoint_roundtrip`` invariant names the bad
                    snapshot; rename it ``*.corrupt`` so the next load
                    rolls back to the rotating ``.prev`` last-good
==================  ====================================================

Beyond the alert feed, the server's retry tier consults the controller
on every dispatch failure (:meth:`on_dispatch_failure`):

- every failure lands in the request's ``failure_log`` (timestamp,
  submesh, attempt, error — the post-hoc diagnosis surface on
  ``/status`` and in tools/trace_summary.py);
- the failing submesh joins the request's excluded set, so the retry
  tier never redispatches a request onto the submesh that just failed
  it while healthy ones are available;
- failures that FOLLOW the request across >= K distinct submeshes
  (``TTS_REMEDIATE_DEADLETTER_SUBMESHES``) **dead-letter** it: terminal
  FAILED with the complete failure_log, never an infinite redispatch
  loop — the fault is the request, not the hardware;
- failures that stay LOCALIZED to one submesh
  (``TTS_REMEDIATE_QUARANTINE_FAILS`` within the window) **quarantine**
  it: the slot is drained and held out of the partition, then
  **canary-probed** with a synthetic micro-request on a cooldown
  (``TTS_REMEDIATE_PROBE_S``) and readmitted when the probe completes —
  the fault was the hardware, requests route around it meanwhile.

Discipline (the flag-gated, bit-identical-off contract of
overlap/ladder): the whole controller sits behind **TTS_REMEDIATE**
(`serve --remediate`). Default OFF = **observe-only**: detection runs
and every action is journaled as the action the controller *would*
take (outcome ``observed``), but nothing is mutated — behavior is
bit-identical to the pre-remediation server. Every executed action is
hysteresis-gated by the alert lifecycle itself (actions fire on
pending->firing transitions, which carry the rules' dwell) and capped
per rule per sliding window (``TTS_REMEDIATE_MAX_PER_RULE`` /
``TTS_REMEDIATE_WINDOW_S``) — a flapping rule degrades to observe-only
instead of thrashing the scheduler. Everything is journaled three
ways: ``remediation.*`` flight-recorder events,
``tts_remediations_total{rule,action,outcome}`` (plus the
``tts_quarantined_submeshes`` / ``tts_admission_paused`` gauges), and
the ``remediation`` key of ``status_snapshot()``.

Lock order: the server calls into the controller while holding the
server lock (failure verdicts, snapshots), so the controller NEVER
calls into the server while holding its own lock — decisions are taken
under ``self._lock``, actions execute after it is released.
"""

from __future__ import annotations

import collections
import os
import threading
import time

from ..obs import tracelog
from ..utils import config as cfg

__all__ = ["RemediationController", "POLICY"]

# rule -> action executed on the pending->firing transition. Rules
# absent here (queue_wait, pruning_collapse, perf) are diagnosis-only:
# no safe mechanical remediation exists, a human reads the alert.
POLICY = {
    "stall": "preempt_requeue",
    "mem_headroom": "shed_memory",
    "compile_storm": "pause_admission",
    "audit": "quarantine_checkpoint",
}

# actions with a reversal executed on the firing->resolved transition
# (reversals are never rate-limited: a cap that could strand admission
# paused after the storm cleared would turn the valve into an outage)
_REVERSALS = {
    "pause_admission": "resume_admission",
    "shed_memory": "clear_memory_pressure",
}

_JOURNAL_CAP = 256        # bounded journal (snapshot shows the tail)
_FAILURE_WINDOW_CAP = 64  # per-submesh failure timestamps kept


class RemediationController:
    """One per SearchServer; see the module docstring for the policy.

    `enabled=None` resolves TTS_REMEDIATE (default False =
    observe-only). The controller subscribes itself to
    ``server.health`` at construction; `close()` stops the worker.
    """

    def __init__(self, server, enabled: bool | None = None,
                 registry=None,
                 window_s: float | None = None,
                 max_per_rule: int | None = None,
                 quarantine_fails: int | None = None,
                 deadletter_submeshes: int | None = None,
                 probe_s: float | None = None):
        self.server = server
        self.enabled = (cfg.env_flag(cfg.REMEDIATE_FLAG)
                        if enabled is None else bool(enabled))
        self.window_s = float(
            cfg.env_float("TTS_REMEDIATE_WINDOW_S")
            if window_s is None else window_s)
        self.max_per_rule = int(
            cfg.env_int("TTS_REMEDIATE_MAX_PER_RULE")
            if max_per_rule is None else max_per_rule)
        self.quarantine_fails = int(
            cfg.env_int("TTS_REMEDIATE_QUARANTINE_FAILS")
            if quarantine_fails is None else quarantine_fails)
        self.deadletter_submeshes = int(
            cfg.env_int("TTS_REMEDIATE_DEADLETTER_SUBMESHES")
            if deadletter_submeshes is None else deadletter_submeshes)
        self.probe_s = float(
            cfg.env_float("TTS_REMEDIATE_PROBE_S")
            if probe_s is None else probe_s)
        if registry is None:
            from ..obs import metrics as obs_metrics
            registry = obs_metrics.default()
        self._m_actions = registry.counter(
            "tts_remediations_total",
            "remediation decisions by rule/action/outcome")
        self._g_quar = registry.gauge(
            "tts_quarantined_submeshes",
            "submesh slots currently held out of the partition")
        self._g_paused = registry.gauge(
            "tts_admission_paused",
            "1 while the controller holds admission paused")
        self._g_quar.set(0.0)
        self._g_paused.set(0.0)
        self.journal: collections.deque = collections.deque(
            maxlen=_JOURNAL_CAP)                 # guarded-by: self._lock
        self._rule_actions: dict[str, list] = {}  # guarded-by: self._lock
        self._submesh_fails: dict[int, list] = {}  # guarded-by: self._lock
        self._probes_due: dict[int, float] = {}   # guarded-by: self._lock
        # a ledger-restored admission pause awaiting revalidation (the
        # alert that caused it did not survive the crash, so no
        # firing->resolved transition will ever clear it; the worker
        # re-judges the rule itself on this cooldown instead)
        self._pause_check_due: float | None = None  # guarded-by: self._lock
        self._probe_threads: dict = {}            # guarded-by: self._lock
        self._canaries = 0                        # guarded-by: self._lock
        self._lock = threading.Lock()
        self._closing = threading.Event()
        self._wake = threading.Event()
        # listener thread appends, worker drains; guarded-by: self._lock
        self._tasks: collections.deque = collections.deque()
        self._pressure_raised = False   # this controller raised the
        #                                 ladder hint; close() lowers it
        self._worker: threading.Thread | None = None
        if self.enabled:
            self._worker = threading.Thread(
                target=self._worker_loop, daemon=True,
                name="tts-remediation")
            self._worker.start()
        health = getattr(server, "health", None)
        if health is not None:
            health.add_listener(self._on_alert)
        tracelog.event("remediation.start", enabled=self.enabled,
                       window_s=self.window_s,
                       max_per_rule=self.max_per_rule,
                       quarantine_fails=self.quarantine_fails,
                       deadletter_submeshes=self.deadletter_submeshes,
                       probe_s=self.probe_s)

    # ------------------------------------------------------------ feed

    def _on_alert(self, rule: str, transition: str, alert: dict) -> None:
        """HealthMonitor listener (runs on the monitor thread, outside
        the monitor's lock)."""
        action = POLICY.get(rule)
        if action is None:
            return
        if transition == "firing":
            self._submit(rule, action, alert)
        elif transition == "resolved" and action in _REVERSALS:
            self._submit(rule, _REVERSALS[action], alert)

    def _submit(self, rule: str, action: str, alert: dict) -> None:
        if not self.enabled:
            # observe-only: journal the action the controller WOULD
            # take, inline (no worker thread exists in this mode)
            if action in _REVERSALS.values():
                return        # nothing was done, nothing to reverse
            self._journal(rule, action, "observed",
                          detail=alert.get("detail") or {})
            return
        with self._lock:
            self._tasks.append(("alert", rule, action, alert))
        self._wake.set()

    # ---------------------------------------------------------- worker

    def _worker_loop(self) -> None:
        while not self._closing.is_set():
            # sleep until woken (a task or a fresh quarantine) or the
            # next canary comes due — an idle controller costs nothing
            with self._lock:
                due = list(self._probes_due.values())
                if self._pause_check_due is not None:
                    due.append(self._pause_check_due)
            timeout = (max(0.05, min(due) - time.monotonic())
                       if due else None)
            self._wake.wait(timeout=timeout)
            self._wake.clear()
            while True:
                with self._lock:
                    task = (self._tasks.popleft()
                            if self._tasks else None)
                if task is None:
                    break
                try:
                    _, rule, action, alert = task
                    self.handle(rule, action, alert)
                except Exception as e:  # noqa: BLE001 — a broken action
                    # is a journal entry, never a dead controller
                    self._journal(rule, action, "error",
                                  detail={"error": repr(e)})
            try:
                self._run_due_canaries()
            except Exception as e:  # noqa: BLE001 — same stance
                self._journal("quarantine", "canary_probe", "error",
                              detail={"error": repr(e)})
            try:
                self._check_restored_pause()
            except Exception as e:  # noqa: BLE001 — same stance
                self._journal("compile_storm", "resume_admission",
                              "error", detail={"error": repr(e)})

    def close(self) -> None:
        self._closing.set()
        self._wake.set()
        if self._worker is not None:
            self._worker.join(timeout=5)
        if self._pressure_raised:
            # the hint is PROCESS-global (engine/ladder): a server
            # closing mid-incident must not leave later servers in
            # this process silently demoted
            from ..engine import ladder
            ladder.set_memory_pressure(False)
            self._pressure_raised = False

    # ---------------------------------------------------------- actions

    def handle(self, rule: str, action: str, alert: dict) -> str:
        """Execute one policy action (the worker's body; public so tests
        and drills can drive the table synchronously). Returns the
        journaled outcome."""
        detail = dict(alert.get("detail") or {})
        limited = action not in _REVERSALS.values()
        if limited and self._over_limit(rule):
            return self._journal(rule, action, "rate_limited",
                                 detail=detail)
        fn = getattr(self, f"_act_{action}", None)
        if fn is None:
            return self._journal(rule, action, "error",
                                 detail={"error": f"unknown action "
                                                  f"{action!r}"})
        outcome, extra = fn(detail)
        if limited and outcome == "applied":
            # only EXECUTED actions consume the window budget: a run of
            # stale noops (the alerted request finished before the
            # worker got there) must not rate-limit the remediation a
            # genuinely wedged request needs next
            self._note_action(rule)
        return self._journal(rule, action, outcome,
                             detail={**detail, **extra})

    def _over_limit(self, rule: str) -> bool:
        """Sliding-window rate valve: at most `max_per_rule` APPLIED
        actions per rule per `window_s` (see _note_action)."""
        now = time.monotonic()
        with self._lock:
            times = self._rule_actions.setdefault(rule, [])
            times[:] = [t for t in times if now - t < self.window_s]
            return len(times) >= self.max_per_rule

    def _note_action(self, rule: str) -> None:
        with self._lock:
            self._rule_actions.setdefault(rule, []).append(
                time.monotonic())

    def _act_preempt_requeue(self, detail: dict) -> tuple[str, dict]:
        rid = detail.get("request_id")
        if rid is None:
            return "noop", {"why": "alert names no request"}
        # act only if the request is still on the submesh the stall
        # was OBSERVED on: a delayed action on a request the retry
        # tier already moved would exclude a HEALTHY submesh and leave
        # the wedged one eligible
        ok, submesh = self.server.remediate_preempt(
            rid, expected_submesh=detail.get("submesh"))
        if not ok:
            return "noop", {"why": f"{rid} not RUNNING on the "
                                   "observed submesh anymore"}
        return "applied", {"request_id": rid,
                           "excluded_submesh": submesh}

    def _act_shed_memory(self, detail: dict) -> tuple[str, dict]:
        from ..engine import ladder
        self._pressure_raised = True
        ladder.set_memory_pressure(True)
        victim = self.server.lowest_priority_running()
        if victim is None:
            return "applied", {"why": "ladder pressure only; nothing "
                                      "running to shed"}
        ok, _ = self.server.remediate_preempt(victim,
                                              exclude_submesh=False)
        return ("applied" if ok else "noop"), {"request_id": victim}

    def _act_clear_memory_pressure(self, detail: dict
                                   ) -> tuple[str, dict]:
        from ..engine import ladder
        self._pressure_raised = False
        ladder.set_memory_pressure(False)
        return "applied", {}

    def _act_pause_admission(self, detail: dict) -> tuple[str, dict]:
        reason = ("compile storm: executable reuse broken "
                  f"({detail.get('compiles_in_interval', '?')} fresh "
                  "compiles in the last health interval)")
        self.server.pause_admission(reason)
        self._g_paused.set(1.0)
        return "applied", {"reason": reason}

    def _act_resume_admission(self, detail: dict) -> tuple[str, dict]:
        self.server.resume_admission()
        self._g_paused.set(0.0)
        return "applied", {}

    def _act_quarantine_checkpoint(self, detail: dict
                                   ) -> tuple[str, dict]:
        """A failed checkpoint_roundtrip invariant names the bad
        snapshot: quarantine it `*.corrupt` so the next load rolls back
        to the rotating `.prev` last-good (engine/checkpoint's
        load_resilient order)."""
        inner = detail.get("detail") or {}
        if detail.get("invariant") != "checkpoint_roundtrip":
            return "noop", {"why": "audit finding names no checkpoint"}
        path = inner.get("path")
        if not path or not os.path.exists(path):
            return "noop", {"why": f"no snapshot at {path!r}"}
        try:
            os.replace(path, path + ".corrupt")
        except OSError as e:
            return "error", {"error": repr(e), "path": path}
        return "applied", {"path": path,
                           "quarantined_to": path + ".corrupt"}

    # ------------------------------------------------- failure verdicts

    def on_dispatch_failure(self, rec, submesh: int,
                            error: str) -> str:
        """The retry tier's consult, called WITH the server lock held
        (takes only self._lock, never calls back into the server):
        returns ``"requeue"`` or ``"deadletter"`` and, when enabled,
        applies the exclusion / quarantine bookkeeping."""
        now = time.monotonic()
        distinct = {f["submesh"] for f in rec.failure_log}
        # the threshold is clamped to the PARTITION SIZE: on a
        # 2-submesh server a request that failed on both submeshes has
        # followed its fault everywhere it can — demanding 3 distinct
        # submeshes there would make dead-letter unreachable and burn
        # the whole retry budget ping-ponging. A single-submesh server
        # cannot attribute fault (request vs hardware) by geometry at
        # all, so dead-letter never engages and the retry cap governs.
        n_slots = len(self.server.slots)
        threshold = min(self.deadletter_submeshes, n_slots)
        deadletter = n_slots > 1 and len(distinct) >= threshold
        with self._lock:
            fails = self._submesh_fails.setdefault(int(submesh), [])
            fails[:] = [t for t in fails
                        if now - t < self.window_s][-_FAILURE_WINDOW_CAP:]
            fails.append(now)
            quarantine_due = len(fails) >= self.quarantine_fails
        if not self.enabled:
            # observe-only journals EVERY decision it would take —
            # dead-letter, exclusion AND quarantine — so a dry run
            # shows the full would-be containment, not a subset
            if deadletter:
                self._journal("retry", "deadletter", "observed",
                              detail={"request_id": rec.id,
                                      "distinct_submeshes":
                                          sorted(distinct)})
            self._journal("retry", "exclude_submesh", "observed",
                          detail={"request_id": rec.id,
                                  "submesh": int(submesh)})
            if quarantine_due:
                self._journal("quarantine", "quarantine_submesh",
                              "observed",
                              detail={"submesh": int(submesh)})
            return "requeue"
        if deadletter:
            # the submesh's localized-failure evidence stands on its
            # own: a quarantine that came due on THIS failure must not
            # be skipped just because the request also dead-letters
            if quarantine_due:
                self._quarantine(int(submesh))
            self._journal("retry", "deadletter", "applied",
                          detail={"request_id": rec.id,
                                  "distinct_submeshes": sorted(distinct),
                                  "threshold": threshold})
            return "deadletter"
        self.server.add_exclusion(rec, int(submesh))
        self._journal("retry", "exclude_submesh", "applied",
                      detail={"request_id": rec.id,
                              "submesh": int(submesh),
                              "excluded":
                                  sorted(rec.excluded_submeshes)})
        if quarantine_due:
            self._quarantine(int(submesh))
        return "requeue"

    # ------------------------------------------------------- quarantine

    def _quarantine(self, submesh: int) -> None:
        """Hold a submesh out of the partition (caller holds the server
        lock — this is only reached from on_dispatch_failure) and
        schedule its canary probe."""
        slots = self.server.slots
        slot = slots[submesh]
        healthy = sum(1 for s in slots
                      if not s.quarantined and s.index != submesh)
        if slot.quarantined:
            return
        if healthy == 0:
            self._journal("quarantine", "quarantine_submesh",
                          "skipped",
                          detail={"submesh": submesh,
                                  "why": "last healthy submesh — a "
                                         "server with zero capacity "
                                         "is worse than a degraded "
                                         "one"})
            return
        # the server executes (and ledger-journals) the hold: a crash
        # after this point restarts with the submesh still quarantined
        self.server.quarantine_submesh(
            submesh,
            f"{self.quarantine_fails} failures inside "
            f"{self.window_s:g}s localized to this submesh")
        # the drain is implicit: this is only reached from
        # on_dispatch_failure, so the slot's sole occupant is the very
        # request whose failure tripped the threshold — the caller is
        # already requeuing it with this submesh excluded, and a
        # quarantined slot accepts no new dispatches
        with self._lock:
            self._probes_due[submesh] = time.monotonic() + self.probe_s
        self._g_quar.set(float(sum(1 for s in slots if s.quarantined)))
        self._journal("quarantine", "quarantine_submesh", "applied",
                      detail={"submesh": submesh,
                              "probe_in_s": self.probe_s})
        self._wake.set()

    def restore_pause(self, reason: str) -> None:
        """A ledger replay restored an admission pause. The valve holds
        (a crash is not a resume); an ENABLED controller revalidates it
        on a cooldown — the causing alert died with the old process, so
        waiting for its firing->resolved reversal would strand the
        valve shut forever. Observe mode leaves it to the operator."""
        with self._lock:
            if self.enabled:
                self._pause_check_due = time.monotonic() + self.probe_s
        self._journal("compile_storm", "pause_admission", "restored",
                      detail={"reason": reason,
                              "revalidate": self.enabled})
        self._wake.set()

    def _check_restored_pause(self) -> None:
        """Worker tick: resume a restored pause once the compile_storm
        rule is demonstrably quiet (no pending/firing alert); re-arm
        the cooldown while it is not (or while we cannot tell)."""
        with self._lock:
            due = self._pause_check_due
        if due is None or time.monotonic() < due:
            return
        if self.server.admission_paused() is None:
            with self._lock:
                self._pause_check_due = None
            return
        active = True
        mon = getattr(self.server, "health", None)
        if mon is not None:
            try:
                active = any(
                    a.get("rule") == "compile_storm"
                    and a.get("state") in ("pending", "firing")
                    for a in mon.alerts_snapshot().get("alerts", []))
            except Exception:  # noqa: BLE001 — cannot tell: stay shut
                active = True
        with self._lock:
            if active:
                self._pause_check_due = time.monotonic() + self.probe_s
                return
            self._pause_check_due = None
        self._act_resume_admission({})
        self._journal("compile_storm", "resume_admission", "applied",
                      detail={"why": "ledger-restored pause "
                                     "revalidated: compile_storm "
                                     "quiet"})

    def restore_quarantine(self, submesh: int) -> None:
        """A ledger replay restored this slot's quarantine (the slot
        flags are already set by the server's boot pass): re-arm the
        canary probe so an enabled controller can readmit it the same
        way it would have without the crash. In observe mode the
        quarantine stands until an operator readmits — a restart must
        not be a backdoor readmission."""
        with self._lock:
            if self.enabled:
                self._probes_due[int(submesh)] = (time.monotonic()
                                                  + self.probe_s)
        self._g_quar.set(float(sum(
            1 for s in self.server.slots if s.quarantined)))
        self._journal("quarantine", "quarantine_submesh", "restored",
                      detail={"submesh": int(submesh),
                              "why": "replayed from the request ledger",
                              "probe_armed": self.enabled})
        self._wake.set()

    def _run_due_canaries(self) -> None:
        now = time.monotonic()
        with self._lock:
            due = [sm for sm, t in self._probes_due.items()
                   if t <= now and not (
                       (th := self._probe_threads.get(sm)) is not None
                       and th.is_alive())]
        for submesh in due:
            self._canary_probe(submesh)

    def _canary_probe(self, submesh: int) -> None:
        """Synthetic micro-request on the quarantined submesh; a clean
        complete readmits it, a failure re-arms the cooldown.

        The probe runs on its OWN bounded daemon thread: a genuinely
        hung submesh (the very failure quarantine exists for) would
        otherwise block the controller's single worker forever and
        kill self-healing server-wide. A probe that outlives its
        timeout is treated as failed (the thread leaks until the
        runtime returns — the quarantine already isolates the
        hardware) and the cooldown re-arms; no new probe starts for a
        submesh whose previous probe is still in flight."""
        from ..engine import distributed
        from ..problems.pfsp import PFSPInstance
        slot = self.server.slots[submesh]
        with self._lock:
            self._canaries += 1
            n = self._canaries
        p = PFSPInstance.synthetic(jobs=6, machines=3, seed=0).p_times
        box: dict = {}

        def probe():
            # the ambient context makes the probe attributable in the
            # flight recorder AND visible to @submesh-filtered fault
            # plans (a drill's injected fault hits the canary exactly
            # like it would hit a real request on this submesh)
            with tracelog.context(request_id=f"canary-{n}",
                                  submesh=submesh):
                try:
                    res = distributed.search(
                        p, lb_kind=1, init_ub=None, devices=slot.devices,
                        worker_ids=slot.device_ids,
                        chunk=8, capacity=1 << 12, min_seed=4,
                        # bounded: a runaway probe must truncate
                        # (complete=False -> failed probe), not spin
                        max_rounds=4096,
                        loop_cache=self.server.cache)
                    box["ok"] = bool(res.complete)
                except Exception as e:  # noqa: BLE001 — a failed probe
                    box["err"] = repr(e)  # is the expected outcome on
                    #                       a still-broken submesh

        th = threading.Thread(target=probe, daemon=True,
                              name=f"tts-canary-{submesh}")
        with self._lock:
            self._probe_threads[submesh] = th
        th.start()
        th.join(timeout=max(30.0, self.probe_s))
        ok = bool(box.get("ok"))
        err = box.get("err")
        if th.is_alive():
            err = (f"probe still running after "
                   f"{max(30.0, self.probe_s):g}s (hung submesh)")
        if ok:
            self.server.readmit_submesh(submesh)
            with self._lock:
                self._probes_due.pop(submesh, None)
                # the slate is clean: stale failure history must not
                # instantly re-quarantine the readmitted submesh
                self._submesh_fails.pop(submesh, None)
            self._g_quar.set(float(sum(
                1 for s in self.server.slots if s.quarantined)))
            self._journal("quarantine", "readmit_submesh", "applied",
                          detail={"submesh": submesh, "canary": n})
        else:
            with self._lock:
                self._probes_due[submesh] = (time.monotonic()
                                             + self.probe_s)
            self._journal("quarantine", "canary_probe", "failed",
                          detail={"submesh": submesh, "canary": n,
                                  "error": err,
                                  "retry_in_s": self.probe_s})

    # ---------------------------------------------------------- surface

    def _journal(self, rule: str, action: str, outcome: str,
                 detail: dict | None = None) -> str:
        entry = {"t": time.time(), "rule": rule, "action": action,
                 "outcome": outcome, "detail": detail or {}}
        with self._lock:
            self.journal.append(entry)
        self._m_actions.inc(rule=rule, action=action, outcome=outcome)
        tracelog.event(f"remediation.{outcome}", rule=rule,
                       action=action, **(detail or {}))
        return outcome

    def snapshot(self) -> dict:
        """JSON-safe view for status_snapshot()'s `remediation` key
        (callers may hold the server lock; only self._lock is taken)."""
        slots = self.server.slots
        quarantined = [
            {"submesh": s.index, "since": s.quarantined_since,
             "reason": s.quarantine_reason}
            for s in slots if s.quarantined]
        with self._lock:
            actions = list(self.journal)[-32:]
            probes = dict(self._probes_due)
            counts: dict[str, int] = {}
            for e in self.journal:
                k = f"{e['action']}:{e['outcome']}"
                counts[k] = counts.get(k, 0) + 1
        return {"enabled": self.enabled,
                "mode": "act" if self.enabled else "observe",
                "quarantined": quarantined,
                "probes_pending": len(probes),
                "admission_paused": self.server.admission_paused(),
                "counts": counts,
                "actions": actions}
