"""Operational health: the SLO/anomaly rules engine over the obs stack.

Reproduces `tpu_tree_search/obs/health.py` (`Thresholds`, `Rule`,
`Alert`, `default_rules`, `HealthMonitor`): the same rules, details,
lifecycle, events and `tts_alerts*` series. The server stays duck-typed:
the rules that read one take whatever object has `status_snapshot()` and
the attributes named below.

The recording stack (flight recorder, metrics, telemetry) shows what
happened; this module judges it: a :class:`HealthMonitor`
evaluates a set of :class:`Rule`\\ s over the live registries and the
server snapshot on a fixed interval (a daemon thread per server, or
on-demand :meth:`HealthMonitor.evaluate_now`), drives each through the
``pending -> firing -> resolved`` alert lifecycle, and publishes every
transition three ways:

- flight-recorder events ``alert.pending`` / ``alert.firing`` /
  ``alert.resolved`` (rule, severity, detail);
- ``tts_alerts{rule,severity}`` gauges (0 = inactive/resolved, 0.5 =
  pending, 1 = firing) plus ``tts_alerts_fired_total{rule}``;
- :meth:`HealthMonitor.alerts_snapshot` — the JSON behind
  ``GET /alerts`` and the ``doctor`` CLI's exit code.

Built-in rule family (:func:`default_rules`; every threshold is an
env-overridable ``TTS_HEALTH_*`` knob, defaults in utils/config.py):

``queue_wait``      windowed p99 of ``tts_queue_wait_seconds`` over the
                    SLO threshold (the admission queue is melting);
``stall``           a RUNNING request's heartbeat age exceeded the
                    limit (wedged submesh / hung dispatch — the live
                    version of the reference's "Still Idle" print);
``pruning_collapse`` a RUNNING request's ``tts_search_pruning_rate``
                    fell to ~zero after enough evaluated children —
                    the search is brute-forcing, the bound is broken;
``mem_headroom``    ``tts_device_bytes_in_use / _limit`` above the
                    fraction — the next pool growth will OOM;
``compile_storm``   fresh unplanned compiles per evaluation
                    interval over the limit — executable reuse has
                    stopped working (shape churn, cache-key
                    regression). Disk-AOT-cache replays, boot pre-warm
                    compiles and chunk-ladder rung pre-readies
                    (``via="ladder"``) do NOT count: a restarted
                    server mass-loading its cache — or a ladder search
                    readying its 2-3 rungs — is the cold-start/
                    adaptive-dispatch machinery working, not a storm;
``audit``           obs/audit recorded a failed node-conservation
                    invariant inside the window (severity critical);
``perf``            a ``perf_sentry --json`` verdict file says FAIL
                    (wire CI's artifact via ``TTS_HEALTH_PERF_JSON``).

The monitor also samples a small history ring per evaluation (queue
depth, busy submeshes, heartbeat age, device bytes, firing count) —
the sparkline feed for ``GET /dashboard`` (obs/dashboard.py).

Everything here is observation-only: rules READ snapshots and
registries, never the engine — search results are bit-identical with
the monitor on or off (JAX pins it in tests/test_health.py).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time

from ..utils import config as cfg
from . import audit, metrics, tracelog

__all__ = ["Alert", "Rule", "HealthMonitor", "Thresholds",
           "default_rules", "PENDING", "FIRING", "RESOLVED"]

PENDING = "pending"
FIRING = "firing"
RESOLVED = "resolved"

_SEVERITY_ORDER = {"critical": 0, "page": 0, "warn": 1, "info": 2}


@dataclasses.dataclass
class Thresholds:
    """The rule family's knobs; :meth:`from_env` reads TTS_HEALTH_*
    through the config accessors (defaults come from the knob
    registry — one source, lint-checked)."""

    queue_wait_p99_s: float = cfg.HEALTH_QUEUE_WAIT_P99_S_DEFAULT
    stall_s: float = cfg.HEALTH_STALL_S_DEFAULT
    stall_warmup_s: float = cfg.HEALTH_STALL_WARMUP_S_DEFAULT
    mem_frac: float = cfg.HEALTH_MEM_FRAC_DEFAULT
    compile_storm: float = cfg.HEALTH_COMPILE_STORM_DEFAULT
    pruning_min_rate: float = cfg.HEALTH_PRUNING_MIN_RATE_DEFAULT
    pruning_min_nodes: float = cfg.HEALTH_PRUNING_MIN_NODES_DEFAULT
    audit_window_s: float = cfg.HEALTH_AUDIT_WINDOW_S_DEFAULT
    perf_json: str | None = None
    # saturation rule (obs/capacity.py's overall ρ; fires on sustained
    # demand over capacity BEFORE the reactive queue_wait p99 can)
    saturation: float = cfg.HEALTH_SATURATION_DEFAULT
    saturation_for_s: float = cfg.HEALTH_SATURATION_FOR_S_DEFAULT
    # SLO burn-rate rules (durable-store terminal history; see the
    # config module's SLO_* block for the window semantics)
    slo_error_budget: float = cfg.SLO_ERROR_BUDGET_DEFAULT
    slo_latency_target_s: float = cfg.SLO_LATENCY_TARGET_S_DEFAULT
    slo_latency_budget: float = cfg.SLO_LATENCY_BUDGET_DEFAULT
    slo_burn_fast_s: float = cfg.SLO_BURN_FAST_S_DEFAULT
    slo_burn_slow_s: float = cfg.SLO_BURN_SLOW_S_DEFAULT
    slo_burn_threshold: float = cfg.SLO_BURN_THRESHOLD_DEFAULT
    # per-tenant overrides (TTS_HEALTH_TENANT_OVERRIDES, a JSON map
    # tenant -> {field: value}): an overridden tenant is judged by its
    # OWN thresholds in the SLO burn and predictive risk rules, with
    # its own tenant-labeled burn series; every other tenant keeps the
    # flat values above
    tenant_overrides: dict = dataclasses.field(default_factory=dict)

    def for_tenant(self, tenant: str | None) -> "Thresholds":
        """This threshold set with `tenant`'s overrides applied (the
        flat set itself for unknown tenants / unknown fields — a typo'd
        override field degrades, never crashes a rule)."""
        over = self.tenant_overrides.get(tenant or "-")
        if not over:
            return self
        known = {f.name for f in dataclasses.fields(self)
                 if f.name != "tenant_overrides"}
        return dataclasses.replace(self, **{
            k: v for k, v in over.items() if k in known})

    @classmethod
    def from_env(cls) -> "Thresholds":
        raw = cfg.env_str("TTS_HEALTH_TENANT_OVERRIDES")
        overrides: dict = {}
        if raw:
            try:
                parsed = json.loads(raw)
                if isinstance(parsed, dict):
                    overrides = {str(t): dict(o)
                                 for t, o in parsed.items()
                                 if isinstance(o, dict)}
            except (ValueError, TypeError):
                # the repo-wide knob stance: a malformed env value
                # degrades to the default, never takes the process down
                pass
        return cls(
            tenant_overrides=overrides,
            queue_wait_p99_s=cfg.env_float("TTS_HEALTH_QUEUE_WAIT_P99_S"),
            stall_s=cfg.env_float("TTS_HEALTH_STALL_S"),
            stall_warmup_s=cfg.env_float("TTS_HEALTH_STALL_WARMUP_S"),
            mem_frac=cfg.env_float("TTS_HEALTH_MEM_FRAC"),
            compile_storm=cfg.env_float("TTS_HEALTH_COMPILE_STORM"),
            pruning_min_rate=cfg.env_float(
                "TTS_HEALTH_PRUNING_MIN_RATE"),
            pruning_min_nodes=cfg.env_float(
                "TTS_HEALTH_PRUNING_MIN_NODES"),
            audit_window_s=cfg.env_float("TTS_HEALTH_AUDIT_WINDOW_S"),
            perf_json=cfg.env_str("TTS_HEALTH_PERF_JSON"),
            saturation=cfg.env_float("TTS_HEALTH_SATURATION"),
            saturation_for_s=cfg.env_float(
                "TTS_HEALTH_SATURATION_FOR_S"),
            slo_error_budget=cfg.env_float("TTS_SLO_ERROR_BUDGET"),
            slo_latency_target_s=cfg.env_float(
                "TTS_SLO_LATENCY_TARGET_S"),
            slo_latency_budget=cfg.env_float("TTS_SLO_LATENCY_BUDGET"),
            slo_burn_fast_s=cfg.env_float("TTS_SLO_BURN_FAST_S"),
            slo_burn_slow_s=cfg.env_float("TTS_SLO_BURN_SLOW_S"),
            slo_burn_threshold=cfg.env_float("TTS_SLO_BURN_THRESHOLD"))


@dataclasses.dataclass
class Rule:
    """One condition. `check(ctx) -> (active, detail)`; `for_s` is the
    dwell an active condition must hold before pending turns firing
    (0 = fire on first active evaluation)."""

    name: str
    check: object                 # callable(ctx) -> (bool, dict)
    severity: str = "warn"
    for_s: float = 0.0
    description: str = ""


@dataclasses.dataclass
class Alert:
    """Lifecycle record of one rule's alert."""

    rule: str
    severity: str
    state: str = PENDING
    since_unix: float = 0.0        # condition first seen active
    firing_since_unix: float | None = None
    resolved_unix: float | None = None
    fired_count: int = 0           # pending->firing transitions
    detail: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class _Ctx:
    """What a rule sees at evaluation time. `snapshot` is computed at
    most once per evaluation (rules share it)."""

    def __init__(self, monitor: "HealthMonitor", now: float):
        self.monitor = monitor
        self.server = monitor.server
        self.registry = monitor.registry
        self.thresholds = monitor.thresholds
        self.now = now
        self._snapshot = None

    @property
    def snapshot(self) -> dict | None:
        if self._snapshot is None and self.server is not None:
            # duck-typed: rule tests attach bare stubs (a cache-only
            # server has no request table, and that is fine)
            fn = getattr(self.server, "status_snapshot", None)
            if fn is not None:
                self._snapshot = fn()
        return self._snapshot

    def gauge_samples(self, name: str) -> list[tuple[dict, float]]:
        """Every (labels, value) sample of a gauge/counter across the
        monitor's registries."""
        out = []
        for reg in self.monitor.registries:
            for m in reg.metrics():
                if m.name == name and hasattr(m, "samples"):
                    out.extend((dict(k), v) for _, k, v in m.samples())
        return out


# ------------------------------------------------------- built-in rules


def _hist_delta_quantile(prev: dict | None, snap: dict,
                         q: float) -> tuple[float | None, int]:
    """Quantile upper bound over the WINDOW between two cumulative
    histogram snapshots (None when the window saw no observations).
    Returns (quantile, window_count)."""
    n = snap.get("count", 0) - (prev or {}).get("count", 0)
    if n <= 0:
        return None, 0
    prev_b = (prev or {}).get("buckets", {})
    target = q * n
    for key, c in sorted(snap.get("buckets", {}).items(),
                         key=lambda kv: float(kv[0])):
        if c - prev_b.get(key, 0) >= target:
            return float(key), n
    return math.inf, n


def default_rules(thresholds: Thresholds) -> list[Rule]:
    """The built-in rule family (closures hold per-monitor state)."""
    th = thresholds
    state: dict = {"qw_prev": None, "misses_prev": None}

    def queue_wait(ctx):
        srv = ctx.server
        if srv is None or getattr(srv, "metrics", None) is None:
            return False, {}
        h = srv.metrics.histogram("tts_queue_wait_seconds")
        # matching, not exact: the family carries a tenant label, and
        # the flat rule judges the all-tenants window (an unlabeled
        # snapshot() of a labeled family is the empty series)
        snap = h.snapshot_matching()
        p99, n = _hist_delta_quantile(state["qw_prev"], snap, 0.99)
        state["qw_prev"] = snap
        if p99 is None:
            return False, {}
        return p99 > th.queue_wait_p99_s, {
            "p99_s": p99, "window_count": n,
            "threshold_s": th.queue_wait_p99_s}

    def stall(ctx):
        ages = getattr(ctx.server, "heartbeat_ages", lambda: {})()
        if not ages:
            return False, {}
        # a request whose CURRENT dispatch has not heartbeat yet is
        # still warming up: the gap includes a trace+compile on an
        # executor-cache miss, which runs to minutes legitimately —
        # judge it against the larger warmup threshold instead of
        # false-firing a critical alert. Per DISPATCH, not per
        # lifetime: a preempted request resuming on a cold submesh
        # pays that compile again, and judging it by its old progress
        # would re-fire stall mid-compile (and, under remediation,
        # ping-pong the request between submeshes). Servers without
        # the dispatch_heartbeats snapshot key (older/duck-typed) fall
        # back to the empty-progress heuristic.
        reqs = (ctx.snapshot or {}).get("requests", {})
        worst = None
        for rid, age in ages.items():
            snap_r = reqs.get(rid) or {}
            if "dispatch_heartbeats" in snap_r:
                warming = not snap_r["dispatch_heartbeats"]
            else:
                warming = not snap_r.get("progress")
            limit = th.stall_warmup_s if warming else th.stall_s
            if age > limit and (worst is None or age > worst[1]):
                worst = (rid, age, limit, warming)
        if worst is None:
            return False, {}
        # the submesh the stall was OBSERVED on rides the detail: a
        # remediation action executing later must not act on a fresh
        # dispatch that already moved elsewhere
        return True, {
            "request_id": worst[0],
            "submesh": (reqs.get(worst[0]) or {}).get("submesh"),
            "heartbeat_age_s": round(worst[1], 3),
            "threshold_s": worst[2], "warming": worst[3]}

    def pruning_collapse(ctx):
        rates = ctx.gauge_samples("tts_search_pruning_rate")
        popped = ctx.gauge_samples("tts_search_popped")
        running = _running_ids(ctx)
        worst = None
        for labels, rate in rates:
            rid = labels.get("request")
            if rid is None or (running is not None
                               and rid not in running):
                continue
            nodes = sum(v for lb, v in popped
                        if lb.get("request") == rid)
            if nodes >= th.pruning_min_nodes \
                    and rate < th.pruning_min_rate:
                if worst is None or rate < worst[1]:
                    worst = (rid, rate, nodes)
        if worst is None:
            return False, {}
        return True, {"request_id": worst[0], "pruning_rate": worst[1],
                      "popped": worst[2],
                      "threshold_rate": th.pruning_min_rate}

    def mem_headroom(ctx):
        use = {tuple(sorted(lb.items())): v
               for lb, v in ctx.gauge_samples("tts_device_bytes_in_use")}
        worst = None
        for lb, limit in ctx.gauge_samples("tts_device_bytes_limit"):
            if limit <= 0:
                continue
            u = use.get(tuple(sorted(lb.items())))
            if u is None:
                continue
            frac = u / limit
            if frac > th.mem_frac and (worst is None
                                       or frac > worst[1]):
                worst = (lb.get("device"), frac, u, limit)
        if worst is None:
            return False, {}
        return True, {"device": worst[0], "frac": round(worst[1], 4),
                      "bytes_in_use": worst[2], "bytes_limit": worst[3],
                      "threshold_frac": th.mem_frac}

    def compile_storm(ctx):
        cache = getattr(ctx.server, "cache", None)
        if cache is None:
            return False, {}
        # count TRUE unplanned fresh compiles (ExecutorCache.
        # storm_signal: disk-AOT-cache replays and operator-requested
        # pre-warm compiles excluded) — a restarted server mass-
        # replaying its executable cache from disk at boot is the
        # cold-start FIX working, not a storm. Duck-typed caches
        # without the signal fall back to the cache's miss delta.
        signal_fn = getattr(cache, "storm_signal", None)
        if signal_fn is not None:
            compiles = int(signal_fn())
            kind = "compiles"
        else:
            compiles = cache.snapshot().get("misses", 0)
            kind = "misses"
        prev, state["misses_prev"] = state["misses_prev"], compiles
        if prev is None:
            return False, {}
        delta = compiles - prev
        detail = {f"{kind}_in_interval": delta,
                  f"{kind}_total": compiles,
                  "threshold": th.compile_storm}
        aot = getattr(ctx.server, "aot", None)
        if aot is not None:
            # the plain counter, NOT snapshot(): snapshot lists the
            # cache directory, which can be slow on fleet storage —
            # too heavy for every health-evaluation interval
            detail["aot_cache_hits"] = aot.hits
        return delta >= th.compile_storm, detail

    def audit_rule(ctx):
        fails = audit.recent_failures(th.audit_window_s)
        if not fails:
            return False, {}
        last = fails[-1]
        return True, {"failures_in_window": len(fails),
                      "invariant": last.invariant,
                      "detail": last.detail,
                      "window_s": th.audit_window_s}

    def peer_down(ctx):
        # fleet failover (service/failover.py): the watcher's last scan
        # rides the status snapshot's `failover` key. Any peer whose
        # lease EXPIRED without being released is a down server whose
        # ledger holds orphaned requests — critical whether or not
        # TTS_FAILOVER is armed (observe-only fleets page an operator
        # instead of self-adopting). Duck-typed: non-fleet servers
        # (no watcher, snapshot key absent/None) never fire.
        watcher = getattr(ctx.server, "watcher", None)
        fo = (watcher.snapshot() if watcher is not None
              else (ctx.snapshot or {}).get("failover") or {})
        peers = fo.get("peers") or []
        down = [p for p in peers
                if p.get("expired") and not p.get("released")]
        if not down:
            return False, {}
        worst = max(down, key=lambda p: p.get("age_s") or 0.0)
        return True, {"peers_down": len(down),
                      "dir": worst.get("dir"),
                      "owner": worst.get("owner"),
                      "epoch": worst.get("epoch"),
                      "age_s": worst.get("age_s"),
                      "ttl_s": worst.get("ttl_s"),
                      "mode": fo.get("mode"),
                      "takeovers": fo.get("takeovers")}

    def _burn_windows(ctx, slo: str, bad_fn, tth=None, tenant=None):
        """Multi-window burn rate over the DURABLE store's terminal
        history (obs/store.py): bad_fraction/budget per window, so a
        budget spent across three restarts and a takeover still burns.
        Publishes tts_slo_burn_rate{slo,window} and fires only when
        BOTH windows exceed the threshold — fast alone is a blip, slow
        alone is stale history. No store attached = never active
        (bit-identical to the pre-store rule family). With `tenant`,
        the window narrows to that tenant's terminals, `tth` supplies
        its overridden budget/threshold, and the burn series carries a
        tenant label."""
        store = getattr(ctx.monitor, "store", None)
        if store is None:
            return False, {}
        tth = tth or th
        budget = (tth.slo_error_budget if slo == "error"
                  else tth.slo_latency_budget)
        if budget <= 0:
            return False, {}
        now = time.time()
        rows = store.terminal_history(now - tth.slo_burn_slow_s)
        if tenant is not None:
            rows = [r for r in rows
                    if (r[3] if len(r) > 3 else "-") == tenant]
        burns = {}
        counts = {}
        for window, span in (("fast", tth.slo_burn_fast_s),
                             ("slow", tth.slo_burn_slow_s)):
            in_w = [r for r in rows if r[0] >= now - span]
            bad = sum(1 for r in in_w if bad_fn(r))
            burns[window] = ((bad / len(in_w)) / budget
                             if in_w else 0.0)
            counts[window] = (bad, len(in_w))
        g = ctx.registry.gauge(
            "tts_slo_burn_rate",
            "SLO burn rate (bad_fraction/budget) per window, computed "
            "over the durable store's terminal history")
        extra = {} if tenant is None else {"tenant": tenant}
        for window, burn in burns.items():
            g.set(round(burn, 4), slo=slo, window=window, **extra)
        active = (burns["fast"] > tth.slo_burn_threshold
                  and burns["slow"] > tth.slo_burn_threshold)
        return active, {
            "slo": slo, "budget": budget,
            **({"tenant": tenant} if tenant is not None else {}),
            "burn_fast": round(burns["fast"], 4),
            "burn_slow": round(burns["slow"], 4),
            "bad_fast": counts["fast"][0],
            "total_fast": counts["fast"][1],
            "bad_slow": counts["slow"][0],
            "total_slow": counts["slow"][1],
            "threshold": tth.slo_burn_threshold}

    def _tenant_burns(ctx, slo: str, bad_for) -> list[dict]:
        """The per-tenant half of a burn rule: every overridden tenant
        judged against ITS thresholds over ITS terminals (its own
        tenant-labeled burn series). Returns the active details."""
        fired = []
        for tenant in sorted(th.tenant_overrides):
            tth = th.for_tenant(tenant)
            bad_fn = bad_for(tth)
            if bad_fn is None:
                continue
            active, detail = _burn_windows(ctx, slo, bad_fn,
                                           tth=tth, tenant=tenant)
            if active:
                fired.append(detail)
        return fired

    def slo_error_burn(ctx):
        bad = lambda r: r[1] == "FAILED"  # noqa: E731
        active, detail = _burn_windows(ctx, "error", bad)
        per_tenant = _tenant_burns(ctx, "error", lambda tth: bad)
        if per_tenant:
            detail = {**detail, "tenants": per_tenant}
        return active or bool(per_tenant), detail

    def slo_latency_burn(ctx):
        def bad_for(tth):
            target = tth.slo_latency_target_s
            if target <= 0:
                return None
            return lambda r: r[2] > target
        active = False
        detail: dict = {}
        flat = bad_for(th)
        if flat is not None:
            active, detail = _burn_windows(ctx, "latency", flat)
        per_tenant = _tenant_burns(ctx, "latency", bad_for)
        if per_tenant:
            detail = {**detail, "tenants": per_tenant}
        return active or bool(per_tenant), detail

    def _predicted(r) -> tuple[float, float] | None:
        """(spent_s, predicted_total_s) for one RUNNING request block,
        None without a published ETA (warmup / estimation off)."""
        if r.get("state") != "RUNNING":
            return None
        est = (r.get("progress") or {}).get("estimate") or {}
        eta = est.get("eta_s")
        if eta is None:
            return None
        spent = float(r.get("spent_s") or 0.0)
        return spent, spent + float(eta)

    def deadline_risk(ctx):
        """Predictive: fires BEFORE the deadline miss — a RUNNING
        request whose estimated remaining time plus spent budget
        exceeds its compute deadline, while there is still time to
        preempt, re-tier or raise the budget (the terminal counter
        only moves after the budget is gone)."""
        reqs = (ctx.snapshot or {}).get("requests") or {}
        worst, at_risk = None, 0
        for rid, r in reqs.items():
            d = r.get("deadline_s")
            pred = _predicted(r)
            if d is None or pred is None:
                continue
            spent, predicted = pred
            over = predicted - float(d)
            if over <= 0:
                continue
            at_risk += 1
            if worst is None or over > worst["over_s"]:
                worst = {"request": rid, "tenant": r.get("tenant"),
                         "deadline_s": d,
                         "spent_s": round(spent, 1),
                         "predicted_total_s": round(predicted, 1),
                         "over_s": round(over, 1)}
        if worst is None:
            return False, {}
        return True, {**worst, "at_risk": at_risk}

    def slo_latency_risk(ctx):
        """The latency SLO's predictive twin: a RUNNING request whose
        predicted total latency (spent + ETA) exceeds its TENANT's
        latency target will land as an SLO violation at its terminal —
        fire while it can still be helped. Overridden tenants are
        judged by their own target (Thresholds.for_tenant)."""
        reqs = (ctx.snapshot or {}).get("requests") or {}
        worst, at_risk = None, 0
        for rid, r in reqs.items():
            tenant = r.get("tenant") or "-"
            target = th.for_tenant(tenant).slo_latency_target_s
            pred = _predicted(r)
            if target <= 0 or pred is None:
                continue
            spent, predicted = pred
            over = predicted - target
            if over <= 0:
                continue
            at_risk += 1
            if worst is None or over > worst["over_s"]:
                worst = {"request": rid, "tenant": tenant,
                         "target_s": target,
                         "spent_s": round(spent, 1),
                         "predicted_total_s": round(predicted, 1),
                         "over_s": round(over, 1)}
        if worst is None:
            return False, {}
        return True, {**worst, "at_risk": at_risk}

    def saturation(ctx):
        """Sustained demand over capacity (obs/capacity's overall ρ) —
        the forecast that fires BEFORE the reactive queue_wait p99 can:
        ρ moves with admissions and measured service rates, while the
        p99 needs a window of already-late dispatches to breach. Reads
        the shared snapshot, so the health cadence also drives the
        tts_capacity_* gauge refresh."""
        cap = (ctx.snapshot or {}).get("capacity")
        if not cap:
            return False, {}
        rho = cap.get("utilization")
        if rho is None:        # no terminal yet: demand unmeasurable
            return False, {}
        if rho <= th.saturation:
            return False, {}
        worst = None
        for row in cap.get("classes") or []:
            u = row.get("utilization")
            if u is not None and (worst is None
                                  or u > worst["utilization"]):
                worst = row
        detail = {"utilization": round(rho, 4),
                  "threshold": th.saturation,
                  "arrival_per_s": round(cap.get("arrival_per_s", 0.0),
                                         4),
                  "healthy_lanes": cap.get("healthy_lanes")}
        if cap.get("predicted_wait_s") is not None:
            detail["predicted_wait_s"] = round(
                cap["predicted_wait_s"], 3)
        if worst is not None:
            detail["worst_class"] = (f"{worst['shape']}/"
                                     f"{worst['tenant']}")
        return True, detail

    def perf(ctx):
        path = th.perf_json
        if not path or not os.path.exists(path):
            return False, {}
        try:
            with open(path) as f:
                verdict = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return True, {"path": path, "error": repr(e)}
        if verdict.get("verdict") != "FAIL":
            return False, {}
        return True, {"path": path, "round": verdict.get("round"),
                      "n_fail": verdict.get("n_fail"),
                      "reasons": verdict.get("reasons", [])[:4]}

    return [
        Rule("queue_wait", queue_wait, severity="warn",
             description="queue-wait p99 over the SLO threshold"),
        Rule("stall", stall, severity="critical",
             description="RUNNING request heartbeat age over the limit "
                         "(wedged submesh / hung dispatch)"),
        Rule("pruning_collapse", pruning_collapse, severity="warn",
             description="search pruning rate collapsed to ~zero"),
        Rule("mem_headroom", mem_headroom, severity="critical",
             description="device memory in-use/limit over the fraction"),
        Rule("compile_storm", compile_storm, severity="warn",
             description="fresh unplanned compiles per interval over "
                         "the limit (executable reuse broken; disk-"
                         "cache replays, pre-warm and ladder-rung "
                         "warms excluded)"),
        Rule("audit", audit_rule, severity="critical",
             description="a node-conservation invariant failed "
                         "(obs/audit.py)"),
        Rule("perf", perf, severity="warn",
             description="perf_sentry --json verdict is FAIL"),
        Rule("peer_down", peer_down, severity="critical",
             description="a fleet peer's ledger lease expired without "
                         "release (host down, requests orphaned; "
                         "observe-only fleets need an operator)"),
        Rule("slo_error_burn", slo_error_burn, severity="critical",
             description="error-budget burn over threshold in BOTH the "
                         "fast and slow window (durable history — "
                         "survives restarts and takeovers)"),
        Rule("slo_latency_burn", slo_latency_burn, severity="warn",
             description="latency-budget burn over threshold in both "
                         "windows (spent_s over the target counts "
                         "against the budget)"),
    ] + ([
        # exists only while the capacity layer is on: with
        # TTS_CAPACITY=0 the rule LIST itself is the pre-capacity one
        # (the /alerts rules block stays bit-identical). Sits BEFORE
        # the progress pair — their end-of-list position is pinned.
        Rule("saturation", saturation, severity="warn",
             for_s=th.saturation_for_s,
             description="sustained shape-class demand over healthy-"
                         "lane capacity (predictive — fires before the "
                         "queue_wait p99 breaches)"),
    ] if cfg.env_flag("TTS_CAPACITY") else []) + ([
        # the predictive pair exists only while progress estimation is
        # on: with TTS_PROGRESS=0 the rule LIST itself is the pre-
        # estimator one (the /alerts rules block stays bit-identical)
        Rule("deadline_risk", deadline_risk, severity="warn",
             description="a RUNNING request's spent + estimated "
                         "remaining time exceeds its compute deadline "
                         "(predictive — fires before the miss)"),
        Rule("slo_latency_risk", slo_latency_risk, severity="warn",
             description="a RUNNING request's predicted total latency "
                         "exceeds its tenant's latency target "
                         "(predictive; per-tenant thresholds)"),
    ] if cfg.env_flag("TTS_PROGRESS") else [])


def _running_ids(ctx) -> set | None:
    snap = ctx.snapshot
    if snap is None:
        return None
    return {rid for rid, r in snap.get("requests", {}).items()
            if r.get("state") == "RUNNING"}


# ----------------------------------------------------------- the monitor


class HealthMonitor:
    """Evaluates rules on an interval and owns the alert lifecycle.

    `server` is duck-typed (anything with ``status_snapshot()``,
    optionally ``heartbeat_ages()``, ``cache``, ``queue``, ``slots``);
    None evaluates the registry-only rules. `registry` is where the
    ``tts_alerts`` gauges land (the server's own registry on a serve
    session, so ``/metrics`` carries them); rules read from `registry`
    AND the process-global default (engine metrics live there).
    `interval_s <= 0` disables the daemon — :meth:`evaluate_now` still
    works on demand (the doctor/test path).
    """

    HISTORY = 360        # evaluations kept per history series

    def __init__(self, server=None, registry=None,
                 rules: list[Rule] | None = None,
                 thresholds: Thresholds | None = None,
                 interval_s: float | None = None,
                 autostart: bool = True, store=None):
        # the durable obs store (obs/store.py) the slo_* burn rules
        # window over; None (default) keeps the rule family exactly
        # process-scoped. The server assigns it post-construction too
        # (store wiring happens after the monitor exists).
        self.store = store
        self.server = server
        self.registry = registry if registry is not None \
            else metrics.default()
        self.thresholds = thresholds or Thresholds.from_env()
        self.rules = (rules if rules is not None
                      else default_rules(self.thresholds))
        if interval_s is None:
            interval_s = cfg.env_float("TTS_HEALTH_INTERVAL_S")
        self.interval_s = float(interval_s)
        self.alerts: dict[str, Alert] = {}    # guarded-by: self._lock
        self.history: dict[str, list] = {}    # guarded-by: self._lock
        # alert-transition subscribers (the remediation controller's
        # trigger feed): fn(rule_name, transition, alert_json) called
        # AFTER the evaluation sweep releases the lock — a listener may
        # take server/controller locks of its own without ordering
        # against this monitor's
        self.listeners: list = []             # guarded-by: self._lock
        self._g_alerts = self.registry.gauge(
            "tts_alerts",
            "alert state by rule (0 inactive, 0.5 pending, 1 firing)")
        self._c_fired = self.registry.counter(
            "tts_alerts_fired_total", "pending->firing transitions")
        self._c_evals = self.registry.counter(
            "tts_health_evaluations_total", "health rule sweeps")
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None  # guarded-by: self._lock
        self.evaluations = 0     # guarded-by: self._lock
        if autostart and self.interval_s > 0:
            self.start()

    @property
    def registries(self) -> list:
        regs = [self.registry]
        dflt = metrics.default()
        if dflt is not self.registry:
            regs.append(dflt)
        return regs

    # --------------------------------------------------------- lifecycle

    def start(self) -> None:
        with self._lock:
            if self._thread is not None or self.interval_s <= 0:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="tts-health")
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_now()
            except Exception:  # noqa: BLE001 — the judge must not die
                pass           # on a snapshot racing server shutdown

    def stop(self) -> None:
        self._stop.set()
        th = self._thread
        if th is not None:
            # join OUTSIDE the lock: the daemon may be mid-evaluate_now
            # (which holds it); taking the lock before the join would
            # deadlock a stop() racing an evaluation sweep
            th.join(timeout=5)
        with self._lock:
            self._thread = None

    def close(self) -> None:
        self.stop()
        # retire the alert gauges: a closed server must not keep
        # publishing rule series (same valve as the resource sampler)
        self.registry.remove_matching("tts_alerts")
        self.registry.remove_matching("tts_slo_burn_rate")

    # --------------------------------------------------------- durability

    def seed_history(self, samples: list[dict]) -> int:
        """Refill the history rings from replayed obs-store ``sample``
        records (boot resume): each record's ``history`` dict maps ring
        name -> value at wall time ``t``. Rows older than what the ring
        would have seen are kept anyway — the rings are bounded at
        HISTORY either way. Returns rows seeded."""
        seeded = 0
        with self._lock:
            for rec in samples:
                hist = rec.get("history")
                t = rec.get("t")
                if not isinstance(hist, dict) or t is None:
                    continue
                for name, value in hist.items():
                    if value is None:
                        continue
                    ring = self.history.setdefault(name, [])
                    ring.append((round(float(t), 3), value))
                    seeded += 1
            for ring in self.history.values():
                ring.sort(key=lambda row: row[0])
                del ring[:-self.HISTORY]
        return seeded

    def history_sample(self) -> dict:
        """The CURRENT history-ring signals as one dict — what the obs
        store persists per sample record (the inverse of
        :meth:`seed_history`)."""
        with self._lock:
            return {name: ring[-1][1]
                    for name, ring in self.history.items() if ring}

    # -------------------------------------------------------- evaluation

    def add_listener(self, fn) -> None:
        """Subscribe to alert transitions: ``fn(rule_name, transition,
        alert_json)`` with transition in {"pending", "firing",
        "resolved"}. Called outside the monitor's lock, after each
        sweep; a raising listener is recorded and dropped from that
        sweep's fan-out, never a monitor crash."""
        with self._lock:
            self.listeners.append(fn)

    def evaluate_now(self) -> dict:
        """One sweep: run every rule, advance lifecycles, publish, and
        append the history sample. Returns `alerts_snapshot()`."""
        now = time.time()
        ctx = _Ctx(self, now)
        transitions: list[tuple[str, str, dict]] = []
        with self._lock:
            self.evaluations += 1
            self._c_evals.inc()
            for rule in self.rules:
                try:
                    active, detail = rule.check(ctx)
                except Exception as e:  # noqa: BLE001 — a broken rule is
                    # a finding about the rule, never a monitor crash
                    tracelog.event("alert.rule_error", rule=rule.name,
                                   error=repr(e))
                    continue
                self._advance(rule, bool(active), detail or {}, now,
                              transitions)
            self._sample_history(ctx, now)
            listeners = list(self.listeners)
        # fan transitions out OUTSIDE the lock: a listener (the
        # remediation controller) takes server locks of its own, and a
        # lock-ordering edge monitor->server would deadlock against the
        # server's own snapshot calls into this monitor
        for rule_name, transition, alert_json in transitions:
            for fn in listeners:
                try:
                    fn(rule_name, transition, alert_json)
                except Exception as e:  # noqa: BLE001 — observer tier
                    tracelog.event("alert.listener_error",
                                   rule=rule_name, error=repr(e))
        return self.alerts_snapshot()

    def _advance(self, rule: Rule, active: bool, detail: dict,
                 now: float, transitions: list | None = None
                 ) -> None:    # holds: self._lock
        def note(state: str, a: Alert) -> None:
            if transitions is not None:
                transitions.append((rule.name, state, a.to_json()))

        a = self.alerts.get(rule.name)
        labels = {"rule": rule.name, "severity": rule.severity}
        if active:
            if a is None or a.state == RESOLVED:
                a = Alert(rule=rule.name, severity=rule.severity,
                          state=PENDING, since_unix=now, detail=detail,
                          fired_count=a.fired_count if a else 0)
                self.alerts[rule.name] = a
                tracelog.event("alert.pending", **labels, **detail)
                self._g_alerts.set(0.5, **labels)
                note(PENDING, a)
            a.detail = detail
            if a.state == PENDING and now - a.since_unix >= rule.for_s:
                a.state = FIRING
                a.firing_since_unix = now
                a.fired_count += 1
                self._c_fired.inc(rule=rule.name)
                tracelog.event("alert.firing", **labels, **detail)
                self._g_alerts.set(1.0, **labels)
                note(FIRING, a)
        elif a is not None and a.state != RESOLVED:
            was_firing = a.state == FIRING
            a.state = RESOLVED
            a.resolved_unix = now
            self._g_alerts.set(0.0, **labels)
            if was_firing:
                tracelog.event("alert.resolved", **labels,
                               firing_s=round(
                                   now - (a.firing_since_unix or now),
                                   3))
                note(RESOLVED, a)
            # an unconfirmed pending that cleared is not an incident:
            # no resolved event, and the record drops so /alerts shows
            # only confirmed history
            elif a.fired_count == 0:
                del self.alerts[rule.name]

    def _sample_history(self, ctx: _Ctx, now: float) -> None:
        # holds: self._lock
        def push(name, value):
            if value is None:
                return
            ring = self.history.setdefault(name, [])
            ring.append((round(now, 3), value))
            del ring[:-self.HISTORY]

        srv = self.server
        if srv is not None:
            if getattr(srv, "queue", None) is not None:
                push("queue_depth", len(srv.queue))
            slots = getattr(srv, "slots", None)
            if slots is not None:
                push("submeshes_busy",
                     sum(1 for s in slots if s.record is not None))
            ages = getattr(srv, "heartbeat_ages", lambda: {})()
            push("heartbeat_age_max_s",
                 round(max(ages.values()), 3) if ages else 0.0)
            # mean published progress over RUNNING requests (the
            # dashboard's progress sparkline). Data-driven: with the
            # estimator off no request ever carries an estimate, so the
            # ring never exists — history output stays bit-identical
            vals = [
                ((r.get("progress") or {}).get("estimate") or {})
                .get("progress_ratio")
                for r in ((ctx.snapshot or {}).get("requests") or {})
                .values() if r.get("state") == "RUNNING"]
            vals = [v for v in vals if v is not None]
            if vals:
                push("progress_mean",
                     round(sum(vals) / len(vals), 4))
            # overall ρ + mean lane-executing fraction (the dashboard's
            # utilization sparklines). Data-driven like progress_mean:
            # with the capacity layer off the snapshot never carries
            # the key, so the rings never exist — bit-identical history
            cap = (ctx.snapshot or {}).get("capacity")
            if cap:
                rho = cap.get("utilization")
                if rho is not None:
                    push("capacity_utilization", round(rho, 4))
                lanes = cap.get("lanes_detail") or []
                if lanes:
                    push("lane_executing_frac", round(
                        sum(r.get("utilization", 0.0) for r in lanes)
                        / len(lanes), 4))
        use = ctx.gauge_samples("tts_device_bytes_in_use")
        if use:
            push("device_bytes_in_use", sum(v for _, v in use))
        rss = ctx.gauge_samples("tts_host_rss_bytes")
        if rss:
            push("host_rss_bytes", rss[0][1])
        push("alerts_firing",
             sum(1 for a in self.alerts.values() if a.state == FIRING))

    # -------------------------------------------------------------- read

    def firing(self) -> list[Alert]:
        with self._lock:
            return sorted(
                (a for a in self.alerts.values() if a.state == FIRING),
                key=lambda a: _SEVERITY_ORDER.get(a.severity, 9))

    def alerts_snapshot(self) -> dict:
        """JSON behind GET /alerts (and the doctor verdict)."""
        with self._lock:
            alerts = sorted(
                self.alerts.values(),
                key=lambda a: (a.state != FIRING,
                               _SEVERITY_ORDER.get(a.severity, 9),
                               a.rule))
            return {
                "t": time.time(),
                "interval_s": self.interval_s,
                "evaluations": self.evaluations,
                "firing": sum(1 for a in alerts if a.state == FIRING),
                "rules": [{"name": r.name, "severity": r.severity,
                           "description": r.description}
                          for r in self.rules],
                "alerts": [a.to_json() for a in alerts],
            }
