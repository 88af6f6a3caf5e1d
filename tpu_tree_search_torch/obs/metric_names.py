"""The metric-name registry: every ``tts_*`` series the stack emits.

A copy of `tpu_tree_search/obs/metric_names.py` (stdlib only): one table
of every metric name that can appear on ``/metrics``, with its kind,
label keys and one line of documentation. The port emits the JAX
package's series under the same names, so the table is the same; the
durable store's `resume_counters` reads the documentation line from it
when it re-creates a counter.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Metric", "REGISTRY"]


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    kind: str       # "counter" | "gauge" | "histogram"
    labels: str     # comma list of label keys, "" when unlabeled
    doc: str        # one line; lands in the generated README table


def _table(*rows: Metric) -> dict:
    out = {}
    for m in rows:
        if m.name in out:
            raise ValueError(f"duplicate metric {m.name}")
        out[m.name] = m
    return out


REGISTRY: dict[str, Metric] = _table(
    # --- service: requests and queueing
    Metric("tts_requests_submitted_total", "counter", "", "admissions"),
    Metric("tts_requests_total", "counter", "state,tenant",
           "terminal states (done/cancelled/deadline/failed) by "
           "accounting tenant ('-' = unattributed)"),
    Metric("tts_preemptions_total", "counter", "",
           "higher-priority preemptions (checkpoint + requeue)"),
    Metric("tts_redispatches_total", "counter", "",
           "re-dispatches after a submesh failure"),
    Metric("tts_request_spent_seconds", "histogram", "",
           "per-request accumulated execution time"),
    Metric("tts_queue_wait_seconds", "histogram", "tenant",
           "admission-to-dispatch wait by accounting tenant (under "
           "megabatching: observed at batch-close, so held batch "
           "members are counted)"),
    # --- request megabatching (engine/megabatch + the batch-former)
    Metric("tts_batches_formed_total", "counter", "reason",
           "batches closed by the former (reason=size|age)"),
    Metric("tts_batch_size", "histogram", "",
           "requests per closed batch"),
    Metric("tts_batch_requests_total", "counter", "",
           "requests dispatched through a multi-request batch"),
    Metric("tts_batch_drain_idle_seconds", "histogram", "",
           "per closed megabatch: lane-seconds members sat frozen "
           "waiting for batchmates to drain (the continuous-batching "
           "motivation number)"),
    # --- bound-portfolio racing (service/portfolio)
    Metric("tts_portfolio_races_total", "counter", "outcome",
           "portfolio races by outcome (won/deadline/cancelled/"
           "failed)"),
    Metric("tts_portfolio_members_total", "counter", "role",
           "portfolio members by terminal role (winner/lost_*)"),
    Metric("tts_portfolio_active", "gauge", "",
           "portfolio races currently unresolved"),
    Metric("tts_queue_depth", "gauge", "", "live admission-queue depth"),
    Metric("tts_queue_peak_depth", "gauge", "",
           "high-water queue depth since server start"),
    Metric("tts_queue_rejected", "gauge", "",
           "admissions rejected at the depth bound"),
    Metric("tts_submeshes", "gauge", "",
           "submesh slots partitioned at startup"),
    Metric("tts_submeshes_busy", "gauge", "",
           "submeshes currently running a request"),
    Metric("tts_phase_seconds", "gauge", "phase,worker,request,tenant",
           "live kernel/gen_child/balance/idle attribution; series "
           "retire at the request's terminal state"),
    # --- executor + AOT caches
    Metric("tts_executor_cache_hits_total", "counter", "",
           "requests served from an already-compiled loop"),
    Metric("tts_executor_cache_misses_total", "counter", "",
           "compiled-loop builds (traces/compiles paid)"),
    Metric("tts_executor_cache_entries", "gauge", "",
           "distinct compiled loops held"),
    Metric("tts_compile_seconds", "histogram", "",
           "trace+compile wall seconds per new executable (disk "
           "replays excluded)"),
    Metric("tts_aot_cache_hits_total", "counter", "",
           "executables deserialized from the disk AOT cache"),
    Metric("tts_aot_cache_misses_total", "counter", "",
           "disk AOT lookups with no loadable entry"),
    Metric("tts_aot_cache_errors_total", "counter", "",
           "corrupt/unreadable/unserializable AOT entries (corrupt "
           "ones quarantined)"),
    Metric("tts_deserialize_seconds", "histogram", "",
           "disk AOT deserialize+load wall seconds per hit"),
    # --- tuner
    Metric("tts_tuner_cache_hits_total", "counter", "",
           "tuned params replayed from the tuning cache (zero probes)"),
    Metric("tts_tuner_cache_misses_total", "counter", "",
           "tuning-cache lookups with no loadable entry"),
    Metric("tts_tuner_probes_total", "counter", "",
           "warmed probe executions (candidate measurements)"),
    Metric("tts_tuner_probe_seconds", "histogram", "",
           "wall seconds per tuning sweep (all candidates of a shape)"),
    # --- checkpoints / resilience
    Metric("tts_checkpoint_saves_total", "counter", "",
           "checkpoint snapshots written"),
    Metric("tts_checkpoint_save_seconds", "histogram", "",
           "checkpoint save latency (fetch+compress+fsync)"),
    Metric("tts_checkpoint_bytes", "histogram", "",
           "checkpoint file size"),
    Metric("tts_checkpoint_loads_total", "counter", "",
           "checkpoint loads"),
    Metric("tts_checkpoint_corrupt_total", "counter", "",
           "corrupt snapshots detected at load"),
    Metric("tts_checkpoint_quarantines_total", "counter", "",
           "corrupt snapshots renamed *.corrupt"),
    Metric("tts_checkpoint_rollbacks_total", "counter", "",
           "resumes that fell back to the .prev last-good snapshot"),
    Metric("tts_elastic_reshards_total", "counter", "",
           "N->M worker elastic resumes"),
    Metric("tts_pool_grows_total", "counter", "",
           "lossless pool-overflow recoveries (fetch+grow+recommit)"),
    Metric("tts_retries_total", "counter", "what",
           "one increment per retried transient"),
    Metric("tts_faults_injected_total", "counter", "point,fault",
           "deterministic fault injections that fired"),
    # --- segments / engine throughput
    Metric("tts_segment_seconds", "histogram", "", "segment latency"),
    Metric("tts_segment_gap_seconds", "histogram", "",
           "device-idle gap between segments (TTS_OVERLAP drives it "
           "to ~0)"),
    Metric("tts_nodes_explored_total", "counter", "",
           "explored-node throughput (segment deltas)"),
    Metric("tts_incumbent_folds_total", "counter", "direction",
           "cross-request incumbent exchanges (out=published, "
           "in=folded)"),
    Metric("tts_ladder_switches_total", "counter", "direction",
           "chunk-ladder rung switches at segment boundaries"),
    # --- on-device search telemetry (TTS_SEARCH_TELEMETRY=1)
    Metric("tts_search_popped", "gauge", "bucket,request,tag,tenant",
           "nodes popped by relative-depth bucket"),
    Metric("tts_search_branched", "gauge", "bucket,request,tag,tenant",
           "children branched by relative-depth bucket"),
    Metric("tts_search_pruned", "gauge", "bucket,request,tag,tenant",
           "children pruned by relative-depth bucket"),
    Metric("tts_search_bound_gap", "gauge",
           "outcome,bin,request,tag,tenant",
           "child bound-value histogram, pruned vs surviving"),
    Metric("tts_search_pruning_rate", "gauge", "request,tag,tenant",
           "pruned/evaluated ratio"),
    Metric("tts_search_frontier_depth", "gauge", "request,tag,tenant",
           "mean relative frontier depth (0=root, 1=leaves)"),
    Metric("tts_search_pool_highwater", "gauge", "request,tag,tenant",
           "peak pool occupancy"),
    Metric("tts_search_steal_sent", "gauge", "request,tag,tenant",
           "work-stealing rows sent"),
    Metric("tts_search_steal_recv", "gauge", "request,tag,tenant",
           "work-stealing rows received"),
    Metric("tts_search_improvements", "gauge", "request,tag,tenant",
           "incumbent improvements found"),
    # --- resources
    Metric("tts_device_bytes_in_use", "gauge", "device,platform",
           "per-device HBM in use"),
    Metric("tts_device_bytes_peak", "gauge", "device,platform",
           "per-device peak HBM"),
    Metric("tts_device_bytes_limit", "gauge", "device,platform",
           "per-device memory limit"),
    Metric("tts_host_rss_bytes", "gauge", "",
           "host process resident set"),
    # --- crash-safe serving (service/ledger.py)
    Metric("tts_server_restarts_total", "counter", "",
           "server boots that replayed prior request-ledger state "
           "(fed from the ledger's boot count, so it survives the "
           "registry reset a restart is)"),
    Metric("tts_ledger_records_total", "counter", "kind",
           "request-ledger records appended (each fsync'd before the "
           "transition it journals is acknowledged)"),
    Metric("tts_ledger_replayed_total", "counter", "",
           "ledger records replayed at boot"),
    Metric("tts_ledger_truncated_total", "counter", "",
           "corrupt-tail ledger records discarded at replay "
           "(truncate-to-last-good)"),
    Metric("tts_ledger_errors_total", "counter", "",
           "failed ledger appends (ENOSPC/IO): crash-durability "
           "degraded until the disk recovers — alert on it"),
    # --- self-healing (service/remediate.py)
    Metric("tts_remediations_total", "counter", "rule,action,outcome",
           "remediation decisions (outcome: applied/observed/"
           "rate_limited/noop/skipped/failed/error/restored)"),
    Metric("tts_quarantined_submeshes", "gauge", "",
           "submesh slots currently held out of the partition"),
    Metric("tts_admission_paused", "gauge", "",
           "1 while the remediation controller holds admission paused"),
    # --- fleet failover (service/lease.py + service/failover.py)
    Metric("tts_lease_epoch", "gauge", "",
           "fencing epoch of the ledger lease this server holds"),
    Metric("tts_lease_renewals_total", "counter", "",
           "successful ledger-lease renewals"),
    Metric("tts_lease_lost_total", "counter", "",
           "lease losses (epoch bumped by an adopter / owner changed): "
           "the server self-fenced"),
    Metric("tts_takeovers_total", "counter", "outcome",
           "expired peer leases handled by the failover watcher "
           "(outcome: adopted/observed/lost_race/error)"),
    # --- fleet flight recorder (obs/store.py + SLO burn rules)
    Metric("tts_obs_store_records_total", "counter", "",
           "flight-recorder records appended to the durable store"),
    Metric("tts_obs_store_replayed_total", "counter", "",
           "flight-recorder records replayed at boot (all writers)"),
    Metric("tts_obs_store_truncated_total", "counter", "",
           "corrupt-tail flight-recorder records discarded at replay "
           "(own segments truncated to last-good)"),
    Metric("tts_slo_burn_rate", "gauge", "slo,window",
           "SLO error-budget burn rate over the durable terminal "
           "history (slo: error/latency; window: fast/slow; 1.0 = "
           "spending exactly the budget; per-tenant override series "
           "add a tenant label)"),
    # --- progress / ETA estimation (obs/estimate.py; per-request
    #     series retire at the terminal state like every per-request
    #     family)
    Metric("tts_progress_ratio", "gauge", "request,tag,tenant",
           "estimated fraction of the search tree explored (monotone "
           "after warmup; published only past the warmup gate)"),
    Metric("tts_eta_seconds", "gauge", "request,tag,tenant",
           "estimated execution seconds remaining (estimated remaining "
           "nodes over the measured node rate)"),
    Metric("tts_est_tree_size", "gauge", "request,tag,tenant",
           "estimated total search-tree size in nodes (Knuth-family "
           "online estimate from depth-bucket branching/pruning)"),
    # --- fleet capacity & utilization (obs/capacity.py, TTS_CAPACITY)
    Metric("tts_lane_seconds_total", "counter", "lane,state",
           "wall-clock seconds each submesh lane spent per scheduler "
           "state (idle/compiling/executing/draining/quarantined/"
           "batch-frozen; conserved — states sum to lane lifetime)"),
    Metric("tts_capacity_utilization", "gauge", "shape,tenant",
           "per-shape-class ρ = arrival demand over healthy-lane "
           "capacity (1.0 = saturated)"),
    Metric("tts_capacity_headroom", "gauge", "shape,tenant",
           "per-shape-class spare capacity fraction (1 − ρ)"),
    Metric("tts_capacity_predicted_wait_s", "gauge", "shape,tenant",
           "Little's-law predicted queue wait per shape class"),
    # --- health / audit / meta
    Metric("tts_alerts", "gauge", "rule,severity",
           "alert state by rule (0 inactive, 0.5 pending, 1 firing)"),
    Metric("tts_alerts_fired_total", "counter", "rule",
           "pending->firing transitions"),
    Metric("tts_health_evaluations_total", "counter", "",
           "health rule sweeps"),
    Metric("tts_audit_checks_total", "counter", "invariant",
           "audit invariant evaluations"),
    Metric("tts_audit_failures_total", "counter", "invariant",
           "failed audit invariants"),
    Metric("tts_http_requests_total", "counter", "path",
           "observability endpoint hits"),
    Metric("tts_profile_captures_total", "counter", "",
           "completed on-demand profiler captures"),
    Metric("tts_metrics_dropped_total", "counter", "metric",
           "label sets dropped by the per-metric cardinality cap"),
)
