"""Node-conservation auditor: machine-checked engine invariants.

Reproduces `tpu_tree_search/obs/audit.py` but for `check_state` (the
per-segment check the health layer reads): every check lands as a
`Finding` in a bounded process-wide ring (`findings`, `recent_failures`,
`clear_findings`), in the metrics registry (`tts_audit_checks_total` /
`tts_audit_failures_total` by invariant) and in the flight recorder
(`audit.check` / `audit.fail` events); `TTS_AUDIT_HARD=1` makes a failed
one raise `AuditError`.

Invariants (exact equalities, JAX's names):

- `node_conservation`: a result's totals are warm-up + device + host-tier
  counts; `complete_means_drained`: `complete` iff every pool drained
  (`check_result`);
- `branched_is_tree`, `children_conservation` (branched + pruned + sol
  == evals, or without sol where a problem counts leaves among popped
  nodes: `Problem.leaf_in_evals`), `bound_hist_exact` and `steal_flow`:
  the telemetry summary against the engine's counters (`check_result`,
  with telemetry on);
- `<edge>_conservation`: a reshard keeps every summed counter, the pooled
  node count and the incumbent (`check_reshard`);
- `checkpoint_roundtrip`: a just-written snapshot loads back with the
  same counters; `incumbent_monotone`: a pruning ceiling never loosens.

Wiring: `engine/distributed.search` and `engine/megabatch.serve_batch`
audit every result and every elastic-reshard resume when `enabled()`
(`TTS_AUDIT`, on by default: host-side sums of values already fetched);
`run_segmented` (or its checkpoint writer thread) re-reads each snapshot
when `roundtrip_enabled()` (`TTS_AUDIT=full` or `TTS_AUDIT_CKPT=1`);
`engine/incumbent.BoardClient` checks every fold it hands a search.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np

from ..utils import config as _cfg
from . import metrics, tracelog


class AuditError(RuntimeError):
    """An engine invariant failed under TTS_AUDIT_HARD=1."""


@dataclasses.dataclass
class Finding:
    invariant: str
    ok: bool
    detail: dict
    t_unix: float


# recent findings, process-wide (the health layer's `audit` rule, A10,
# reads them); bounded, so a flapping invariant cannot leak
_FINDINGS: collections.deque[Finding] = collections.deque(
    maxlen=256)   # guarded-by: _LOCK
_LOCK = threading.Lock()


def enabled() -> bool:
    """Result, reshard and exchange auditing (TTS_AUDIT; default on: the
    checks are host-side comparisons of values already fetched)."""
    return (_cfg.env_str("TTS_AUDIT") or "1").strip().lower() not in (
        "0", "off", "false", "no")


def hard() -> bool:
    """CI mode: any failed invariant raises AuditError."""
    return _cfg.env_flag("TTS_AUDIT_HARD")


def roundtrip_enabled() -> bool:
    """Checkpoint re-read verification (TTS_AUDIT=full or
    TTS_AUDIT_CKPT=1); off by default: it re-reads every snapshot."""
    if (_cfg.env_str("TTS_AUDIT") or "").strip().lower() == "full":
        return True
    return _cfg.env_flag("TTS_AUDIT_CKPT")


def _json_safe(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return repr(v)


def record(invariant: str, ok: bool, **detail) -> Finding:
    """Register one check outcome: the ring, counters, a trace event, and
    the hard-mode raise."""
    f = Finding(invariant=invariant, ok=bool(ok),
                detail={k: _json_safe(v) for k, v in detail.items()},
                t_unix=time.time())
    with _LOCK:
        _FINDINGS.append(f)
    reg = metrics.default()
    reg.counter("tts_audit_checks_total",
                "audit invariant evaluations").inc(invariant=invariant)
    if not f.ok:
        reg.counter("tts_audit_failures_total",
                    "failed audit invariants").inc(invariant=invariant)
        tracelog.event("audit.fail", invariant=invariant, **f.detail)
        if hard():
            raise AuditError(
                f"audit invariant {invariant!r} failed: {f.detail}")
    else:
        tracelog.event("audit.check", invariant=invariant, ok=True)
    return f


def findings(n: int | None = None) -> list[Finding]:
    """The most recent findings, oldest first (all when `n` is None)."""
    with _LOCK:
        out = list(_FINDINGS)
    return out if n is None else out[-n:]


def recent_failures(window_s: float | None = None) -> list[Finding]:
    """Failed findings, only those younger than `window_s` if given."""
    cutoff = time.time() - window_s if window_s else None
    return [f for f in findings() if not f.ok
            and (cutoff is None or f.t_unix >= cutoff)]


def clear_findings() -> None:
    """Drop the ring."""
    with _LOCK:
        _FINDINGS.clear()


# ------------------------------------------------------------- the checks


def _sol_in_evals(problem: str) -> bool:
    """Whether the problem counts solutions among the evaluated children
    (PFSP: branched + pruned + sol == evals) or among popped nodes
    (N-Queens: branched + pruned == evals): the plugin's `leaf_in_evals`,
    by registry name. An unknown name takes the PFSP rule."""
    try:
        from ..problems import get
        return bool(get(problem).leaf_in_evals)
    except Exception:  # noqa: BLE001 — unknown or legacy name
        return True


def check_result(res) -> list[Finding]:
    """Audit a DistResult: node conservation, `complete` against the
    final pools and, with telemetry, the summary against the counters.
    The conservation identity follows the result's `problem`."""
    out = []
    pd = res.per_device
    dev_tree = int(np.asarray(pd.get("tree", [0])).sum())
    dev_sol = int(np.asarray(pd.get("sol", [0])).sum())
    dev_evals = int(np.asarray(pd.get("evals", [0])).sum())
    host_tree = int(np.asarray(pd.get("host_tree", [0])).sum())
    host_sol = int(np.asarray(pd.get("host_sol", [0])).sum())
    out.append(record(
        "node_conservation",
        res.explored_tree == res.warmup_tree + dev_tree + host_tree
        and res.explored_sol == res.warmup_sol + dev_sol + host_sol,
        explored_tree=res.explored_tree, warmup_tree=res.warmup_tree,
        device_tree=dev_tree, host_tree=host_tree,
        explored_sol=res.explored_sol, warmup_sol=res.warmup_sol,
        device_sol=dev_sol, host_sol=host_sol))
    final = pd.get("final_size")
    if final is not None:
        out.append(record(
            "complete_means_drained",
            bool(res.complete) == (int(np.asarray(final).sum()) == 0),
            complete=bool(res.complete),
            pool=int(np.asarray(final).sum())))
    if res.telemetry is not None:
        out.extend(_check_telemetry(
            res.telemetry, tree=dev_tree, sol=dev_sol, evals=dev_evals,
            sent=int(np.asarray(pd.get("sent", [0])).sum()),
            recv=int(np.asarray(pd.get("recv", [0])).sum()),
            sol_in_evals=_sol_in_evals(getattr(res, "problem", "pfsp"))))
    return out


def _check_telemetry(summary: dict, tree: int, sol: int, evals: int,
                     sent: int | None = None, recv: int | None = None,
                     sol_in_evals: bool = True) -> list[Finding]:
    """The telemetry summary's buckets against the engine's counters:
    every evaluated child is branched, pruned or (under `sol_in_evals`) a
    leaf, the bound histograms bin exactly the pruned and the surviving
    children, and the steal slots mirror sent/recv."""
    out = []
    branched = int(sum(summary["branched"]))
    pruned = int(sum(summary["pruned"]))
    out.append(record("branched_is_tree", branched == tree,
                      branched=branched, tree=tree))
    want_evals = branched + pruned + (sol if sol_in_evals else 0)
    out.append(record("children_conservation", want_evals == evals,
                      branched=branched, pruned=pruned, sol=sol,
                      sol_in_evals=sol_in_evals, evals=evals))
    out.append(record(
        "bound_hist_exact",
        sum(summary["bound_hist_pruned"]) == pruned
        and sum(summary["bound_hist_surviving"]) == branched,
        hist_pruned=sum(summary["bound_hist_pruned"]), pruned=pruned,
        hist_surviving=sum(summary["bound_hist_surviving"]),
        branched=branched))
    if sent is not None and recv is not None:
        out.append(record("steal_flow",
                          summary["steal_sent"] == sent
                          and summary["steal_recv"] == recv,
                          tele_sent=summary["steal_sent"], sent=sent,
                          tele_recv=summary["steal_recv"], recv=recv))
    return out


def state_sums(state) -> dict:
    """Summed counters of a SearchState (single-device or stacked, its
    counters read in one transfer): the conserved quantities a reshard or
    a checkpoint round trip must keep exactly."""
    from .. import convert

    return array_sums(convert.state_to_numpy(state, rows=0))


def array_sums(a: dict) -> dict:
    """`state_sums` of a state already on the host, as a dict of numpy
    arrays keyed by field (a checkpoint payload): the async checkpoint
    writer takes them where the arrays were fetched, so the round trip
    it audits on its own thread spans the async edge."""
    from ..engine import telemetry as tele

    def s(x):
        return int(np.asarray(x, np.int64).sum())

    out = {"size": s(a["size"]), "tree": s(a["tree"]), "sol": s(a["sol"]),
           "evals": s(a["evals"]),
           "iters_max": int(np.atleast_1d(a["iters"]).max()),
           "sent": s(a["sent"]), "recv": s(a["recv"]),
           "best": int(np.atleast_1d(a["best"]).min())}
    if np.asarray(a["telemetry"]).shape[-1]:
        block = np.atleast_2d(np.asarray(a["telemetry"], np.int64))
        # only the additive slots: the high-water mark and the ring merge
        out["telemetry_counts"] = int(block[:, :tele.O_POOL_HW].sum())
    return out


def check_reshard(before: dict, after_state, edge: str = "reshard"
                  ) -> list[Finding]:
    """Conservation across an elastic reshard (or any re-homing of a
    state): `before` is `state_sums()` of the state before the edge; one
    finding `<edge>_conservation` per summed quantity."""
    after = state_sums(after_state)
    return [record(f"{edge}_conservation", after.get(key) == pre,
                   quantity=key, before=pre, after=after.get(key))
            for key, pre in before.items()]


def check_checkpoint_roundtrip(path, state) -> list[Finding]:
    """Re-read a just-written checkpoint (onto the CPU) and require the
    same counter sums as `state` (a SearchState, or its `state_sums()`).
    A load failure is itself a failed finding: the write was supposed to
    be durable."""
    from ..engine import checkpoint

    expect = state if isinstance(state, dict) else state_sums(state)
    try:
        loaded, _ = checkpoint.load(path, device="cpu")
    except Exception as e:  # noqa: BLE001 — the finding carries it
        return [record("checkpoint_roundtrip", False,
                       path=str(path), error=repr(e))]
    got = state_sums(loaded)
    return [record("checkpoint_roundtrip", got == expect,
                   path=str(path), expect=expect, got=got)]


def check_incumbent_fold(key: str, prev_cap, new_cap) -> Finding:
    """Monotonicity of the cross-request incumbent exchange
    (`engine/incumbent.BoardClient` calls this on every fold the board
    hands a search): a pruning ceiling must never loosen. The board is a
    min-fold by construction, so `new_cap > prev_cap` means the exchange
    itself is broken and a search could prune less than it already
    safely did."""
    ok = prev_cap is None or int(new_cap) <= int(prev_cap)
    return record("incumbent_monotone", ok, key=str(key),
                  prev_cap=(None if prev_cap is None else int(prev_cap)),
                  new_cap=int(new_cap))
