"""Checkpoint round-trip and incumbent-exchange audits.

Reproduces `enabled`, `roundtrip_enabled`, `check_checkpoint_roundtrip`
and `check_incumbent_fold` of `tpu_tree_search/obs/audit.py`, with the
pieces they stand on (`record`, `state_sums`, `array_sums`, `AuditError`,
`Finding`): after a save, `run_segmented` (or its checkpoint writer thread)
re-reads the snapshot and requires the counters it was written from
(`TTS_AUDIT=full` or `TTS_AUDIT_CKPT=1`); `engine/incumbent.BoardClient`
requires that a pruning ceiling it hands out never loosens (`TTS_AUDIT`,
on by default). Every check lands in the metrics registry
(`tts_audit_checks_total` / `tts_audit_failures_total` by invariant) and
the flight recorder (`audit.check` / `audit.fail` events);
`TTS_AUDIT_HARD=1` makes a failed one raise. The rest of the JAX module
(the result and reshard checks, the findings ring the health layer reads)
belongs to the observability layer, which is not ported yet.
"""

from __future__ import annotations

import dataclasses
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


def enabled() -> bool:
    """Result and exchange auditing (TTS_AUDIT; default on: the checks are
    host-side comparisons of values already fetched)."""
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
    """Register one check outcome: counters, a trace event, and the
    hard-mode raise."""
    f = Finding(invariant=invariant, ok=bool(ok),
                detail={k: _json_safe(v) for k, v in detail.items()},
                t_unix=time.time())
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


def state_sums(state) -> dict:
    """Summed counters of a SearchState (single-device or stacked, its
    counters read in one transfer): the conserved quantities a checkpoint
    round trip must keep exactly."""
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
