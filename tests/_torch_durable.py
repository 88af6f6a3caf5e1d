"""Helpers the port's durability tests share (ledger, failover, portfolio
and journey against the JAX package): small instances, a hard-death
stand-in for either package's server, waits with their own timeouts, and
the wall-clock keys left out when two packages' records are compared."""

import json
import time

from tpu_tree_search_torch.problems.pfsp import PFSPInstance

KW = dict(chunk=8, capacity=1 << 12, min_seed=4)

# snapshot and record keys holding wall-clock values, process ids or
# values computed from them
WALL = {"t", "uptime_s", "spent_s", "elapsed_s", "heartbeat_age_s",
        "dispatch_wait_s", "created_unix", "since", "eta_s", "lag_s",
        "pid", "age_s", "renewed_unix", "ts", "seq", "thread", "owner",
        "dir", "fleet_dir", "quarantined_since"}

# server constructor knobs that start no daemon thread of their own: the
# tests compare what their own servers recorded, whatever daemons an
# earlier test file left running in the process
QUIET = dict(health_interval_s=0, resource_sample_s=0)


def small(seed, jobs=7):
    return PFSPInstance.synthetic(jobs=jobs, machines=3, seed=seed)


def totals(rec):
    res = rec.result
    return (int(res.explored_tree), int(res.explored_sol), int(res.best))


def strip(x, drop=WALL):
    """`x` without the keys in `drop`, at every depth."""
    if isinstance(x, dict):
        return {k: strip(v, drop) for k, v in x.items() if k not in drop}
    if isinstance(x, list):
        return [strip(v, drop) for v in x]
    return x


def wait_until(cond, timeout=120.0, every=0.02, msg="condition"):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, f"timeout: {msg}"
        time.sleep(every)


def wait_segment(srv, rid, segment=2, timeout=120.0):
    """Until request `rid` has reported `segment` segments (or ended)."""
    def ok():
        st = srv.status(rid)
        return (st["progress"].get("segment", 0) >= segment
                or st["state"] in ("DONE", "CANCELLED", "DEADLINE",
                                   "FAILED"))
    wait_until(ok, timeout=timeout, msg=f"{rid} segment {segment}")


def crash(srv):
    """A hard death of either package's server: its daemons stop without
    close()'s bookkeeping (no cancellation sweep, no drain marker, no
    lease release: a fleet lease ages toward expiry as a dead host's
    would). Running executors stop at their segment boundary, the
    in-process stand-in for dying mid-flight."""
    if getattr(srv, "watcher", None) is not None:
        srv.watcher.close()
    keepers = [srv.lease] if getattr(srv, "lease", None) else []
    for keeper in keepers + list(getattr(srv, "_adopted", [])):
        keeper._stop.set()
        if keeper._thread is not None:
            keeper._thread.join(timeout=5.0)
    srv._closing.set()
    with srv._lock:
        for slot in srv.slots:
            for rec in slot.records:
                if rec.stop_reason is None:
                    rec.stop_reason = "shutdown"
            if slot.stop_event is not None:
                slot.stop_event.set()
    if srv._scheduler is not None:
        srv._scheduler.join(timeout=60)
    for slot in srv.slots:
        if slot.thread is not None:
            slot.thread.join(timeout=60)
    srv.resources.close()
    srv.health.close()
    srv.remediation.close()
    if getattr(srv, "aot", None) is not None:
        srv.aot.close()
    if srv.ledger is not None:
        srv.ledger.close()


def ledger_records(d):
    """Every journaled record under a ledger dir, replay order."""
    out = []
    for seg in sorted(d.glob("seg-*.jsonl")):
        for ln in seg.read_bytes().splitlines():
            if ln.strip():
                out.append(json.loads(ln)["r"])
    return out
