"""Request-journey reconstruction: one causal timeline per LOGICAL
request, across process lifetimes and hosts.

Reproduces `tpu_tree_search/obs/journey.py` (`load_ledger_dir`,
`fleet_ledger_dirs`, `build_journeys`, `find_journeys`, `render_journey`,
`to_json`) over the port's `obs/store` reader: the same journeys, the same
JSON and the same report for the same ledger and fleet directories,
whichever package wrote them.

The serving stack journals what happened to a request in pieces: the
request ledger's admit, dispatch, budget, preempt and terminal records
(per owner, wall-clock stamped), boot records delimiting process
lifetimes, takeover records from the failover watcher, and
``origin_rid``/``origin_owner`` stamps on every takeover re-admission, so
the fresh rid an adopter assigns is linked to the orphan rid it
continues. This module stitches them:

- every ledger record is attributed to an ``(owner, lifetime)``: owner is
  the ledger directory's name, lifetime the count of ``boot`` records
  before it;
- rids chain into one journey through ``origin_rid`` links (takeover
  re-admission) and ``portfolio`` records (parent to member fan-out); a
  replay after a hard kill keeps the SAME rid, so restarts need no link;
- the journey's budget story is the ordered sequence of ``spent_s``
  witnesses (admit carry-over, budget heartbeats, preempt and terminal
  snapshots), monotone when nothing was lost;
- durable-store events (`obs/store.py`) that name the journey's rids or
  tags enrich the timeline when a store is given.

Stdlib only and read-only: importing or running it starts nothing on the
card, and it may be pointed at a dead fleet's directories.
"""

from __future__ import annotations

import json
import os
import pathlib

from .store import _scan_segment, read_store

__all__ = ["load_ledger_dir", "fleet_ledger_dirs", "build_journeys",
           "find_journeys", "render_journey"]

LEDGER_SEGMENT_PREFIX = "seg-"
LEDGER_SEGMENT_SUFFIX = ".jsonl"

# terminal request states (mirrors service/request.TERMINAL_STATES;
# kept local: stdlib-only module)
_TERMINAL = frozenset({"DONE", "CANCELLED", "DEADLINE", "FAILED"})

_EPS = 1e-6      # spent_s witnesses may round; monotone up to this


# ------------------------------------------------------------- loading

def load_ledger_dir(root: str | os.PathLike) -> list[dict]:
    """CRC-verified records of one ledger directory, in append order.
    Damaged lines (and the rest of their segment) are skipped, never
    repaired — this reader may be pointed at a LIVE peer's ledger."""
    root = pathlib.Path(root)
    out: list[dict] = []
    if not root.is_dir():
        return out
    for seg in sorted(root.iterdir()):
        if not (seg.name.startswith(LEDGER_SEGMENT_PREFIX)
                and seg.name.endswith(LEDGER_SEGMENT_SUFFIX)):
            continue
        try:
            data = seg.read_bytes()
        except OSError:
            continue
        for rec, _end in _scan_segment(data):
            if rec is None:
                break
            out.append(rec)
    return out


def fleet_ledger_dirs(fleet_root: str | os.PathLike) -> list[str]:
    """Every subdirectory of `fleet_root` that holds ledger segments —
    the failover watcher's peer-scan rule."""
    root = pathlib.Path(fleet_root)
    if not root.is_dir():
        return []
    out = []
    for child in sorted(root.iterdir()):
        if not child.is_dir():
            continue
        if any(p.name.startswith(LEDGER_SEGMENT_PREFIX)
               and p.name.endswith(LEDGER_SEGMENT_SUFFIX)
               for p in child.iterdir()):
            out.append(str(child))
    return out


# ------------------------------------------------------------ stitching

class _Node:
    """Per-(owner, rid) event accumulator before chaining."""

    __slots__ = ("owner", "rid", "tag", "tenant", "events", "admit_t",
                 "origin", "carried_s", "terminal", "members",
                 "parent")

    def __init__(self, owner: str, rid: str):
        self.owner = owner
        self.rid = rid
        self.tag = None
        self.tenant = None
        self.events: list[dict] = []
        self.admit_t = None
        self.origin = None          # (owner, rid) this one continues
        self.carried_s = 0.0
        self.terminal = None        # terminal state string
        self.members: list[str] = []   # portfolio member rids (parent)
        self.parent = None          # portfolio parent rid (member)


def _owner_name(path: str) -> str:
    return pathlib.Path(path).name or str(path)


def build_journeys(records_by_owner: dict[str, list[dict]],
                   store_records: list[dict] | None = None
                   ) -> list[dict]:
    """Stitch journeys from per-owner ledger records (see module
    docstring). Returns one JSON-safe dict per logical request, newest
    root admit first."""
    nodes: dict[tuple, _Node] = {}
    lifetimes: dict[tuple, dict] = {}   # (owner, lifetime) -> meta

    def node(owner: str, rid) -> _Node | None:
        if rid is None:
            return None
        key = (owner, str(rid))
        n = nodes.get(key)
        if n is None:
            n = nodes[key] = _Node(owner, str(rid))
        return n

    for owner, records in records_by_owner.items():
        life = 0
        for rec in records:
            kind = rec.get("k")
            t = rec.get("t")
            if kind == "boot":
                life += 1
                lt = lifetimes.setdefault((owner, life), {
                    "owner": owner, "lifetime": life,
                    "boot_t": t, "pid": rec.get("pid"),
                    "records": 0, "takeover": False})
                continue
            lt = lifetimes.setdefault((owner, life), {
                "owner": owner, "lifetime": life, "boot_t": t,
                "pid": rec.get("pid"), "records": 0,
                "takeover": False})
            lt["records"] += 1
            lt["last_t"] = t
            if kind == "takeover":
                lt["takeover"] = True
                continue
            n = node(owner, rec.get("rid"))
            if n is None:
                continue
            ev = {"t": t, "owner": owner, "lifetime": life,
                  "kind": kind}
            if kind == "admit":
                n.tag = rec.get("tag") or n.tag
                n.tenant = rec.get("tenant") or n.tenant
                n.admit_t = t
                n.carried_s = float(rec.get("spent_s") or 0.0)
                if rec.get("origin_rid"):
                    n.origin = (str(rec.get("origin_owner") or owner),
                                str(rec["origin_rid"]))
                    ev["origin_rid"] = rec["origin_rid"]
                    ev["origin_owner"] = rec.get("origin_owner")
                ev["spent_s"] = n.carried_s
            elif kind == "restore":
                # compaction's absolute entry: synthesize the admit
                # story the dropped incremental records told
                entry = rec.get("entry") or {}
                n.tag = entry.get("tag") or n.tag
                n.tenant = entry.get("tenant") or n.tenant
                if n.admit_t is None:
                    n.admit_t = t
                n.carried_s = float(entry.get("spent_s") or 0.0)
                if entry.get("origin_rid"):
                    n.origin = (
                        str(entry.get("origin_owner") or owner),
                        str(entry["origin_rid"]))
                term = entry.get("terminal")
                if term is not None:
                    n.terminal = entry.get("state")
                ev["spent_s"] = n.carried_s
            elif kind == "budget":
                ev["spent_s"] = float(rec.get("spent_s") or 0.0)
                if rec.get("progress") is not None:
                    # the estimator's published ratio rides the same
                    # throttled budget record (service/server
                    # _ledger_budget) — per-lifetime progress marks on
                    # the timeline; absent when TTS_PROGRESS=0
                    ev["progress"] = float(rec["progress"])
            elif kind == "preempt":
                ev["spent_s"] = float(rec.get("spent_s") or 0.0)
                ev["hold"] = bool(rec.get("hold"))
            elif kind == "failure":
                ev["error"] = rec.get("error")
                ev["submesh"] = rec.get("submesh")
                ev["spent_s"] = float(rec.get("spent_s") or 0.0)
            elif kind == "dispatch":
                ev["submesh"] = rec.get("submesh")
            elif kind == "terminal":
                snap = rec.get("snapshot") or {}
                n.terminal = rec.get("state")
                ev["state"] = n.terminal
                if snap.get("spent_s") is not None:
                    ev["spent_s"] = float(snap["spent_s"])
                if snap.get("batch"):
                    ev["batch"] = snap["batch"]
                if snap.get("tenant"):
                    n.tenant = snap["tenant"]
            elif kind == "portfolio":
                n.members = [str(m) for m in rec.get("members") or ()]
                for m in n.members:
                    mn = node(owner, m)
                    mn.parent = n.rid
                ev["members"] = n.members
            n.events.append(ev)

    # ---- chain rids into logical journeys (origin + portfolio links)
    root_of: dict[tuple, tuple] = {}

    def find_root(key: tuple) -> tuple:
        seen = set()
        while key not in seen:
            seen.add(key)
            n = nodes.get(key)
            if n is None:
                return key
            if n.origin is not None and n.origin in nodes:
                key = n.origin
                continue
            if n.parent is not None:
                pkey = (n.owner, n.parent)
                if pkey in nodes:
                    key = pkey
                    continue
            return key
        return key

    groups: dict[tuple, list[_Node]] = {}
    for key, n in nodes.items():
        root = root_of.setdefault(key, find_root(key))
        groups.setdefault(root, []).append(n)

    journeys = []
    for root_key, members in groups.items():
        journeys.append(_assemble(root_key, nodes, members, lifetimes,
                                  store_records))
    journeys.sort(key=lambda j: j.get("admit_t") or 0.0, reverse=True)
    return journeys


def _assemble(root_key: tuple, nodes: dict, members: list,
              lifetimes: dict, store_records) -> dict:
    root = nodes.get(root_key)
    chain = sorted(members, key=lambda n: (n.admit_t or 0.0))
    events: list[dict] = []
    for n in chain:
        for ev in n.events:
            ev = dict(ev)
            ev["rid"] = n.rid
            events.append(ev)
    events.sort(key=lambda e: (e.get("t") or 0.0))

    # budget story: ordered spent_s witnesses across the whole chain.
    # Portfolio members each run their own clock, so monotonicity is
    # judged per rid and the journey total is the root/winner lane's.
    witnesses: dict[str, list] = {}
    for ev in events:
        if "spent_s" in ev:
            witnesses.setdefault(ev["rid"], []).append(ev["spent_s"])
    monotone = all(
        all(b >= a - _EPS for a, b in zip(ws, ws[1:]))
        for ws in witnesses.values())
    spent = max((ws[-1] for ws in witnesses.values()), default=0.0)

    lanes = sorted({(e["owner"], e["lifetime"]) for e in events})
    lifes = []
    for key in lanes:
        meta = dict(lifetimes.get(key) or
                    {"owner": key[0], "lifetime": key[1]})
        mine = [e for e in events
                if (e["owner"], e["lifetime"]) == key]
        meta["events"] = len(mine)
        meta["first_t"] = mine[0].get("t")
        meta["last_t"] = mine[-1].get("t")
        sp = [e["spent_s"] for e in mine if "spent_s" in e]
        if sp:
            meta["spent_end_s"] = sp[-1]
        # per-lifetime progress marks (estimator ratios riding the
        # budget records): where the estimate stood when this lifetime
        # ended — a resumed lifetime starting near its predecessor's
        # progress_end is the warm-continuation witness
        pr = [e["progress"] for e in mine if "progress" in e]
        if pr:
            meta["progress_end"] = pr[-1]
        lifes.append(meta)

    admits = sum(1 for e in events
                 if e["kind"] == "admit" and "origin_rid" not in e
                 and nodes.get((e["owner"], e["rid"])) is not None
                 and nodes[(e["owner"], e["rid"])].parent is None)
    # terminal of the LOGICAL request: the last rid in the chain that
    # is not a portfolio member lane (members cancel when a sibling
    # wins — those terminals are lane detail, not the journey's)
    top = [n for n in chain if n.parent is None]
    terminals = sum(1 for n in top if n.terminal is not None)
    state = None
    for n in top:
        if n.terminal is not None:
            state = n.terminal
    if state is None:
        state = "LIVE"

    tags = [n.tag for n in chain if n.tag]
    tenant = next((n.tenant for n in chain if n.tenant), "-")
    batches = sorted({e["batch"] for e in events if e.get("batch")})
    out = {
        "tag": tags[0] if tags else (root.tag if root else None),
        "tenant": tenant,
        "root": {"owner": root_key[0], "rid": root_key[1]},
        "rids": [{"owner": n.owner, "rid": n.rid,
                  "origin": (list(n.origin) if n.origin else None),
                  "portfolio_parent": n.parent,
                  "terminal": n.terminal}
                 for n in chain],
        "admit_t": chain[0].admit_t if chain else None,
        "admits": admits,
        "terminals": terminals,
        "state": state,
        "spent_s": round(spent, 3),
        "budget_monotone": monotone,
        "preemptions": sum(1 for e in events if e["kind"] == "preempt"),
        "failures": sum(1 for e in events if e["kind"] == "failure"),
        "dispatches": sum(1 for e in events if e["kind"] == "dispatch"),
        "takeovers": sum(1 for e in events
                         if e["kind"] == "admit"
                         and "origin_rid" in e),
        "batches": batches,
        "lifetimes": lifes,
        "events": events,
    }
    if any(n.members for n in chain):
        parent = next(n for n in chain if n.members)
        out["portfolio"] = {"k": len(parent.members),
                            "members": parent.members}
    if store_records:
        out["store_events"] = _store_events_for(out, store_records)
    return out


def _store_events_for(journey: dict, store_records: list[dict]
                      ) -> list[dict]:
    """Durable-store events matching the journey's rids or tags —
    alert/remediation/failover context around the request's own
    records."""
    rids = {r["rid"] for r in journey["rids"]}
    tags = {journey.get("tag")} - {None}
    out = []
    for rec in store_records:
        if rec.get("k") != "event":
            continue
        if (rec.get("request_id") in rids or rec.get("rid") in rids
                or rec.get("orphan_id") in rids
                or (rec.get("tag") and rec.get("tag") in tags)):
            out.append(rec)
    return out


# ------------------------------------------------------------- querying

def find_journeys(ledger_dirs=None, fleet_dir=None, store=None,
                  tag: str | None = None) -> list[dict]:
    """Load + stitch + filter in one call (the CLI's entry).
    `ledger_dirs` is an iterable of ledger directories; `fleet_dir`
    adds every peer ledger under it; `store` is the obs-store
    directory (optional enrichment). `tag` filters to journeys whose
    tag or any rid matches."""
    dirs = [str(d) for d in (ledger_dirs or [])]
    if fleet_dir:
        for d in fleet_ledger_dirs(fleet_dir):
            if d not in dirs:
                dirs.append(d)
    by_owner: dict[str, list] = {}
    for d in dirs:
        recs = load_ledger_dir(d)
        if recs:
            by_owner.setdefault(_owner_name(d), []).extend(recs)
    store_records = read_store(store) if store else None
    journeys = build_journeys(by_owner, store_records)
    if tag:
        journeys = [j for j in journeys
                    if j.get("tag") == tag
                    or any(r["rid"] == tag for r in j["rids"])]
    return journeys


# ------------------------------------------------------------ rendering

def render_journey(j: dict) -> str:
    """Human-readable single-journey report (the CLI's default view)."""
    lines = [
        f"journey  tag={j.get('tag')}  tenant={j.get('tenant')}  "
        f"state={j.get('state')}",
        f"  rids: " + " -> ".join(
            f"{r['owner']}/{r['rid']}"
            + (f" (origin {r['origin'][0]}/{r['origin'][1]})"
               if r.get("origin") else "")
            for r in j["rids"] if not r.get("portfolio_parent")),
        f"  admits={j['admits']} terminals={j['terminals']} "
        f"dispatches={j['dispatches']} preemptions={j['preemptions']} "
        f"failures={j['failures']} takeovers={j['takeovers']}",
        f"  spent_s={j['spent_s']} "
        f"budget_monotone={j['budget_monotone']}",
    ]
    if j.get("portfolio"):
        lines.append(f"  portfolio: k={j['portfolio']['k']} "
                     f"members={','.join(j['portfolio']['members'])}")
    if j.get("batches"):
        lines.append(f"  batches: {','.join(map(str, j['batches']))}")
    lines.append("  lifetimes:")
    for lt in j["lifetimes"]:
        span = ""
        if lt.get("first_t") is not None and lt.get("last_t") is not None:
            span = f" span={lt['last_t'] - lt['first_t']:.1f}s"
        prog = (f" progress_end={lt['progress_end'] * 100:.1f}%"
                if lt.get("progress_end") is not None else "")
        lines.append(
            f"    {lt['owner']} #{lt['lifetime']} pid={lt.get('pid')} "
            f"events={lt.get('events', 0)}"
            f" spent_end_s={lt.get('spent_end_s', '-')}{prog}"
            f"{' TAKEOVER' if lt.get('takeover') else ''}{span}")
    return "\n".join(lines)


def to_json(journeys: list[dict]) -> str:
    return json.dumps({"journeys": journeys}, indent=2, sort_keys=True)
