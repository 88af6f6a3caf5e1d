"""Fleet aggregation: scrape N servers' observability into one view.

Reproduces `tpu_tree_search/obs/aggregate.py` (`recovered_live`,
`parse_prometheus`, `scrape_one`, `scrape`, `merge`,
`fleet_to_prometheus`, `fleet_lease_report`, `needs_takeover`,
`verdict`), with the same retries and timeouts: the same merged view,
text and verdict for the same scrapes. One `SearchServer` answers
``/healthz`` ``/metrics`` ``/status`` ``/alerts`` (obs/httpd); a fleet
runs several. This module scrapes every server, labels everything by its
origin and merges it into one fleet snapshot, which the ``doctor`` command
judges and ``obs/dashboard`` renders. Standard library only (``urllib``),
so the aggregator runs wherever a shell does.

The pieces:

- :func:`parse_prometheus`: text exposition to ``(name, labels,
  value)`` samples (the inverse of ``metrics.Registry.to_prometheus``, as
  much of the format as the port writes);
- :func:`scrape_one` / :func:`scrape`: fetch one or many servers'
  endpoints; a down server becomes ``ok: False`` with the error, never an
  exception (a fleet view that dies with one member is useless exactly
  when it is needed);
- :func:`merge`: one fleet dict, with a verdict row per server, every
  request and alert with an ``origin`` field, and every metric sample
  labelled ``{origin="host:port"}``;
- :func:`fleet_to_prometheus`: the merged samples back out as text
  exposition (one aggregated target for a real Prometheus);
- :func:`fleet_lease_report` / :func:`needs_takeover`: every peer's lease
  read off the fleet root through the port's `service/lease.py` (the same
  files as JAX's);
- :func:`verdict`: the doctor's judgment: healthy iff every server was
  scraped, answered healthz 200, has no firing alert and no quarantined
  submesh, and no lease expired unreleased.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

__all__ = ["parse_prometheus", "scrape_one", "scrape", "merge",
           "fleet_to_prometheus", "verdict", "recovered_live",
           "fleet_lease_report", "needs_takeover"]


def recovered_live(ledger: dict | None) -> int:
    """LIVE work brought back by a ledger replay (queued/active/held).
    Replayed terminal snapshots are idempotency bookkeeping, not
    recovered requests — counting them would make a routine restart
    read as thousands recovered. THE definition for the doctor column
    and the dashboard tile (obs/dashboard), so the two cannot drift."""
    return sum(v for k, v in ((ledger or {}).get("recovered")
                              or {}).items() if k != "terminal")


def parse_prometheus(text: str) -> list[tuple[str, dict, float]]:
    """Parse text exposition into (name, labels, value) samples.
    Comment/blank lines skip; unparseable lines skip (a scraper must
    not die on one odd sample)."""
    out = []
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        try:
            body, _, val = ln.rpartition(" ")
            if "{" in body:
                name, _, rest = body.partition("{")
                labels = {}
                for pair in _split_labels(rest.rstrip("}")):
                    k, _, v = pair.partition("=")
                    labels[k.strip()] = v.strip().strip('"')
            else:
                name, labels = body, {}
            out.append((name.strip(), labels,
                        float("inf") if val == "+Inf" else float(val)))
        except ValueError:
            continue
    return out


def _split_labels(s: str) -> list[str]:
    """Split `a="x",b="y,z"` on commas outside quotes."""
    parts, buf, in_q = [], [], False
    for ch in s:
        if ch == '"':
            in_q = not in_q
        if ch == "," and not in_q:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if buf:
        parts.append("".join(buf))
    return [p for p in parts if p.strip()]


# transient-scrape retry budget: a fleet doctor run races server boots
# and GC pauses; one refused connect must not mark a live peer DOWN.
# Bounded backoff 0.1 * 2^k keeps the worst case well under a second.
SCRAPE_RETRIES = 3
SCRAPE_BACKOFF_S = 0.1


def _get(url: str, timeout: float, retries: int = SCRAPE_RETRIES):
    for attempt in range(retries):
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError:
            # the server ANSWERED — a non-2xx is a health fact for the
            # caller to judge, not a flake to retry
            raise
        except OSError:
            if attempt == retries - 1:
                raise
            time.sleep(SCRAPE_BACKOFF_S * (2 ** attempt))
    raise AssertionError("unreachable")  # pragma: no cover


def scrape_one(url: str, timeout: float = 5.0) -> dict:
    """Scrape one server's /healthz /status /metrics /alerts. `url` is
    the base (http://host:port). Never raises: an unreachable server
    returns ``ok: False`` with the error string."""
    url = url.rstrip("/")
    origin = url.split("://", 1)[-1]
    out = {"origin": origin, "url": url, "ok": True, "error": None,
           "healthz": None, "status": None, "alerts": None,
           "metrics": []}
    try:
        code, body = _get(url + "/healthz", timeout)
        out["healthz"] = {"code": code, **json.loads(body)}
    except urllib.error.HTTPError as e:
        # a draining server answers 503 — that is a health FACT, not a
        # scrape failure
        try:
            out["healthz"] = {"code": e.code, **json.loads(e.read())}
        except (ValueError, OSError):
            out["healthz"] = {"code": e.code}
    except (OSError, ValueError) as e:
        out.update(ok=False, error=f"healthz: {e}")
        return out
    for key, path, parse in (("status", "/status", json.loads),
                             ("alerts", "/alerts", json.loads),
                             ("metrics", "/metrics", parse_prometheus)):
        try:
            code, body = _get(url + path, timeout)
            out[key] = parse(body)
        except (OSError, ValueError) as e:
            # /alerts may not exist on an older server; only the core
            # endpoints are load-bearing for the fleet view
            if key == "alerts":
                out[key] = None
            else:
                out.update(ok=False, error=f"{path}: {e}")
                return out
    return out


def scrape(urls: list[str], timeout: float = 5.0) -> dict:
    """Scrape every server; returns {"t", "servers": [scrape_one...]}"""
    return {"t": time.time(),
            "servers": [scrape_one(u, timeout=timeout) for u in urls]}


def merge(fleet: dict) -> dict:
    """Fold a `scrape()` result into one fleet view (see module doc)."""
    servers, requests, alerts, samples = [], [], [], []
    for s in fleet["servers"]:
        origin = s["origin"]
        row = {"origin": origin, "ok": s["ok"], "error": s["error"],
               "healthz": (s["healthz"] or {}).get("status"),
               "firing": None, "queue_depth": None, "submeshes": None,
               "submeshes_busy": None, "requests": 0, "uptime_s": None,
               "aot_cache": None, "quarantined": 0,
               "admission_paused": None,
               # crash-safe serving (service/ledger): None on a server
               # running without a ledger
               "restarts": None, "recovered_requests": None,
               "ledger_lag_s": None,
               # fleet failover (service/failover): None outside fleet
               # mode (snapshot parity with a fleet-less server)
               "fenced": None, "lease_epoch": None,
               "failover_mode": None, "peers_down": None,
               "takeovers": None,
               # bound-portfolio racing (service/portfolio): None on a
               # server that never raced (snapshot parity)
               "portfolio": None,
               # progress/ETA estimation (obs/estimate): None when no
               # request carries a published estimate (warmup or
               # TTS_PROGRESS=0 — snapshot parity)
               "progress_mean": None, "eta_max_s": None,
               # capacity model (obs/capacity): overall ρ and headroom;
               # None with TTS_CAPACITY=0 or before the model has a
               # service-time estimate (snapshot parity)
               "utilization": None, "capacity_headroom": None}
        st = s.get("status")
        if st:
            row["uptime_s"] = st.get("uptime_s")
            row["queue_depth"] = (st.get("queue") or {}).get("depth")
            subs = st.get("submeshes") or []
            row["submeshes"] = len(subs)
            row["submeshes_busy"] = sum(
                1 for m in subs if m.get("running"))
            # the zero-compile cold-start tier's stats (None when the
            # server runs without a disk AOT cache) — the doctor
            # surfaces them per server
            row["aot_cache"] = st.get("aot_cache")
            # the self-healing tier's degraded-configuration facts:
            # active submesh quarantines and a paused admission valve
            # (service/remediate) — the doctor's degraded verdict input
            rem = st.get("remediation") or {}
            row["quarantined"] = len(rem.get("quarantined") or [])
            row["admission_paused"] = rem.get("admission_paused")
            # the durable-ledger facts: restart count, requests this
            # lifetime recovered by replay, and journal staleness —
            # the doctor's crash-recovery columns
            led = st.get("ledger")
            if led:
                row["restarts"] = led.get("restarts")
                row["recovered_requests"] = recovered_live(led)
                row["ledger_lag_s"] = led.get("lag_s")
            # the fleet-failover facts: fencing state, lease epoch,
            # watcher mode and how many peers look down from HERE —
            # the doctor's failover columns
            fo = st.get("failover")
            if fo:
                row["fenced"] = fo.get("fenced")
                row["lease_epoch"] = (fo.get("lease") or {}).get("epoch")
                row["failover_mode"] = fo.get("mode")
                row["takeovers"] = fo.get("takeovers")
                peers = fo.get("peers")
                if peers is not None:
                    row["peers_down"] = sum(
                        1 for p in peers
                        if p.get("expired") and not p.get("released"))
            # the portfolio-racing totals (service/portfolio): active/
            # won races and members cancelled at first proof — the
            # doctor's portfolio column; per-race winner configs ride
            # each parent request snapshot's `portfolio` block below
            row["portfolio"] = st.get("portfolio")
            # the capacity columns: demand over healthy-lane capacity
            # and what is left — the doctor's saturation forecast input
            cap = st.get("capacity")
            if cap:
                row["utilization"] = cap.get("utilization")
                row["capacity_headroom"] = cap.get("headroom")
            reqs = st.get("requests") or {}
            row["requests"] = len(reqs)
            # the predictive columns: mean published progress over the
            # server's RUNNING requests, and the LONGEST ETA (when this
            # server expects to finish its current work)
            progs, etas = [], []
            for rid, snap in reqs.items():
                requests.append({"origin": origin, **snap})
                if snap.get("state") != "RUNNING":
                    continue
                est = ((snap.get("progress") or {})
                       .get("estimate") or {})
                if est.get("progress_ratio") is not None:
                    progs.append(float(est["progress_ratio"]))
                if est.get("eta_s") is not None:
                    etas.append(float(est["eta_s"]))
            if progs:
                row["progress_mean"] = round(sum(progs) / len(progs), 4)
            if etas:
                row["eta_max_s"] = round(max(etas), 1)
        al = s.get("alerts")
        if al is not None:
            row["firing"] = al.get("firing", 0)
            for a in al.get("alerts", []):
                alerts.append({"origin": origin, **a})
        for name, labels, value in s.get("metrics") or []:
            samples.append((name, {**labels, "origin": origin}, value))
        servers.append(row)
    firing = [a for a in alerts if a.get("state") == "firing"]
    return {"t": fleet["t"], "servers": servers, "requests": requests,
            "alerts": alerts, "firing": len(firing),
            "metrics": samples}


def fleet_to_prometheus(merged: dict) -> str:
    """Re-render the merged samples as text exposition (origin-labeled;
    types are lost in the roundtrip, so everything exports untyped)."""
    lines = []
    for name, labels, value in merged["metrics"]:
        inner = ",".join(f'{k}="{v}"'
                         for k, v in sorted(labels.items()))
        v = "+Inf" if value == float("inf") else (
            str(int(value)) if float(value).is_integer() else repr(value))
        lines.append(f"{name}{{{inner}}} {v}")
    return "\n".join(lines) + "\n"


def fleet_lease_report(fleet_dir) -> list[dict]:
    """Every peer's lease read straight off the shared fleet root — no
    HTTP, so it works exactly when scraping does not: a DOWN server
    cannot answer /status, but its lease file says whether it is
    DOWN-with-lease-held (alive-ish or freshly dead: wait out the TTL)
    or DOWN-lease-expired (requests orphaned: takeover needed, doctor
    exit code 2). Lazily imports the service lease module; [] when the
    dir is empty/unreadable."""
    import pathlib

    from ..service import lease as lease_mod
    rows = []
    try:
        subdirs = sorted(p for p in pathlib.Path(fleet_dir).iterdir()
                         if p.is_dir())
    except OSError:
        return rows
    for d in subdirs:
        info = lease_mod.read_lease(d)
        if info is None:
            continue
        rows.append({"dir": str(d), "owner": info.owner,
                     "epoch": info.epoch,
                     "age_s": round(info.age_s(), 3),
                     "ttl_s": info.ttl_s,
                     "released": info.released,
                     "expired": info.expired()})
    return rows


def needs_takeover(lease_report: list[dict]) -> list[dict]:
    """The rows of a :func:`fleet_lease_report` that demand action:
    expired WITHOUT release = a dead owner's orphaned ledger. THE
    definition behind doctor exit code 2, so the CLI and tests cannot
    drift."""
    return [r for r in lease_report
            if r.get("expired") and not r.get("released")]


def verdict(merged: dict,
            lease_report: list[dict] | None = None) -> tuple[bool,
                                                             list[str]]:
    """The doctor's judgment: (healthy, reasons). Healthy iff every
    server scraped, healthz says ok, zero alerts are firing, and no
    server is serving in a degraded (quarantined-submesh)
    configuration — a fleet routing around a held-out submesh works,
    but it is running on reduced capacity and a human should know.

    With a `lease_report` (doctor --fleet-dir), DOWN servers split two
    ways: an expired unreleased lease is DOWN-lease-expired (orphaned
    requests, takeover needed — exit code 2 via
    :func:`needs_takeover`); an unreachable server while every lease
    is still live is DOWN-with-lease-held (restarting or paused: wait
    out the TTL before any takeover)."""
    reasons = []
    if lease_report:
        expired = needs_takeover(lease_report)
        for r in expired:
            reasons.append(
                f"{r['dir']}: DOWN-lease-expired — owner {r['owner']} "
                f"epoch {r['epoch']} silent {r['age_s']}s > ttl "
                f"{r['ttl_s']}s; requests orphaned (takeover needed)")
        held = [r for r in lease_report
                if not r.get("expired") and not r.get("released")]
        if held and not expired \
                and any(not s["ok"] for s in merged["servers"]):
            reasons.append(
                f"fleet: unreachable server(s) but {len(held)} "
                "lease(s) still live — DOWN-with-lease-held: owner may "
                "be restarting; wait out the TTL before takeover")
    for s in merged["servers"]:
        if not s["ok"]:
            reasons.append(f"{s['origin']}: unreachable ({s['error']})")
        elif s["healthz"] not in ("ok",):
            reasons.append(f"{s['origin']}: healthz={s['healthz']!r}")
        if s.get("firing"):
            reasons.append(f"{s['origin']}: {s['firing']} firing "
                           "alert(s)")
        if s.get("quarantined"):
            reasons.append(
                f"{s['origin']}: DEGRADED — {s['quarantined']} "
                f"submesh(es) quarantined of {s.get('submeshes')}")
    for a in merged["alerts"]:
        if a.get("state") == "firing":
            reasons.append(
                f"{a['origin']}: [{a.get('severity')}] {a.get('rule')} "
                f"{json.dumps(a.get('detail', {}), sort_keys=True)}")
    return (not reasons), reasons
