"""Self-contained HTML dashboard for one server or a whole fleet.

Reproduces `tpu_tree_search/obs/dashboard.py` (`sparkline_svg`,
`render_server`, `render_fleet`): the same page for the same snapshot,
but for the package it names (``PACKAGE``). ``GET /dashboard``
(obs/httpd) renders a serve session; the ``doctor`` command renders a
fleet scrape (obs/aggregate) to a file. Standard library string building
only: no script tag and no external font, style sheet or script, so the
page opens from an offline artifact store as it opened live.

Layout: a row of stat tiles for the headline numbers, single-series
sparklines (2px line, direct label, no legend) fed by the health
monitor's history rings, an alert panel in the status palette (icon and
label, never colour alone), per-lane utilization stripes, and plain
tables for requests. Light and dark themes both come from CSS custom
properties.
"""

from __future__ import annotations

import html
import time

__all__ = ["render_server", "render_fleet", "sparkline_svg"]

# the package a page names in its title and footer
PACKAGE = "tpu_tree_search_torch"

_CSS = """
:root { color-scheme: light dark; }
body { margin: 0; padding: 24px; background: var(--surface-1);
  color: var(--text-primary);
  font: 14px/1.45 system-ui, -apple-system, sans-serif; }
body {
  --surface-1: #fcfcfb; --surface-2: #f1f0ee;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --grid: #e3e2de; --series-1: #2a78d6;
  --good: #0ca30c; --warning: #fab219; --serious: #ec835a;
  --critical: #d03b3b; }
@media (prefers-color-scheme: dark) {
  body { --surface-1: #1a1a19; --surface-2: #262624;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --grid: #3a3935; --series-1: #3987e5; } }
h1 { font-size: 18px; margin: 0 0 4px; }
h2 { font-size: 13px; margin: 28px 0 8px; color: var(--text-secondary);
  text-transform: uppercase; letter-spacing: .06em; }
.sub { color: var(--text-secondary); margin: 0 0 20px; }
.tiles { display: flex; flex-wrap: wrap; gap: 12px; }
.tile { background: var(--surface-2); border-radius: 8px;
  padding: 12px 16px; min-width: 120px; }
.tile .v { font-size: 24px; font-weight: 600; }
.tile .k { color: var(--text-secondary); font-size: 12px; }
.tile.bad .v { color: var(--critical); }
table { border-collapse: collapse; width: 100%; }
th { text-align: left; color: var(--text-secondary); font-weight: 500;
  font-size: 12px; }
th, td { padding: 6px 10px 6px 0;
  border-bottom: 1px solid var(--grid); }
td.num { font-variant-numeric: tabular-nums; }
.sev { font-weight: 600; }
.sev.critical { color: var(--critical); }
.sev.warn { color: var(--warning); }
.sev.info { color: var(--text-secondary); }
.state-firing { color: var(--critical); font-weight: 600; }
.state-pending { color: var(--serious); }
.state-resolved { color: var(--good); }
.sparks { display: flex; flex-wrap: wrap; gap: 16px; }
.spark { background: var(--surface-2); border-radius: 8px;
  padding: 10px 14px; }
.spark .k { color: var(--text-secondary); font-size: 12px; }
.spark .v { font-weight: 600; margin-left: 8px; }
.ok { color: var(--good); } .err { color: var(--critical); }
.mono { font-family: ui-monospace, monospace; font-size: 12px; }
.stripe { display: flex; height: 14px; width: 320px;
  border-radius: 3px; overflow: hidden; background: var(--surface-2); }
.stripe span { display: block; height: 100%; }
.st-idle { background: var(--grid); }
.st-compiling { background: var(--warning); }
.st-executing { background: var(--good); }
.st-draining { background: var(--serious); }
.st-quarantined { background: var(--critical); }
.st-batch-frozen { background: var(--series-1); }
footer { margin-top: 32px; color: var(--text-secondary);
  font-size: 12px; }
"""

_SEV_ICON = {"critical": "▲", "warn": "●", "info": "○"}
_STATE_ICON = {"firing": "▲", "pending": "●",
               "resolved": "✓"}


def _esc(v) -> str:
    return html.escape(str(v))


def sparkline_svg(points, width: int = 180, height: int = 36) -> str:
    """One series as an inline SVG polyline (2px stroke, no axes — the
    tile label and last value carry the reading; a <title> supplies
    the hover detail without any script)."""
    vals = [float(v) for _, v in points]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    n = len(vals)
    pts = " ".join(
        f"{(i * (width - 4) / max(n - 1, 1) + 2):.1f},"
        f"{(height - 3 - (v - lo) / span * (height - 6)):.1f}"
        for i, v in enumerate(vals))
    return (
        f'<svg width="{width}" height="{height}" role="img" '
        f'aria-label="min {lo:g}, max {hi:g}">'
        f"<title>min {lo:g} · max {hi:g} · last {vals[-1]:g}</title>"
        f'<polyline points="{pts}" fill="none" stroke="var(--series-1)" '
        'stroke-width="2" stroke-linejoin="round" '
        'stroke-linecap="round"/></svg>')


def _fmt(v) -> str:
    if isinstance(v, float):
        if abs(v) >= 1e9:
            return f"{v / 1e9:.2f}G"
        if abs(v) >= 1e6:
            return f"{v / 1e6:.2f}M"
        if v.is_integer():
            return str(int(v))
        return f"{v:.3f}"
    return str(v)


def _tile(label: str, value, bad: bool = False) -> str:
    cls = "tile bad" if bad else "tile"
    return (f'<div class="{cls}"><div class="v">{_esc(_fmt(value))}'
            f'</div><div class="k">{_esc(label)}</div></div>')


def _alert_rows(alerts: list[dict], with_origin: bool = False) -> str:
    if not alerts:
        return ('<tr><td colspan="6" class="ok">'
                "✓ no alerts recorded</td></tr>")
    rows = []
    for a in alerts:
        sev = a.get("severity", "warn")
        state = a.get("state", "?")
        origin = (f"<td>{_esc(a.get('origin', ''))}</td>"
                  if with_origin else "")
        detail = ", ".join(f"{k}={_fmt(v) if isinstance(v, float) else v}"
                           for k, v in (a.get("detail") or {}).items())
        rows.append(
            f"<tr>{origin}"
            f'<td class="sev {_esc(sev)}">{_SEV_ICON.get(sev, "?")} '
            f"{_esc(sev)}</td>"
            f"<td>{_esc(a.get('rule'))}</td>"
            f'<td class="state-{_esc(state)}">'
            f"{_STATE_ICON.get(state, '')} {_esc(state)}</td>"
            f'<td class="num">{a.get("fired_count", 0)}</td>'
            f'<td class="mono">{_esc(detail)}</td></tr>')
    return "".join(rows)


def _eta_cell(r: dict) -> tuple[str, str]:
    """(progress, eta) cells from a request snapshot's estimate block
    (obs/estimate) — em-dashes while warming up / estimation off."""
    est = ((r.get("progress") or {}).get("estimate") or {})
    p = est.get("progress_ratio")
    eta = est.get("eta_s")
    return (f"{p * 100:.1f}%" if p is not None else "—",
            f"{eta:g}" if eta is not None else "—")


def _request_rows(reqs: list[dict], with_origin: bool = False) -> str:
    if not reqs:
        return '<tr><td colspan="11">no requests</td></tr>'
    rows = []
    for r in sorted(reqs, key=lambda r: str(r.get("id"))):
        origin = (f"<td>{_esc(r.get('origin', ''))}</td>"
                  if with_origin else "")
        prog = r.get("progress") or {}
        res = r.get("result") or {}
        best = res.get("best", prog.get("best", ""))
        pct, eta = _eta_cell(r)
        rows.append(
            f"<tr>{origin}<td>{_esc(r.get('id'))}</td>"
            f"<td>{_esc(r.get('state'))}</td>"
            f'<td class="num">{_esc(r.get("submesh", ""))}</td>'
            f'<td class="num">{r.get("dispatches", 0)}</td>'
            f'<td class="num">{r.get("preemptions", 0)}</td>'
            f'<td class="num">{_esc(r.get("spent_s", ""))}</td>'
            f'<td class="num">{_esc(pct)}</td>'
            f'<td class="num">{_esc(eta)}</td>'
            f'<td class="num">{_esc(best)}</td>'
            f'<td class="mono">{_esc(r.get("error") or "")}</td></tr>')
    return "".join(rows)


def _lane_rows(cap: dict | None) -> str:
    """Per-lane utilization stripes from the capacity snapshot's
    ``lanes_detail`` (obs/capacity.LaneLedger): one horizontal stripe
    per lane, segment width = fraction of lifetime in each state (the
    reserved status palette carries the state; the title attribute and
    the utilization cell carry the numbers)."""
    lanes = (cap or {}).get("lanes_detail") or []
    if not lanes:
        return ""
    rows = []
    for ln in lanes:
        life = ln.get("lifetime_s") or 0.0
        segs = []
        for state, secs in sorted((ln.get("seconds") or {}).items()):
            frac = (secs / life * 100.0) if life > 0 else 0.0
            if frac < 0.05:
                continue
            segs.append(
                f'<span class="st-{_esc(state)}" '
                f'style="width:{frac:.2f}%" '
                f'title="{_esc(state)} {secs:.1f}s '
                f'({frac:.1f}%)"></span>')
        util = ln.get("utilization")
        util_cell = f"{util * 100:.1f}%" if util is not None else "—"
        rows.append(
            f'<tr><td class="num">{_esc(ln.get("lane"))}</td>'
            f"<td>{_esc(ln.get('state'))}</td>"
            f'<td><div class="stripe">{"".join(segs)}</div></td>'
            f'<td class="num">{util_cell}</td>'
            f'<td class="num">{life:.1f}</td></tr>')
    return (
        "<h2>Lanes</h2><table><tr><th>lane</th><th>state</th>"
        "<th>time in state</th><th>executing</th><th>lifetime s</th>"
        f"</tr>{''.join(rows)}</table>")


def _page(title: str, sub: str, body: str) -> str:
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{_esc(title)}</title><style>{_CSS}</style></head>"
        f"<body><h1>{_esc(title)}</h1><p class='sub'>{_esc(sub)}</p>"
        f"{body}<footer>generated "
        f"{time.strftime('%Y-%m-%d %H:%M:%S')} · {PACKAGE} "
        "operational dashboard · self-contained (no external assets)"
        "</footer></body></html>")


def _remediation_rows(rem: dict | None) -> str:
    """The self-healing journal tail (service/remediate snapshot)."""
    actions = (rem or {}).get("actions") or []
    if not actions:
        mode = (rem or {}).get("mode", "observe")
        return (f'<tr><td colspan="4" class="ok">✓ no remediation '
                f"activity ({_esc(mode)} mode)</td></tr>")
    rows = []
    for a in reversed(actions[-12:]):
        outcome = a.get("outcome", "?")
        cls = ("ok" if outcome in ("applied", "observed")
               else "err" if outcome in ("failed", "error") else "")
        detail = ", ".join(
            f"{k}={_fmt(v) if isinstance(v, float) else v}"
            for k, v in (a.get("detail") or {}).items())
        rows.append(
            f"<tr><td>{_esc(a.get('rule'))}</td>"
            f"<td>{_esc(a.get('action'))}</td>"
            f'<td class="{cls}">{_esc(outcome)}</td>'
            f'<td class="mono">{_esc(detail)}</td></tr>')
    return "".join(rows)


def render_server(snapshot: dict | None, alerts: dict | None,
                  history: dict | None) -> str:
    """One serve session: stat tiles, alert panel, self-healing
    journal, sparklines from the health monitor's history rings,
    request table."""
    snapshot = snapshot or {}
    alerts = alerts or {}
    firing = alerts.get("firing", 0)
    queue = snapshot.get("queue") or {}
    subs = snapshot.get("submeshes") or []
    busy = sum(1 for s in subs if s.get("running"))
    counters = snapshot.get("counters") or {}
    cache = snapshot.get("executor_cache") or {}
    rem = snapshot.get("remediation") or {}
    n_quar = len(rem.get("quarantined") or [])
    paused = rem.get("admission_paused")
    led = snapshot.get("ledger") or {}
    led_tiles = []
    if led:
        from .aggregate import recovered_live
        led_tiles = [
            _tile("restarts", led.get("restarts", 0)),
            _tile("recovered", recovered_live(led)),
            _tile("ledger lag s", led.get("lag_s")
                  if led.get("lag_s") is not None else "—"),
        ]
    fo = snapshot.get("failover") or {}
    if fo:
        peers = fo.get("peers") or []
        peers_down = sum(1 for p in peers
                         if p.get("expired") and not p.get("released"))
        led_tiles += [
            _tile("failover", "FENCED" if fo.get("fenced")
                  else fo.get("mode", "observe"),
                  bad=bool(fo.get("fenced"))),
            _tile("lease epoch",
                  (fo.get("lease") or {}).get("epoch", "—")),
            _tile("peers down", peers_down, bad=peers_down > 0),
            _tile("takeovers", fo.get("takeovers", 0)),
        ]
    tiles = "".join([
        _tile("firing alerts", firing, bad=firing > 0),
        _tile("queue depth", queue.get("depth", 0)),
        _tile("submeshes busy", f"{busy}/{len(subs)}"),
        _tile("quarantined", n_quar, bad=n_quar > 0),
        _tile("admission", "paused" if paused else "open",
              bad=bool(paused)),
        _tile("done", counters.get("done", 0)),
        _tile("failed", counters.get("failed", 0),
              bad=counters.get("failed", 0) > 0),
        _tile("preemptions", counters.get("preemptions", 0)),
        _tile("cache hit/miss", f"{cache.get('hits', 0)}/"
                                f"{cache.get('misses', 0)}"),
    ] + led_tiles)
    sparks = []
    for name, points in sorted((history or {}).items()):
        svg = sparkline_svg(points)
        if not svg:
            continue
        last = points[-1][1]
        sparks.append(f'<div class="spark"><span class="k">'
                      f"{_esc(name)}</span><span class='v'>"
                      f"{_esc(_fmt(float(last)))}</span><br>{svg}</div>")
    body = (
        f'<div class="tiles">{tiles}</div>'
        "<h2>Alerts</h2><table><tr><th>severity</th><th>rule</th>"
        "<th>state</th><th>fired</th><th>detail</th></tr>"
        f"{_alert_rows(alerts.get('alerts') or [])}</table>"
        f"<h2>Self-healing ({_esc(rem.get('mode', 'observe'))} mode)"
        "</h2><table><tr><th>rule</th><th>action</th><th>outcome</th>"
        f"<th>detail</th></tr>{_remediation_rows(rem)}</table>"
        + (f"<h2>Trends</h2><div class='sparks'>{''.join(sparks)}</div>"
           if sparks else "")
        + _lane_rows(snapshot.get("capacity"))
        + "<h2>Requests</h2><table><tr><th>id</th><th>state</th>"
          "<th>submesh</th><th>disp</th><th>preempt</th>"
          "<th>spent s</th><th>progress</th><th>eta s</th>"
          "<th>best</th><th>error</th></tr>"
        + _request_rows(list((snapshot.get("requests") or {}).values()))
        + "</table>")
    up = snapshot.get("uptime_s")
    return _page(f"{PACKAGE} — server health",
                 f"uptime {up}s · {len(subs)} submesh(es) · "
                 f"{alerts.get('evaluations', 0)} health sweeps", body)


def render_fleet(merged: dict) -> str:
    """A fleet scrape (obs/aggregate.merge): per-server verdicts, all
    alerts and requests origin-labeled."""
    servers = merged.get("servers") or []
    firing = merged.get("firing", 0)
    down = sum(1 for s in servers if not s["ok"])
    quarantined = sum(s.get("quarantined") or 0 for s in servers)
    paused = sum(1 for s in servers if s.get("admission_paused"))
    tiles = "".join([
        _tile("servers", len(servers)),
        _tile("unreachable", down, bad=down > 0),
        _tile("firing alerts", firing, bad=firing > 0),
        _tile("quarantined submeshes", quarantined,
              bad=quarantined > 0),
        _tile("admission paused", paused, bad=paused > 0),
        _tile("fenced", sum(1 for s in servers if s.get("fenced")),
              bad=any(s.get("fenced") for s in servers)),
        _tile("requests", len(merged.get("requests") or [])),
    ])
    srv_rows = []
    for s in servers:
        ok = s["ok"] and s.get("healthz") == "ok"
        degraded = bool(s.get("quarantined"))
        mark = (f'<span class="err">✗ '
                f"{_esc(s.get('error') or s.get('healthz'))}</span>"
                if not ok else
                '<span class="sev warn">● degraded</span>'
                if degraded else '<span class="ok">✓ ok</span>')
        rem = ((f"{s.get('quarantined')} quarantined"
                if s.get("quarantined") else "")
               + (" · paused" if s.get("admission_paused") else ""))
        led = ("—" if s.get("restarts") is None else
               f"{s.get('restarts')} restart(s) · "
               f"{s.get('recovered_requests')} recovered · "
               f"lag {s.get('ledger_lag_s')}s")
        if s.get("failover_mode") is None and not s.get("fenced"):
            fo_cell = "—"
        else:
            fo_cell = (f"{s.get('failover_mode')} · "
                       f"epoch {s.get('lease_epoch')} · "
                       f"{s.get('peers_down') or 0} down · "
                       f"{s.get('takeovers') or 0} takeover(s)")
            if s.get("fenced"):
                # icon + word, never color alone (the palette rule)
                fo_cell = "✗ FENCED · " + fo_cell
        util = s.get("utilization")
        util_cell = f"{util * 100:.0f}%" if util is not None else "—"
        srv_rows.append(
            f"<tr><td>{_esc(s['origin'])}</td><td>{mark}</td>"
            f'<td class="num">{_esc(s.get("firing", "-"))}</td>'
            f'<td class="num">{_esc(s.get("queue_depth", "-"))}</td>'
            f'<td class="num">{_esc(s.get("submeshes_busy", "-"))}/'
            f"{_esc(s.get('submeshes', '-'))}</td>"
            f'<td class="num">{_esc(util_cell)}</td>'
            f"<td>{_esc(rem or '—')}</td>"
            f"<td>{_esc(led)}</td>"
            f"<td>{_esc(fo_cell)}</td>"
            f'<td class="num">{_esc(s.get("requests", 0))}</td>'
            f'<td class="num">{_esc(s.get("uptime_s", "-"))}</td></tr>')
    body = (
        f'<div class="tiles">{tiles}</div>'
        "<h2>Servers</h2><table><tr><th>origin</th><th>health</th>"
        "<th>firing</th><th>queue</th><th>busy</th><th>ρ</th>"
        "<th>remediation</th><th>ledger</th><th>failover</th>"
        "<th>requests</th>"
        f"<th>uptime s</th></tr>{''.join(srv_rows)}</table>"
        "<h2>Alerts</h2><table><tr><th>origin</th><th>severity</th>"
        "<th>rule</th><th>state</th><th>fired</th><th>detail</th></tr>"
        f"{_alert_rows(merged.get('alerts') or [], with_origin=True)}"
        "</table>"
        "<h2>Requests</h2><table><tr><th>origin</th><th>id</th>"
        "<th>state</th><th>submesh</th><th>disp</th><th>preempt</th>"
        "<th>spent s</th><th>progress</th><th>eta s</th>"
        "<th>best</th><th>error</th></tr>"
        f"{_request_rows(merged.get('requests') or [], with_origin=True)}"
        "</table>")
    return _page(f"{PACKAGE} — fleet health",
                 f"{len(servers)} server(s) scraped", body)
