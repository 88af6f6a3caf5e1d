"""HTTP front end of the search server: health and metrics reads AND the
submit/cancel write path.

Reproduces `tpu_tree_search/obs/httpd.py` (`ObsHttpd`,
`start_http_server`): every route, status code, content type and JSON key
of JAX's, on the standard library's ``ThreadingHTTPServer`` (threaded, so
a slow scrape never blocks another). It sits in FRONT of a running
:class:`~tpu_tree_search_torch.service.SearchServer`:

- ``GET /healthz``: liveness, ``200 {"status": "ok"}`` while serving,
  ``503`` once the server is closing (load balancers drain on it);
- ``GET /metrics``: Prometheus text, the server's own registry
  (requests, queue, submeshes, executor cache) followed by the process's
  registry (checkpoints, retries, faults, segments);
- ``GET /status``: the JSON status snapshot
  (``SearchServer.status_snapshot()``);
- ``GET /trace``: the flight recorder's ring buffer as Chrome trace JSON
  (obs/chrome_trace; open it in Perfetto);
- ``GET /alerts``: the health rules' alert snapshot (obs/health; the
  ``doctor`` command's input);
- ``GET /capacity``: the lane-state ledger and capacity model document
  (obs/capacity), empty but valid with ``TTS_CAPACITY=0``;
- ``GET /dashboard``: the self-contained HTML dashboard (obs/dashboard);
- ``GET /journey?tag=``: the request journeys (obs/journey), stitched
  from the ledger and fleet directories and the observability store;
  empty but valid without them;
- ``POST /submit``: admit a request; the JSON body is the file spool's
  payload (``service/spool.request_from_payload``: ``inst`` or
  ``p_times``, ``lb``, ``ub``, ``priority``, ``deadline_s``, ``tag``,
  ...). ``200 {"request_id": ..., "state": ...}``; a full queue answers
  ``429``, a closing server ``503``, a malformed payload ``400``. With a
  ledger the server journals the admission before it answers, as for a
  spool file, so a 200 survives a hard kill;
- ``POST /cancel``: body ``{"request_id": ...}``; ``200 {"cancelled":
  bool}`` (false: already terminal), ``404`` for an unknown id;
- ``POST /profile?duration_s=N``: capture on demand, ``torch.profiler``
  against the LIVE process for N seconds (default 1, at most
  ``utils.config.PROFILE_MAX_DURATION_S``) through obs/profiler, and the
  artifact directory in the answer. One capture at a time: another
  request meanwhile gets ``409``; a closing server ``503``. The artifact
  root is ``--profile-dir`` (default: ``profiles/`` under the server's
  workdir, else a temporary directory), a fresh subdirectory a capture.

Usage::

    httpd = start_http_server(server, port=9100)    # port=0: ephemeral
    ...
    httpd.close()

Wired into the CLI as ``serve --http-port N`` (off by default); it binds
``127.0.0.1`` unless given another host.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import chrome_trace, metrics, profiler, tracelog

__all__ = ["start_http_server", "ObsHttpd"]


class _Handler(BaseHTTPRequestHandler):
    # the ObsHttpd instance is attached to the server object
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: D102 — silence stderr;
        pass                            # requests are counted in metrics

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    GET_PATHS = ("/healthz", "/metrics", "/status", "/trace", "/alerts",
                 "/capacity", "/dashboard", "/journey", "/")
    POST_PATHS = ("/submit", "/cancel", "/profile")

    def _query(self) -> dict:
        qs = self.path.split("?", 1)[1] if "?" in self.path else ""
        return {k: v[-1] for k, v in
                urllib.parse.parse_qs(qs).items()}

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        obs: "ObsHttpd" = self.server.obs  # type: ignore[attr-defined]
        self._route({"/healthz": obs.healthz, "/metrics": obs.metrics,
                     "/status": obs.status, "/trace": obs.trace,
                     "/alerts": obs.alerts, "/capacity": obs.capacity,
                     "/dashboard": obs.dashboard,
                     "/journey": lambda: obs.journey(self._query()),
                     "/": obs.index}, other_method=self.POST_PATHS)

    def do_POST(self) -> None:  # noqa: N802 — http.server API
        obs: "ObsHttpd" = self.server.obs  # type: ignore[attr-defined]
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b""
        except (OSError, ValueError):
            body = b""
        self._route({"/submit": lambda: obs.submit(body),
                     "/cancel": lambda: obs.cancel(body),
                     "/profile": lambda: obs.profile(self._query())},
                    other_method=self.GET_PATHS)

    def _route(self, handlers: dict, other_method: tuple = ()) -> None:
        obs: "ObsHttpd" = self.server.obs  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            handler = handlers.get(path)
            if handler is None:
                if path in other_method:
                    # known endpoint, wrong verb: 405, not a
                    # self-contradictory 404 that lists the path it
                    # just claimed not to know
                    obs.http_requests.inc(path="<405>")
                    want = ("GET" if path in self.GET_PATHS else "POST")
                    self._send(405, json.dumps(
                        {"error": f"{path} requires {want}"}) + "\n",
                        "application/json")
                    return
                obs.http_requests.inc(path="<404>")
                self._send(404, json.dumps(
                    {"error": f"unknown path {path!r}",
                     "endpoints": ["/healthz", "/metrics", "/status",
                                   "/trace", "/alerts", "/capacity",
                                   "/dashboard", "/journey", "/submit",
                                   "/cancel", "/profile"]})
                    + "\n", "application/json")
                return
            obs.http_requests.inc(path=path)
            code, body, ctype = handler()
            self._send(code, body, ctype)
        except BrokenPipeError:
            pass        # client went away mid-response; nothing to do
        except Exception as e:  # noqa: BLE001 — a scrape bug must not
            # kill the serving thread; report it to the scraper instead
            self._send(500, json.dumps({"error": repr(e)}) + "\n",
                       "application/json")


class ObsHttpd:
    """A running observability HTTP server (see module docstring).
    `server` is duck-typed: anything with ``status_snapshot()`` and a
    ``_closing`` event works; None serves metrics/trace only."""

    def __init__(self, server=None, host: str = "127.0.0.1",
                 port: int = 0, registries=None,
                 trace: tracelog.TraceLog | None = None,
                 profile_dir: str | None = None,
                 health_monitor=None):
        self.server = server
        self.trace_log = trace
        self._profile_dir = profile_dir
        self.health_monitor = health_monitor
        regs = list(registries) if registries is not None else []
        if not regs:
            if server is not None and getattr(server, "metrics", None) \
                    is not None:
                regs.append(server.metrics)
            regs.append(metrics.default())
        self.registries = regs
        self.http_requests = self.registries[0].counter(
            "tts_http_requests_total",
            "observability endpoint hits by path")
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.obs = self  # type: ignore[attr-defined]
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="tts-obs-httpd")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)

    def __enter__(self) -> "ObsHttpd":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ routes

    def _closing(self) -> bool:
        evt = getattr(self.server, "_closing", None)
        return bool(evt is not None and evt.is_set())

    def index(self):
        return 200, json.dumps(
            {"service": "tpu_tree_search_torch",
             "endpoints": ["/healthz", "/metrics", "/status", "/trace",
                           "/alerts", "/capacity", "/dashboard",
                           "/journey", "/submit", "/cancel",
                           "/profile"]}) + "\n", \
            "application/json"

    def healthz(self):
        if self.server is None:
            return 200, '{"status": "ok", "server": null}\n', \
                "application/json"
        if self._closing():
            return 503, '{"status": "closing"}\n', "application/json"
        return 200, '{"status": "ok"}\n', "application/json"

    def metrics(self):
        text = "".join(r.to_prometheus() for r in self.registries)
        return 200, text, "text/plain; version=0.0.4; charset=utf-8"

    def status(self):
        if self.server is None:
            body = {"server": None,
                    "metrics": [r.to_json() for r in self.registries]}
        else:
            body = self.server.status_snapshot()
        return 200, json.dumps(body) + "\n", "application/json"

    def trace(self):
        log = self.trace_log or tracelog.get()
        body = json.dumps(chrome_trace.to_chrome(log.records()))
        return 200, body, "application/json"

    def _monitor(self):
        """The health monitor in play: an explicitly attached one, else
        the server's own (SearchServer.health)."""
        if self.health_monitor is not None:
            return self.health_monitor
        return getattr(self.server, "health", None)

    def alerts(self):
        """GET /alerts: the rules engine's lifecycle snapshot. A server
        without a monitor answers an empty-but-valid document so fleet
        scrapers need no special case."""
        mon = self._monitor()
        if mon is None:
            body = {"enabled": False, "firing": 0, "alerts": []}
        else:
            body = {"enabled": True, **mon.alerts_snapshot()}
        return 200, json.dumps(body) + "\n", "application/json"

    def capacity(self):
        """GET /capacity: the lane-state ledger + shape-class capacity
        model document (obs/capacity), with the what-if partition
        advisor. A server without the capacity layer (TTS_CAPACITY=0,
        or no server attached) answers an empty-but-valid document so
        fleet scrapers need no special case."""
        srv = self.server
        snap = (srv.capacity_snapshot()
                if srv is not None and hasattr(srv, "capacity_snapshot")
                else None)
        if snap is None:
            body = {"enabled": False}
        else:
            body = {"enabled": True, **snap}
        return 200, json.dumps(body) + "\n", "application/json"

    def journey(self, query: dict):
        """GET /journey?tag=: the flight recorder's cross-lifetime
        request timelines (obs/journey), stitched from the server's
        ledger/fleet dirs and durable event store. A server without
        ledger or store answers an empty-but-valid document — journeys
        need durable inputs, not a special-cased client."""
        srv = self.server
        if srv is None or not hasattr(srv, "journeys"):
            body = {"enabled": False, "journeys": []}
        else:
            js = srv.journeys(tag=query.get("tag") or None)
            body = {"enabled": True, "count": len(js), "journeys": js}
        return 200, json.dumps(body) + "\n", "application/json"

    def dashboard(self):
        """GET /dashboard: the self-contained HTML view (stdlib only,
        no external assets — save it and it still renders)."""
        from . import dashboard as dash
        snapshot = (self.server.status_snapshot()
                    if self.server is not None else None)
        mon = self._monitor()
        html = dash.render_server(
            snapshot,
            mon.alerts_snapshot() if mon is not None else None,
            dict(mon.history) if mon is not None else None)
        return 200, html, "text/html; charset=utf-8"

    # ------------------------------------------------------- write path

    @staticmethod
    def _json_body(body: bytes) -> dict:
        payload = json.loads(body.decode() if body else "")
        if not isinstance(payload, dict):
            raise ValueError("payload must be a JSON object")
        return payload

    def submit(self, body: bytes):
        """POST /submit: admit one request (spool payload schema)."""
        if self.server is None:
            return 503, json.dumps(
                {"error": "no search server attached"}) + "\n", \
                "application/json"
        # spool's payload parser is THE request schema — one wire format
        # whether a request arrives as a file or an HTTP body
        from ..service.queueing import AdmissionError
        from ..service.spool import request_from_payload
        try:
            payload = self._json_body(body)
            request = request_from_payload(payload)
        except (ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            return 400, json.dumps({"error": str(e)}) + "\n", \
                "application/json"
        try:
            rid = self.server.submit(request)
        except AdmissionError as e:
            code = 503 if self._closing() else 429
            return code, json.dumps({"error": str(e)}) + "\n", \
                "application/json"
        # real state, not an assumed "QUEUED": the ledger's idempotent
        # re-serve path can answer with an already-DONE request id
        try:
            state = self.server.status(rid)["state"]
        except KeyError:
            state = "QUEUED"
        return 200, json.dumps(
            {"request_id": rid, "state": state}) + "\n", \
            "application/json"

    @property
    def profile_dir(self) -> str:
        """The capture artifact root (created lazily): the configured
        one, else ``<server workdir>/profiles``, else a temp dir."""
        if self._profile_dir is None:
            wd = getattr(self.server, "workdir", None)
            if wd is not None:
                self._profile_dir = str(wd / "profiles") \
                    if hasattr(wd, "__truediv__") \
                    else f"{wd}/profiles"
            else:
                import tempfile
                self._profile_dir = tempfile.mkdtemp(
                    prefix="tts_profiles_")
        return self._profile_dir

    def profile(self, query: dict):
        """POST /profile?duration_s=N: capture on demand against the
        live process (obs/profiler, the process's one torch.profiler).
        Returns the artifact directory; 409 while another
        capture runs, 503 on a closing server, 400 on a bad duration."""
        from ..utils import config as cfg
        if self._closing():
            return 503, json.dumps(
                {"error": "server closing"}) + "\n", "application/json"
        try:
            duration_s = float(query.get("duration_s", 1.0))
            if not 0 < duration_s <= cfg.PROFILE_MAX_DURATION_S:
                raise ValueError(
                    f"duration_s must be in (0, "
                    f"{cfg.PROFILE_MAX_DURATION_S}]")
        except (TypeError, ValueError) as e:
            return 400, json.dumps({"error": str(e)}) + "\n", \
                "application/json"
        sess = profiler.session()
        try:
            artifact = sess.capture(duration_s,
                                    sess.fresh_dir(self.profile_dir))
        except profiler.ProfilerBusyError as e:
            return 409, json.dumps({"error": str(e)}) + "\n", \
                "application/json"
        return 200, json.dumps(
            {"artifact": artifact, "duration_s": duration_s,
             "hint": "tpu_tree_search_torch.obs.chrome_trace"
                     ".load_profile_trace(<artifact>)"}) \
            + "\n", "application/json"

    def cancel(self, body: bytes):
        """POST /cancel: cancel a queued/running request by id."""
        if self.server is None:
            return 503, json.dumps(
                {"error": "no search server attached"}) + "\n", \
                "application/json"
        try:
            rid = self._json_body(body)["request_id"]
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            return 400, json.dumps(
                {"error": f"body must be "
                          f'{{"request_id": ...}}: {e}'}) + "\n", \
                "application/json"
        try:
            cancelled = self.server.cancel(rid)
        except KeyError:
            return 404, json.dumps(
                {"error": f"unknown request id {rid!r}"}) + "\n", \
                "application/json"
        return 200, json.dumps(
            {"request_id": rid, "cancelled": bool(cancelled)}) + "\n", \
            "application/json"


def start_http_server(server=None, host: str = "127.0.0.1",
                      port: int = 0, registries=None,
                      trace: tracelog.TraceLog | None = None,
                      profile_dir: str | None = None,
                      health_monitor=None) -> ObsHttpd:
    """Start the observability HTTP front-end on `host:port` (port 0
    binds an ephemeral port — read ``.port``). Returns the running
    :class:`ObsHttpd`; call ``.close()`` (or use as a context manager)
    to stop it. `health_monitor` overrides the server's own
    (``SearchServer.health``) behind ``/alerts`` and ``/dashboard``."""
    return ObsHttpd(server=server, host=host, port=port,
                    registries=registries, trace=trace,
                    profile_dir=profile_dir,
                    health_monitor=health_monitor)
