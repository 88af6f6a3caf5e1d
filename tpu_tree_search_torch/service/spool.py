"""File-spool front-end of the search server.

Reproduces `tpu_tree_search/service/spool.py`: `request_from_payload`,
`payload_from_request` (the same JSON, byte for byte, for the same
request), `submit_file`, `wait_result`, `unserved_requests` and
`serve_spool`.

Clients drop ``<id>.req.json`` files into a spool directory; the serving
process ingests them and writes ``<id>.res.json`` when the request turns
terminal. Writes on both sides are atomic (tmp + rename), so a reader
never sees a torn file. A malformed or rejected request file still gets a
result file, with an ``"error"``.

Request JSON::

    {"inst": 21,                 # Taillard id — OR "p_times": [[...]]
     "problem": "pfsp",          # workload plugin (problems/base.py):
                                 # pfsp | nqueens | tsp | knapsack;
                                 # p_times is that problem's table
     "lb": 1, "ub": "opt",       # ub: "opt" | integer | null
     "priority": 0, "deadline_s": null,
     "chunk": 64, "capacity": null, "tag": null,
     "tuned": false}             # true: leave chunk/balance_period to
                                 # the server's tuner (tune/tuner.py)

Result JSON: the request's final `RequestRecord.snapshot()` plus the
spool id.
"""

from __future__ import annotations

import itertools
import json
import os
import pathlib
import time

import numpy as np

from .request import SearchRequest

REQ_SUFFIX = ".req.json"
RES_SUFFIX = ".res.json"

# default spool ids: timestamp + pid + per-process counter — two
# submissions in the same millisecond must not collide (the second
# would overwrite the first's request file and be silently dropped)
_spool_seq = itertools.count()


def _atomic_write_json(path: pathlib.Path, payload: dict) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(payload, indent=1))
    os.replace(tmp, path)


def request_from_payload(payload: dict) -> SearchRequest:
    """Build a SearchRequest from a spool request dict. `problem`
    (default "pfsp") names the workload plugin; `p_times` is that
    problem's 2-D instance table (problems/base.py documents the
    per-problem format). `inst` (a Taillard id) is PFSP-only."""
    problem = str(payload.get("problem") or "pfsp")
    if "p_times" in payload:
        p = np.asarray(payload["p_times"], np.int32)
    elif "inst" in payload:
        if problem != "pfsp":
            raise ValueError("'inst' (a Taillard id) is PFSP-only; "
                             f"problem {problem!r} needs 'p_times'")
        from ..problems import taillard
        p = taillard.processing_times(int(payload["inst"]))
    else:
        raise ValueError("request needs 'inst' or 'p_times'")
    ub = payload.get("ub")
    if ub == "opt":
        if "inst" not in payload:
            raise ValueError("'ub': 'opt' needs a Taillard 'inst'")
        from ..problems import taillard
        ub = taillard.optimal_makespan(int(payload["inst"]))
    kwargs = {}
    for k in ("priority", "chunk", "balance_period", "min_seed",
              "segment_iters", "checkpoint_every"):
        if payload.get(k) is not None:
            kwargs[k] = int(payload[k])
    if payload.get("capacity") is not None:
        kwargs["capacity"] = int(payload["capacity"])
    if payload.get("deadline_s") is not None:
        kwargs["deadline_s"] = float(payload["deadline_s"])
    if payload.get("share_group") is not None:
        kwargs["share_group"] = str(payload["share_group"])
    if payload.get("tenant") is not None:
        kwargs["tenant"] = str(payload["tenant"])
    if payload.get("portfolio") is not None:
        kwargs["portfolio"] = int(payload["portfolio"])
    if payload.get("checkpoint_meta") is not None:
        kwargs["checkpoint_meta"] = dict(payload["checkpoint_meta"])
    if payload.get("tuned"):
        # adaptive dispatch: leave the knobs OPEN (chunk=None /
        # balance_period=None) so the server resolves them from its
        # tuning cache / defaults table; explicit chunk/balance_period
        # keys in the same payload win (they were set above)
        kwargs.setdefault("chunk", None)
        kwargs.setdefault("balance_period", None)
    from .. import problems
    try:
        default_lb = problems.get(problem).default_lb
    except KeyError:
        default_lb = 1        # validate() rejects with the real reason
    return SearchRequest(
        p_times=p, problem=problem,
        lb_kind=int(payload.get("lb", default_lb)),
        init_ub=None if ub is None else int(ub),
        tag=payload.get("tag"), faults=payload.get("faults"), **kwargs)


def payload_from_request(req: SearchRequest) -> dict:
    """The inverse of :func:`request_from_payload`: serialize a
    SearchRequest back into the spool payload schema (the request
    ledger's admit-record body: `request_from_payload(
    payload_from_request(r))` rebuilds an equivalent request).
    Open tuned knobs (chunk/balance_period None) round-trip as
    ``{"tuned": true}``; per-request ``faults`` specs are deliberately
    NOT serialized (a drill fault must not follow a request across the
    crash-restart it exists to prove); non-JSON-safe ``checkpoint_meta``
    (the campaign driver stamps numpy arrays) is dropped with a trace
    event rather than failing the admit."""
    p = np.asarray(req.p_times)
    payload: dict = {"p_times": p.tolist(), "lb": int(req.lb_kind),
                     "problem": str(req.problem),
                     "ub": None if req.init_ub is None
                     else int(req.init_ub),
                     "priority": int(req.priority), "tag": req.tag}
    if req.deadline_s is not None:
        payload["deadline_s"] = float(req.deadline_s)
    if req.chunk is None or req.balance_period is None:
        payload["tuned"] = True
    if req.chunk is not None:
        payload["chunk"] = int(req.chunk)
    if req.balance_period is not None:
        payload["balance_period"] = int(req.balance_period)
    for k in ("capacity", "min_seed", "segment_iters",
              "checkpoint_every"):
        v = getattr(req, k)
        if v is not None:
            payload[k] = int(v)
    if req.share_group is not None:
        payload["share_group"] = str(req.share_group)
    if req.tenant != "-":
        # "-" is the unattributed default; omitted so an unattributed
        # request's admit record is byte-identical to pre-tenant ones
        payload["tenant"] = str(req.tenant)
    if req.portfolio is not None:
        payload["portfolio"] = int(req.portfolio)
    if req.checkpoint_meta:
        try:
            json.dumps(req.checkpoint_meta)
            payload["checkpoint_meta"] = req.checkpoint_meta
        except (TypeError, ValueError):
            from ..obs import tracelog
            tracelog.event("ledger.meta_dropped", tag=req.tag,
                           reason="checkpoint_meta is not JSON-safe; "
                                  "not journaled")
    return payload


def submit_file(spool: str | pathlib.Path, payload: dict,
                spool_id: str | None = None) -> str:
    """Client side: atomically drop a request file; returns the spool id."""
    spool = pathlib.Path(spool)
    spool.mkdir(parents=True, exist_ok=True)
    spool_id = spool_id or (f"{int(time.time() * 1000):x}-{os.getpid()}"
                            f"-{next(_spool_seq)}")
    _atomic_write_json(spool / f"{spool_id}{REQ_SUFFIX}", payload)
    return spool_id


def wait_result(spool: str | pathlib.Path, spool_id: str,
                timeout: float | None = None,
                poll_s: float = 0.2) -> dict:
    """Client side: poll for the result file; returns its dict."""
    path = pathlib.Path(spool) / f"{spool_id}{RES_SUFFIX}"
    t0 = time.monotonic()
    while True:
        if path.exists():
            return json.loads(path.read_text())
        if timeout is not None and time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no result for {spool_id} after {timeout}s")
        time.sleep(poll_s)


def unserved_requests(spool: str | pathlib.Path, skip=None):
    """Yield ``(spool_id, request_file_path)`` for every request file
    with no result file yet — THE definition of the backlog, shared by
    the serve loop and the server's boot pre-warm so the two can never
    drift on which requests count as waiting. `skip` is an optional set
    of already-handled spool ids; ids discovered to be already SERVED
    are added to it, so a long-polling caller (the serve loop) stats
    each historical result file once, not once per poll tick."""
    spool = pathlib.Path(spool)
    for req_file in sorted(spool.glob(f"*{REQ_SUFFIX}")):
        sid = req_file.name[:-len(REQ_SUFFIX)]
        if skip is not None and sid in skip:
            continue
        if (spool / f"{sid}{RES_SUFFIX}").exists():
            # already served (by this process or a previous server
            # lifetime): a restart must not re-execute history or
            # clobber a result file a client may be reading
            if skip is not None:
                skip.add(sid)
            continue
        yield sid, req_file


def serve_spool(server, spool: str | pathlib.Path,
                idle_exit_s: float | None = None,
                status_every_s: float | None = None,
                poll_s: float = 0.2, emit=print,
                should_exit=None) -> int:
    """Server side: ingest request files into `server`, write result
    files as requests turn terminal. Returns the number of requests
    served. Exits when `idle_exit_s` elapses with nothing queued,
    running or pending (None = run until `should_exit()`), printing a
    JSON status snapshot every `status_every_s` seconds.

    A malformed or rejected request file still gets a result file (with
    an ``"error"``) — a client polling for it must not hang forever on
    a bad submission.
    """
    from .queueing import AdmissionError, AdmissionPaused
    from .request import TERMINAL_STATES

    spool = pathlib.Path(spool)
    spool.mkdir(parents=True, exist_ok=True)
    pending: dict[str, str] = {}        # spool id -> request id
    seen: set[str] = set()
    # crash recovery (service/ledger): requests this server REPLAYED at
    # boot that originally arrived through a spool reconnect to their
    # request files here — re-submitting them would either duplicate
    # the work or bounce off their own still-active tag, and their
    # clients are still polling for the result file
    replayed = dict(getattr(server, "replayed_spool", None) or {})
    if replayed:
        pending.update(replayed)
        seen.update(replayed)
        emit(json.dumps({"spool_reconnected": len(replayed)}))
    served = 0
    last_work = time.monotonic()
    last_status = 0.0
    while True:
        # while the remediation tier holds admission paused
        # (compile_storm), the backlog WAITS in the spool instead of
        # being turned into permanent REJECTED results — the pause is a
        # temporary valve, and a spooled file carries its own retry
        paused = getattr(server, "admission_paused",
                         lambda: None)()
        for sid, req_file in ([] if paused is not None
                              else unserved_requests(spool, skip=seen)):
            seen.add(sid)
            try:
                payload = json.loads(req_file.read_text())
                # spool_id rides the ledger's admit record so a
                # restarted serve loop can reconnect result delivery
                rid = server.submit(request_from_payload(payload),
                                    spool_id=sid)
            except AdmissionPaused:
                # the pause engaged between this loop's paused check
                # and the submit: HOLD the file (back out of `seen` so
                # the next poll retries it) — a temporary valve must
                # never turn backlog into permanent REJECTED results
                seen.discard(sid)
                break
            except AdmissionError as e:
                _atomic_write_json(
                    spool / f"{sid}{RES_SUFFIX}",
                    {"spool_id": sid, "state": "REJECTED",
                     "error": str(e)})
                continue
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                _atomic_write_json(
                    spool / f"{sid}{RES_SUFFIX}",
                    {"spool_id": sid, "state": "REJECTED",
                     "error": str(e)})
                continue
            pending[sid] = rid
        for sid, rid in list(pending.items()):
            snap = server.status(rid)
            if snap["state"] in TERMINAL_STATES:
                _atomic_write_json(spool / f"{sid}{RES_SUFFIX}",
                                   {"spool_id": sid, **snap})
                del pending[sid]
                served += 1
        # a paused server is mid-incident, not idle: the idle-exit
        # clock must not shut it down on top of a held backlog.
        # Megabatch: requests the scheduler drained into the batch-
        # former are admitted work WAITING to batch — idle-exit must
        # not cancel them mid-hold (the queue reads empty the moment
        # the former holds them)
        former = getattr(server, "former", None)
        busy = bool(pending) or paused is not None \
            or len(server.queue) > 0 \
            or (former is not None and len(former) > 0) \
            or any(s.record is not None for s in server.slots)
        now = time.monotonic()
        if busy:
            last_work = now
        if status_every_s and now - last_status > status_every_s:
            emit(json.dumps(server.status_snapshot()))
            last_status = now
        if should_exit is not None and should_exit():
            return served
        if idle_exit_s is not None and now - last_work > idle_exit_s:
            return served
        time.sleep(poll_s)
