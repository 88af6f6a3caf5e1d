"""Deterministic fault injection for the resilience layer.

A copy of `tpu_tree_search/utils/faults.py` (stdlib only): the same spec
grammar, points and per-plan budgets. `pause_server` freezes the renewals
of every lease this process holds (`service.lease.suspend_renewals`) and
then wedges the executor, as in JAX.

None of the recovery paths (checkpoint rollback, segment retry, campaign
respawn, elastic resume) can be trusted without a way to make the
failures happen on demand. This module is that way: a handful of named
injection points threaded through the segmented driver
(engine/checkpoint.run_segmented), the host-fetch path
(checkpoint._fetch_many) and the campaign supervisor
(tools/run_campaign.py), each firing deterministically from an
env-/config-driven plan — so every fault a production run can hit has a
repeatable test (tests/test_resilience.py).

The plan is declared as a comma-separated spec, either via the
``TTS_FAULTS`` environment variable (it survives the campaign
supervisor's worker respawns — the worker subprocess inherits it) or
programmatically via :func:`configure`:

    TTS_FAULTS="kill_after_segment=3"        # os._exit(137) after seg 3's
                                             # checkpoint (preemption)
    TTS_FAULTS="corrupt_checkpoint=2"        # flip bytes in the file
                                             # written at segment 2
                                             # (torn/corrupt write)
    TTS_FAULTS="delay_segment=2:1.5"         # sleep 1.5 s before seg 2
                                             # (slow dispatch)
    TTS_FAULTS="fail_host_fetch=1"           # first 1 host fetches raise
                                             # InjectedFault (transient
                                             # device/tunnel error)
    TTS_FAULTS="delay_every=0.05"            # sleep 0.05 s before EVERY
                                             # segment (uniform slowdown —
                                             # makes short searches span
                                             # many wall-clock segments so
                                             # preemption/deadline tests
                                             # have a window to act in)
    TTS_FAULTS="kill_submesh=2:1@0"          # raise InjectedKill at the
                                             # start of segment 2, at most
                                             # 1 time, only on submesh 0 —
                                             # a submesh dying mid-request
                                             # (the thread-level analogue
                                             # of kill_after_segment; the
                                             # service retry/remediation
                                             # tier is the recovery)
    TTS_FAULTS="oom_segment=2"               # raise InjectedOOM (a
                                             # RESOURCE_EXHAUSTED-shaped
                                             # transient) at segment 2
    TTS_FAULTS="wedge_executor=2:5.0"        # sleep 5 s at the start of
                                             # segment 2, once — a wedged
                                             # device dispatch: heartbeats
                                             # stop, the health layer's
                                             # stall rule fires, the
                                             # remediation drill acts
    TTS_FAULTS="kill_server=3"               # os._exit(137) at the START
                                             # of segment 3, before it
                                             # dispatches — the WHOLE
                                             # serving process dies hard
                                             # (no flush, no handlers: a
                                             # real kill -9/OOM). The
                                             # request ledger + restart
                                             # replay is the recovery
                                             # (CI crash-restart leg)
    TTS_FAULTS="sigterm_server=3"            # deliver SIGTERM to our own
                                             # process at the start of
                                             # segment 3, once — the
                                             # graceful-drain drill: the
                                             # serve entry stops
                                             # admission, preempts at
                                             # segment boundaries, drains
                                             # every writer and exits 0
                                             # inside TTS_DRAIN_TIMEOUT_S
    TTS_FAULTS="pause_server=2:12"           # at the start of segment 2,
                                             # once: suspend this
                                             # process's lease renewals
                                             # (service/lease.py) AND
                                             # sleep 12 s — a stalled-
                                             # but-alive owner (GC pause,
                                             # NFS hang). With the pause
                                             # longer than TTS_LEASE_TTL_S
                                             # a peer adopts the ledger
                                             # mid-pause, and on waking
                                             # the stale owner must
                                             # SELF-FENCE at its next
                                             # append/save — the split-
                                             # brain drill the fencing
                                             # epoch exists for

The chaos-drill kinds (kill_submesh / oom_segment / wedge_executor /
kill_server / sigterm_server / pause_server) accept an optional
``@SUBMESH`` suffix: the injection fires only in a
thread whose ambient flight-recorder context (obs/tracelog) carries
that submesh index — so a GLOBAL plan can target one submesh of a
serving mesh while requests on the other submeshes run clean, which is
exactly the failure geometry the quarantine path exists for.
kill_submesh and oom_segment also take a fire budget
(``kill_submesh=SEG:BUDGET``, default 1) counted on the plan like
fail_host_fetch; wedge_executor and pause_server fire at most once per
plan.

Specs compose: ``"delay_segment=2:0.1,kill_after_segment=4"``. Unknown
names raise at parse time — a typo'd fault spec that silently injects
nothing would green-light an untested recovery path.

Counters ("once" semantics, e.g. fail_host_fetch) live ON the plan
object: a respawned worker re-parses TTS_FAULTS into a fresh plan and
re-arms them — exactly the transient-error model (the retried operation
succeeds) — and concurrently scoped plans each have their own budget.

Plans can also be THREAD-SCOPED via :func:`scoped`: the search service
runs one executor thread per submesh, and a per-request fault plan must
hit only that request's segments — a process-global plan would delay or
kill every concurrently served request. ``scoped(None)`` masks the
global plan for the thread (a clean request beside a faulty one).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time


class InjectedFault(RuntimeError):
    """A deliberately injected transient fault (retryable by design)."""


class InjectedKill(InjectedFault):
    """A submesh 'died' under this request (kill_submesh): the dispatch
    is gone, the thread survives. Transient-class on purpose — the
    service retry/remediation tier redispatches elsewhere."""


class InjectedOOM(InjectedFault):
    """An injected device OOM (oom_segment) — the message mimics the
    runtime's RESOURCE_EXHAUSTED wording so log-greppers treat drills
    and real incidents alike."""


# exit code used by the kill injection; distinct from Python tracebacks
# (1) and the campaign's wrong-answer abort (3), and conventionally
# SIGKILL's 128+9 — what a real preemption looks like to the supervisor
KILL_EXIT_CODE = 137


@dataclasses.dataclass
class FaultPlan:
    """Parsed injection plan; all fields optional (None/0 = disarmed)."""

    kill_after_segment: int | None = None    # os._exit after this segment
    corrupt_checkpoint: int | None = None    # flip bytes in the file
                                             # written at this segment
    delay_segment: tuple[int, float] | None = None   # (segment, seconds)
    delay_every: float = 0.0                 # sleep before EVERY segment
    fail_host_fetch: int = 0                 # fail the first N fetches
    # chaos-drill kinds (the self-healing service's reproducible fault
    # geometry): (segment, budget, submesh|None) for the raisers,
    # (segment, seconds, submesh|None) for the wedge
    kill_submesh: tuple[int, int, int | None] | None = None
    oom_segment: tuple[int, int, int | None] | None = None
    wedge_executor: tuple[int, float, int | None] | None = None
    # crash-safe-serving drills: kill_server hard-kills the WHOLE
    # process (os._exit, no flush — a real SIGKILL/OOM) at the start
    # of the segment, BEFORE it dispatches, so the death is
    # checkpoint-exact like kill_submesh; sigterm_server delivers
    # SIGTERM to our own pid (the graceful-drain drill)
    kill_server: tuple[int, int, int | None] | None = None
    sigterm_server: tuple[int, int, int | None] | None = None
    # split-brain drill: (segment, seconds, submesh|None) — suspend
    # lease renewals AND wedge the thread for `seconds`, once: a
    # stalled-but-alive owner whose lease expires under it
    pause_server: tuple[int, float, int | None] | None = None
    # fire count lives ON the plan (not module state): a thread-scoped
    # plan must have its own injection budget — concurrent requests with
    # scoped plans would otherwise spend each other's failures
    fetch_failures_fired: int = dataclasses.field(default=0, repr=False)
    kills_fired: int = dataclasses.field(default=0, repr=False)
    ooms_fired: int = dataclasses.field(default=0, repr=False)
    wedges_fired: int = dataclasses.field(default=0, repr=False)
    sigterms_fired: int = dataclasses.field(default=0, repr=False)
    pauses_fired: int = dataclasses.field(default=0, repr=False)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        plan = cls()
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            name, _, val = item.partition("=")
            name = name.strip()
            if name == "kill_after_segment":
                plan.kill_after_segment = int(val)
            elif name == "corrupt_checkpoint":
                plan.corrupt_checkpoint = int(val)
            elif name == "delay_segment":
                seg, _, secs = val.partition(":")
                plan.delay_segment = (int(seg), float(secs or 0.1))
            elif name == "delay_every":
                plan.delay_every = float(val)
            elif name == "fail_host_fetch":
                plan.fail_host_fetch = int(val)
            elif name == "kill_submesh":
                plan.kill_submesh = _parse_drill(val, int, 1)
            elif name == "oom_segment":
                plan.oom_segment = _parse_drill(val, int, 1)
            elif name == "wedge_executor":
                plan.wedge_executor = _parse_drill(val, float, 5.0)
            elif name == "kill_server":
                plan.kill_server = _parse_drill(val, int, 1)
            elif name == "sigterm_server":
                plan.sigterm_server = _parse_drill(val, int, 1)
            elif name == "pause_server":
                plan.pause_server = _parse_drill(val, float, 5.0)
            else:
                raise ValueError(
                    f"unknown fault {name!r} in TTS_FAULTS spec {spec!r}")
        return plan


def _parse_drill(val: str, second_type, second_default):
    """Parse a chaos-drill value ``SEG[:X][@SUBMESH]`` into
    (segment, x, submesh|None) — x is the fire budget (kill/oom) or the
    wedge seconds, submesh the optional ambient-context filter."""
    body, _, submesh = val.partition("@")
    seg, _, x = body.partition(":")
    return (int(seg),
            second_type(x) if x.strip() else second_type(second_default),
            int(submesh) if submesh.strip() else None)


def _ambient_submesh() -> int | None:
    """The submesh index of the calling thread's flight-recorder
    context (obs/tracelog) — how an @SUBMESH-filtered drill decides
    whether THIS thread is on the targeted submesh. None outside any
    service executor/canary context (the filter then never matches)."""
    from ..obs import tracelog
    sm = tracelog.current_context().get("submesh")
    return int(sm) if sm is not None else None


def _submesh_matches(target: int | None) -> bool:
    return target is None or _ambient_submesh() == target


# module state: the active global plan (fire counters live on the plan)
_plan: FaultPlan | None = None
_configured = False        # False: (re)read TTS_FAULTS lazily
_tls = threading.local()   # per-thread plan overlay stack (scoped())


def configure(plan: FaultPlan | str | None) -> None:
    """Install a plan programmatically (tests); None disarms entirely."""
    global _plan, _configured
    _plan = FaultPlan.parse(plan) if isinstance(plan, str) else plan
    _configured = True


def reset() -> None:
    """Back to env-driven lazy configuration (test teardown)."""
    global _plan, _configured
    _plan = None
    _configured = False


@contextlib.contextmanager
def scoped(plan: FaultPlan | str | None):
    """Overlay a plan for the CURRENT THREAD only (nestable). Inside the
    context, :func:`active` returns this plan instead of the global one;
    other threads keep seeing the global/env plan. ``scoped(None)``
    masks any global plan (a deliberately clean thread). The search
    service uses this so a per-request fault spec fires only in that
    request's executor thread."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(FaultPlan.parse(plan) if isinstance(plan, str) else plan)
    try:
        yield
    finally:
        stack.pop()


def active() -> FaultPlan | None:
    """The current plan — the innermost thread-scoped overlay if one is
    installed (see :func:`scoped`), else the global/env plan (lazily
    parsed from TTS_FAULTS), or None."""
    global _plan, _configured
    stack = getattr(_tls, "stack", None)
    if stack:
        return stack[-1]
    if not _configured:
        from . import config as _cfg
        spec = _cfg.env_str("TTS_FAULTS") or ""
        _plan = FaultPlan.parse(spec) if spec else None
        _configured = True
    return _plan


def corrupt_file(path, offset_frac: float = 0.5, n_bytes: int = 64) -> None:
    """Flip `n_bytes` bytes in the middle of `path` in place — the
    deterministic stand-in for a torn write / bit rot. Flipping (XOR
    0xFF) the compressed payload breaks both the zip member CRC and the
    checkpoint's own embedded CRC32, so every integrity tier sees it."""
    size = os.path.getsize(path)
    off = max(0, min(int(size * offset_frac), size - n_bytes))
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = f.read(n_bytes)
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))


def fire(point: str, segment: int | None = None, path=None) -> None:
    """Trigger the injection point `point` if the active plan arms it.

    Points (all no-ops without a matching plan entry):
    - "segment_start"   (segment=k): sleep delay_every (every segment)
      and/or the delay_segment sleep if it targets k. The chaos-drill
      kinds fire here too, before the segment dispatches: wedge_executor
      sleeps its seconds (once per plan — a wedged dispatch), then
      kill_submesh raises InjectedKill / oom_segment raises InjectedOOM
      while their budgets last, each gated on the optional @SUBMESH
      ambient-context filter. Raising BEFORE the dispatch keeps the
      failure checkpoint-exact: segment k never ran, so a redispatch
      resuming from segment k-1's snapshot repeats nothing.
    - "post_checkpoint" (segment=k, path=...): corrupt the just-written
      checkpoint file if corrupt_checkpoint targets k.
    - "post_segment"    (segment=k): os._exit(KILL_EXIT_CODE) if
      kill_after_segment targets k — fires at the END of segment k,
      after any checkpoint that segment wrote. Like a real preemption
      it is NOT checkpoint-aligned: with checkpoint_every > 1 the
      snapshot on disk may be older and resume redoes that interval.
    - "host_fetch": raise InjectedFault while the fail_host_fetch
      budget lasts (then succeed — the transient-error model).
    """
    plan = active()
    if plan is None:
        return
    if point == "segment_start":
        if plan.delay_every > 0:
            _record(point, "delay_every", segment=segment,
                    seconds=plan.delay_every)
            time.sleep(plan.delay_every)
        if plan.delay_segment and segment == plan.delay_segment[0]:
            _record(point, "delay_segment", segment=segment,
                    seconds=plan.delay_segment[1])
            time.sleep(plan.delay_segment[1])
        if (plan.wedge_executor is not None
                and segment == plan.wedge_executor[0]
                and plan.wedges_fired < 1
                and _submesh_matches(plan.wedge_executor[2])):
            plan.wedges_fired += 1
            seconds = plan.wedge_executor[1]
            _record(point, "wedge_executor", segment=segment,
                    seconds=seconds, submesh=_ambient_submesh())
            # an uninterruptible sleep is the POINT: a wedged device
            # dispatch does not honor stop flags either — recovery is
            # the remediation tier acting from outside, never the
            # wedge cooperating. Keep drill durations bounded.
            time.sleep(seconds)
        if (plan.pause_server is not None
                and segment == plan.pause_server[0]
                and plan.pauses_fired < 1
                and _submesh_matches(plan.pause_server[2])):
            plan.pauses_fired += 1
            seconds = plan.pause_server[1]
            _record(point, "pause_server", segment=segment,
                    seconds=seconds, submesh=_ambient_submesh())
            # the split-brain drill: stop renewing OUR lease(s), then
            # wedge like wedge_executor — a GC pause / NFS hang where
            # the process is alive but the lease expires under it. A
            # peer adopts mid-pause; on waking, the next ledger append
            # or checkpoint save must SELF-FENCE (LeaseLost), which is
            # exactly what the drill's test asserts.
            try:
                from ..service import lease as _lease
                _lease.suspend_renewals(seconds)
            except ImportError:
                pass   # engine-only install: plain wedge, still a drill
            time.sleep(seconds)
        if (plan.kill_submesh is not None
                and segment == plan.kill_submesh[0]
                and plan.kills_fired < plan.kill_submesh[1]
                and _submesh_matches(plan.kill_submesh[2])):
            plan.kills_fired += 1
            _record(point, "kill_submesh", segment=segment,
                    fired=plan.kills_fired, budget=plan.kill_submesh[1],
                    submesh=_ambient_submesh())
            raise InjectedKill(
                f"injected submesh kill at segment {segment} "
                f"({plan.kills_fired}/{plan.kill_submesh[1]})")
        if (plan.oom_segment is not None
                and segment == plan.oom_segment[0]
                and plan.ooms_fired < plan.oom_segment[1]
                and _submesh_matches(plan.oom_segment[2])):
            plan.ooms_fired += 1
            _record(point, "oom_segment", segment=segment,
                    fired=plan.ooms_fired, budget=plan.oom_segment[1],
                    submesh=_ambient_submesh())
            raise InjectedOOM(
                f"RESOURCE_EXHAUSTED: injected device OOM at segment "
                f"{segment} ({plan.ooms_fired}/{plan.oom_segment[1]})")
        if (plan.sigterm_server is not None
                and segment == plan.sigterm_server[0]
                and plan.sigterms_fired < plan.sigterm_server[1]
                and _submesh_matches(plan.sigterm_server[2])):
            plan.sigterms_fired += 1
            _record(point, "sigterm_server", segment=segment,
                    submesh=_ambient_submesh())
            # our own pid: the graceful-drain drill — the serve entry's
            # handler stops admission, preempts at segment boundaries,
            # drains the writers and exits 0 (a process without that
            # handler just terminates, the default SIGTERM disposition)
            import signal
            os.kill(os.getpid(), signal.SIGTERM)
        if (plan.kill_server is not None
                and segment == plan.kill_server[0]
                and plan.kill_server[1] > 0
                and _submesh_matches(plan.kill_server[2])):
            # budget > 0 honored like the sibling drills (a fired kill
            # needs no counter: the process does not survive it)
            # the line-buffered recorder gets the record out before the
            # exit below skips every flush
            _record(point, "kill_server", segment=segment,
                    submesh=_ambient_submesh())
            # a hard host death runs no exit handlers and flushes no
            # buffers; firing BEFORE the segment dispatches keeps the
            # death checkpoint-exact (segment k never ran), and the
            # request ledger + restart replay is the recovery the
            # drill exists to prove
            os._exit(KILL_EXIT_CODE)
    elif point == "post_checkpoint":
        if (plan.corrupt_checkpoint is not None
                and segment == plan.corrupt_checkpoint
                and path is not None and os.path.exists(path)):
            _record(point, "corrupt_checkpoint", segment=segment,
                    path=str(path))
            corrupt_file(path)
    elif point == "post_segment":
        if (plan.kill_after_segment is not None
                and segment == plan.kill_after_segment):
            # the flight-recorder sink is line-buffered, so the record
            # reaches the OS before the exit below skips every flush
            _record(point, "kill_after_segment", segment=segment)
            # a preemption does not run exit handlers or flush buffers;
            # os._exit is the honest simulation
            os._exit(KILL_EXIT_CODE)
    elif point == "host_fetch":
        if plan.fetch_failures_fired < plan.fail_host_fetch:
            plan.fetch_failures_fired += 1
            _record(point, "fail_host_fetch",
                    fired=plan.fetch_failures_fired,
                    budget=plan.fail_host_fetch)
            raise InjectedFault(
                f"injected host-fetch failure "
                f"{plan.fetch_failures_fired}/{plan.fail_host_fetch}")


def _record(point: str, fault: str, **attrs) -> None:
    """Flight-record an injection that actually FIRED (armed-but-idle
    points stay silent): a `fault.injected` event plus the
    `tts_faults_injected_total{point,fault}` counter, so a resilience
    drill's timeline shows the cause next to the recovery it tests."""
    from ..obs import metrics, tracelog
    tracelog.event("fault.injected", point=point, fault=fault, **attrs)
    metrics.default().counter(
        "tts_faults_injected_total",
        "deterministic fault injections that fired").inc(point=point,
                                                         fault=fault)
