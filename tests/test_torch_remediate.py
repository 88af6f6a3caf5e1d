"""The port's remediation controller against the JAX package's.

A stub server, a stub health monitor and one pinned clock (both
`remediate` modules' `time` patched to it) drive both packages'
`RemediationController` through the same scenario, drawn from a numpy
seed: dispatch failures of several requests across the submeshes
(`on_dispatch_failure`: the requeue or dead-letter verdict, exclusions
and quarantines), alert transitions fed through the monitor's listener
(observe mode) or executed by `handle` (act mode: `preempt_requeue`,
`shed_memory` and its reversal, `pause_admission` and `resume_admission`,
`quarantine_checkpoint`) and the per-rule rate valve. The verdicts, the
journal (its timestamps from the pinned clock), `snapshot()`, the calls
the stub server received, the ladder's memory-pressure hint and the
`tts_remediations_total`, `tts_quarantined_submeshes` and
`tts_admission_paused` series are equal. No canary comes due (the clock
stays inside the probe cooldown). Exact."""

import json

import numpy as np
import pytest

from tpu_tree_search.engine import ladder as jladder
from tpu_tree_search.obs import metrics as jmetrics
from tpu_tree_search.service import remediate as jrem
from tpu_tree_search_torch.engine import ladder as tladder
from tpu_tree_search_torch.obs import metrics as tmetrics
from tpu_tree_search_torch.service import remediate as trem

import _torch_isolation

PKGS = (("jax", jrem, jmetrics, jladder), ("torch", trem, tmetrics, tladder))
N_SLOTS = 4


@pytest.fixture(autouse=True)
def iso():
    with _torch_isolation.isolated():
        yield


class Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now

    def time(self) -> float:
        return 1.7e9 + self.now


class Slot:
    def __init__(self, index):
        self.index = index
        self.quarantined = False
        self.quarantined_since = None
        self.quarantine_reason = None


class Rec:
    def __init__(self, rid):
        self.id = rid
        self.failure_log = []
        self.excluded_submeshes = set()


class Monitor:
    def __init__(self):
        self.listeners = []

    def add_listener(self, fn):
        self.listeners.append(fn)

    def alerts_snapshot(self):
        return {"alerts": []}


class Server:
    """What the controller calls, each call logged."""

    def __init__(self, clock):
        self.clock = clock
        self.health = Monitor()
        self.slots = [Slot(i) for i in range(N_SLOTS)]
        self.calls = []
        self.paused = None
        self.running = {}              # rid -> submesh

    def admission_paused(self):
        return self.paused

    def pause_admission(self, reason):
        self.calls.append(("pause", reason))
        self.paused = reason

    def resume_admission(self):
        self.calls.append(("resume",))
        self.paused = None

    def add_exclusion(self, rec, submesh):
        rec.excluded_submeshes.add(int(submesh))
        if len(rec.excluded_submeshes) >= len(self.slots):
            rec.excluded_submeshes = {int(submesh)}
        self.calls.append(("exclude", rec.id, sorted(rec.excluded_submeshes)))

    def quarantine_submesh(self, index, reason):
        s = self.slots[index]
        s.quarantined, s.quarantine_reason = True, reason
        s.quarantined_since = self.clock.time()
        self.calls.append(("quarantine", index, reason))

    def readmit_submesh(self, index):
        self.slots[index].quarantined = False
        self.calls.append(("readmit", index))

    def remediate_preempt(self, rid, exclude_submesh=True,
                          expected_submesh=None):
        sm = self.running.get(rid)
        self.calls.append(("preempt", rid, exclude_submesh,
                           expected_submesh))
        if sm is None or (expected_submesh is not None
                          and sm != expected_submesh):
            return False, None
        del self.running[rid]
        return True, (sm if exclude_submesh else None)

    def lowest_priority_running(self):
        return min(self.running) if self.running else None


def scenario(seed: int) -> list:
    """Steps: ("fail", rid, submesh), ("alert", rule, transition, detail)
    and ("tick", seconds)."""
    rng = np.random.default_rng(seed)
    steps = []
    for k in range(40):
        r = rng.random()
        if r < 0.5:
            steps.append(("fail", f"req-{int(rng.integers(0, 5)):04d}",
                          int(rng.integers(0, N_SLOTS))))
        elif r < 0.85:
            rule = str(rng.choice(["stall", "mem_headroom",
                                   "compile_storm", "audit", "queue_wait"]))
            tr = str(rng.choice(["firing", "resolved", "pending"]))
            rid = f"req-{int(rng.integers(0, 5)):04d}"
            detail = {"request_id": rid,
                      "submesh": int(rng.integers(0, N_SLOTS)),
                      "compiles_in_interval": int(rng.integers(0, 9))}
            if rule == "audit":
                detail = {"invariant": str(rng.choice(
                    ["checkpoint_roundtrip", "node_conservation"])),
                    "detail": {"path": f"/nonexistent/{k}.npz"}}
            steps.append(("alert", rule, tr, detail))
        else:
            steps.append(("tick", float(rng.integers(1, 400))))
    return steps


def run(pkg, seed: int, enabled: bool, monkeypatch):
    name, rem, met, lad = pkg
    clock = Clock()
    monkeypatch.setattr(rem, "time", clock)
    srv = Server(clock)
    srv.running = {f"req-{i:04d}": i % N_SLOTS for i in range(5)}
    reg = met.Registry("tts_service")
    ctl = rem.RemediationController(srv, enabled=enabled, registry=reg,
                                    window_s=300.0, max_per_rule=2,
                                    quarantine_fails=2,
                                    deadletter_submeshes=3, probe_s=1e9)
    recs = {}
    verdicts = []
    try:
        for step in scenario(seed):
            if step[0] == "fail":
                _, rid, sm = step
                rec = recs.setdefault(rid, Rec(rid))
                rec.failure_log.append({"t": clock.time(), "submesh": sm,
                                        "attempt": len(rec.failure_log) + 1,
                                        "error": "transient: boom"})
                verdicts.append(ctl.on_dispatch_failure(rec, sm, "boom"))
            elif step[0] == "alert":
                _, rule, tr, detail = step
                alert = {"rule": rule, "detail": detail}
                if enabled:
                    action = jrem.POLICY.get(rule)
                    if tr == "resolved":
                        action = {"pause_admission": "resume_admission",
                                  "shed_memory": "clear_memory_pressure"
                                  }.get(action)
                    elif tr != "firing":
                        action = None
                    if action is not None:
                        verdicts.append(ctl.handle(rule, action, alert))
                else:
                    for fn in srv.health.listeners:
                        fn(rule, tr, alert)
            else:
                clock.now += step[1]
        snap = ctl.snapshot()
        journal = list(ctl.journal)
        pressure = lad.memory_pressure()
    finally:
        ctl.close()
    return json.loads(json.dumps({
        "verdicts": verdicts, "journal": journal, "snapshot": snap,
        "calls": srv.calls, "pressure": pressure,
        "excluded": {r: sorted(v.excluded_submeshes)
                     for r, v in recs.items()},
        "metrics": {k: v for k, v in reg.to_json().items()
                    if k in ("tts_remediations_total",
                             "tts_quarantined_submeshes",
                             "tts_admission_paused")}}))


@pytest.mark.parametrize("enabled", [False, True], ids=["observe", "act"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_verdicts_journal_and_actions(seed, enabled, monkeypatch):
    got = {pkg[0]: run(pkg, seed, enabled, monkeypatch) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    assert got["torch"]["journal"], "the scenario journaled nothing"
    if not enabled:
        assert not [c for c in got["torch"]["calls"]
                    if c[0] != "preempt"]


def test_policy_table_and_defaults_as_jax(monkeypatch):
    assert trem.POLICY == jrem.POLICY
    for k, v in (("TTS_REMEDIATE_WINDOW_S", "12"),
                 ("TTS_REMEDIATE_MAX_PER_RULE", "7"),
                 ("TTS_REMEDIATE_QUARANTINE_FAILS", "5"),
                 ("TTS_REMEDIATE_DEADLETTER_SUBMESHES", "2"),
                 ("TTS_REMEDIATE_PROBE_S", "9")):
        monkeypatch.setenv(k, v)
    ctls = [rem.RemediationController(Server(Clock()),
                                      registry=met.Registry("tts_service"))
            for _, rem, met, _ in PKGS]
    try:
        assert [(c.enabled, c.window_s, c.max_per_rule, c.quarantine_fails,
                 c.deadletter_submeshes, c.probe_s) for c in ctls] == [
            (False, 12.0, 7, 5, 2, 9.0)] * 2
    finally:
        for c in ctls:
            c.close()
