"""The port's health rules and monitor against the JAX package's.

Identical registries, a stub server and a stub store drive both
packages' `HealthMonitor(interval_s=0)` through the same scenario (values
drawn from a numpy seed, `time.time` of both health modules patched to
one clock), and every rule of the default family (all thirteen: the
capacity and progress knobs on) goes pending, firing and resolved with
the same details: the listeners' transitions, `alerts_snapshot`, the
`alert.*` events, the `tts_alerts*` and `tts_slo_burn_rate` series and
the history rings are equal, the wall-clock fields left out. No daemon
thread runs. `Thresholds.from_env` and `for_tenant` agree under the same
environment, the rule list follows TTS_CAPACITY and TTS_PROGRESS alike,
and `seed_history` refills the rings alike."""

import dataclasses
import json

import numpy as np
import pytest

from tpu_tree_search.obs import audit as jaudit
from tpu_tree_search.obs import health as jhealth
from tpu_tree_search.obs import metrics as jmetrics
from tpu_tree_search.obs import tracelog as jtracelog
from tpu_tree_search_torch.obs import audit as taudit
from tpu_tree_search_torch.obs import health as thealth
from tpu_tree_search_torch.obs import metrics as tmetrics
from tpu_tree_search_torch.obs import tracelog as ttracelog

import _torch_isolation

PKGS = (("jax", jhealth, jmetrics, jtracelog, jaudit),
        ("torch", thealth, tmetrics, ttracelog, taudit))
WALL = ("since_unix", "firing_since_unix", "resolved_unix")
RULES = ["queue_wait", "stall", "pruning_collapse", "mem_headroom",
         "compile_storm", "audit", "perf", "peer_down", "slo_error_burn",
         "slo_latency_burn", "saturation", "deadline_risk",
         "slo_latency_risk"]


@pytest.fixture(autouse=True)
def iso(monkeypatch):
    for k in ("TTS_CAPACITY", "TTS_PROGRESS"):
        monkeypatch.delenv(k, raising=False)
    with _torch_isolation.isolated():
        jaudit.clear_findings()
        taudit.clear_findings()
        yield


class Clock:
    def __init__(self, now: float):
        self.now = now

    def time(self) -> float:
        return self.now


class Slot:
    def __init__(self, record):
        self.record = record


class Cache:
    def __init__(self):
        self.compiles = 0

    def storm_signal(self) -> int:
        return self.compiles


class Aot:
    hits = 3


class Store:
    """The durable store's terminal history (wall_t, state, spent_s,
    tenant)."""

    def __init__(self):
        self.rows = []

    def terminal_history(self, since_s=None):
        return [r for r in self.rows if since_s is None or r[0] >= since_s]


class Server:
    """What the rules read of a server: its registry, snapshot, heartbeat
    ages, executor cache, AOT cache, queue and slots."""

    def __init__(self, registry):
        self.metrics = registry
        self.cache = Cache()
        self.aot = Aot()
        self.queue = []
        self.slots = [Slot(None), Slot(None)]
        self.ages = {}
        self.snap = {"requests": {}}

    def heartbeat_ages(self):
        return dict(self.ages)

    def status_snapshot(self):
        return json.loads(json.dumps(self.snap))


def scenario(seed: int, perf_path) -> list:
    """The steps: (seconds to advance, what to set) from a numpy seed."""
    rng = np.random.default_rng(seed)
    r = lambda lo, hi: float(rng.uniform(lo, hi))  # noqa: E731
    hot = {
        "waits": [r(61, 500) for _ in range(int(rng.integers(3, 9)))],
        "ages": {"r1": r(31, 200), "r2": r(1, 20)},
        "prune": (r(0, 0.0004), r(1e5, 1e7)),
        "mem": (r(0.93, 0.99), 80 << 30),
        "compiles": int(rng.integers(6, 40)),
        "audit": True, "perf": {"verdict": "FAIL", "round": 7, "n_fail": 2,
                                "reasons": ["a", "b", "c", "d", "e"]},
        "peers": [{"dir": "/p1", "owner": "h1", "epoch": 3, "age_s": r(9, 99),
                   "ttl_s": 5.0, "expired": True, "released": False},
                  {"dir": "/p2", "expired": True, "released": True}],
        "terminals": int(rng.integers(20, 60)),
        "rho": r(0.9, 3.0),
        "eta": r(60, 600),
    }
    return [
        (1.0, {}),                          # quiet: baselines
        (2.0, hot),                         # everything active
        (3.0, dict(hot, waits=[r(61, 500)])),
        (7.0, dict(hot, waits=[])),         # saturation's dwell passes
        (4000.0, {}),                       # everything clears; the
                                            # terminals leave the windows
        (1.0, {"rho": r(0.9, 3.0)}),        # a pending that clears...
        (1.0, {}),                          # ...is not an incident
    ]


def apply(step: dict, srv: Server, store: Store, reg, audit_mod, clock,
          perf_path, state: dict) -> None:
    h = reg.histogram("tts_queue_wait_seconds", "wait")
    for w in step.get("waits", []):
        h.observe(w, tenant="acme")
    srv.ages = step.get("ages", {})
    srv.queue = [0] * len(step.get("waits", []))
    srv.slots[0].record = object() if srv.ages else None
    reqs = {}
    if srv.ages:
        reqs["r1"] = {"state": "RUNNING", "dispatch_heartbeats": [1],
                      "submesh": 1, "tenant": "acme", "spent_s": 40.0,
                      "deadline_s": 50.0,
                      "progress": {"estimate": {"eta_s": step["eta"],
                                                "progress_ratio": 0.25}}}
        reqs["r2"] = {"state": "RUNNING", "progress": {}, "tenant": "-",
                      "spent_s": 1.0}
    rate, popped = step.get("prune", (0.5, 10.0))
    reg.gauge("tts_search_pruning_rate", "p").set(rate, request="r1")
    reg.gauge("tts_search_popped", "n").set(popped, request="r1")
    frac, limit = step.get("mem", (0.1, 80 << 30))
    reg.gauge("tts_device_bytes_in_use", "u").set(
        int(frac * limit), device="0", platform="gpu")
    reg.gauge("tts_device_bytes_limit", "l").set(
        limit, device="0", platform="gpu")
    srv.cache.compiles += step.get("compiles", 0)
    if step.get("audit"):
        audit_mod.record("node_conservation", False, tree=5, want=6)
    else:
        audit_mod.clear_findings()
    perf_path.write_text(json.dumps(step.get("perf", {"verdict": "PASS"})))
    snap = {"requests": reqs,
            "failover": {"mode": "observe", "takeovers": 0,
                         "peers": step.get("peers", [])}}
    if "rho" in step:
        snap["capacity"] = {
            "utilization": step["rho"], "arrival_per_s": 2.5,
            "healthy_lanes": 2, "predicted_wait_s": 4.25,
            "classes": [{"shape": "20x20", "tenant": "acme",
                         "utilization": step["rho"]},
                        {"shape": "20x5", "tenant": "-",
                         "utilization": 0.1}],
            "lanes_detail": [{"utilization": 0.5}, {"utilization": 0.25}]}
    srv.snap = snap
    for i in range(step.get("terminals", 0)):
        state["n"] += 1
        store.rows.append((clock.now - 1.0 - i * 0.01,
                           "FAILED" if i % 2 else "DONE",
                           30.0 if i % 3 else 2.0, "acme" if i % 4 else "-"))


def strip(alert: dict) -> dict:
    return {k: v for k, v in alert.items() if k not in WALL}


def run(name, health, met, log, audit_mod, seed, tmp_path, monkeypatch):
    clock = Clock(1_700_000_000.0)
    monkeypatch.setattr(health, "time", clock)
    perf = tmp_path / "perf.json"      # one path: the detail names it
    reg = met.Registry("tts")
    srv, store = Server(reg), Store()
    th = health.Thresholds(
        slo_latency_target_s=10.0, perf_json=str(perf),
        tenant_overrides={"acme": {"slo_latency_target_s": 5.0,
                                   "slo_error_budget": 0.2,
                                   "no_such_field": 1}})
    mon = health.HealthMonitor(server=srv, registry=reg, thresholds=th,
                               interval_s=0, store=store)
    assert mon._thread is None
    seen = []
    mon.add_listener(lambda rule, tr, a: seen.append((rule, tr, strip(a))))
    out = []
    state = {"n": 0}
    for dt, step in scenario(seed, perf):
        clock.now += dt
        apply(step, srv, store, reg, audit_mod, clock, perf, state)
        snap = mon.evaluate_now()
        out.append({**{k: v for k, v in snap.items()
                       if k not in ("t", "alerts")},
                    "alerts": [strip(a) for a in snap["alerts"]],
                    "firing": [a.rule for a in mon.firing()]})
    events = [{k: v for k, v in r.items() if k not in ("ts", "seq",
                                                       "thread")}
              for r in log.get().records()
              if r.get("name", "").startswith("alert.")]
    metrics = {k: v for k, v in reg.to_json().items()
               if k.startswith(("tts_alerts", "tts_slo_burn",
                                "tts_health"))}
    rings = {k: list(v) for k, v in mon.history.items()}
    last = mon.history_sample()
    mon.close()
    closed = {m.name: m.samples() for m in reg.metrics()
              if m.name in ("tts_alerts", "tts_slo_burn_rate")}
    return out, seen, events, metrics, rings, last, closed


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_every_rule_same_transitions_and_details(seed, tmp_path,
                                                 monkeypatch):
    got = {}
    for name, health, met, log, audit_mod in PKGS:
        got[name] = run(name, health, met, log, audit_mod, seed, tmp_path,
                        monkeypatch)
    j, t = got["jax"], got["torch"]
    for a, b in zip(t, j):
        assert a == b
    out, seen = j[0], j[1]
    assert [r["name"] for r in out[0]["rules"]] == RULES
    fired = {rule for rule, tr, _ in seen if tr == "firing"}
    assert fired == set(RULES)
    resolved = {rule for rule, tr, _ in seen if tr == "resolved"}
    assert resolved == set(RULES)
    assert out[-1]["firing"] == [] and out[-2]["firing"] == []
    # close retires the alert and burn series
    assert j[6] == {"tts_alerts": [], "tts_slo_burn_rate": []}


def test_thresholds_from_env_agree(monkeypatch):
    env = {"TTS_HEALTH_QUEUE_WAIT_P99_S": "12.5", "TTS_HEALTH_STALL_S": "9",
           "TTS_HEALTH_MEM_FRAC": "0.5", "TTS_HEALTH_COMPILE_STORM": "x",
           "TTS_HEALTH_PERF_JSON": "/tmp/v.json",
           "TTS_HEALTH_SATURATION_FOR_S": "1.5",
           "TTS_SLO_ERROR_BUDGET": "0.02", "TTS_SLO_BURN_FAST_S": "60",
           "TTS_HEALTH_TENANT_OVERRIDES": json.dumps(
               {"acme": {"stall_s": 3, "bogus": 1}, "beta": 5})}
    for setting in ({}, env, {"TTS_HEALTH_TENANT_OVERRIDES": "{not json"}):
        for k in env:
            monkeypatch.delenv(k, raising=False)
        for k, v in setting.items():
            monkeypatch.setenv(k, v)
        j, t = jhealth.Thresholds.from_env(), thealth.Thresholds.from_env()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for tenant in ("acme", "beta", None, "-"):
            assert dataclasses.asdict(t.for_tenant(tenant)) == \
                dataclasses.asdict(j.for_tenant(tenant))
    assert thealth.Thresholds().stall_s == 30.0


@pytest.mark.parametrize("capacity,progress", [("0", "0"), ("1", "0"),
                                               ("0", "1"), ("1", "1")])
def test_rule_list_follows_the_knobs(monkeypatch, capacity, progress):
    monkeypatch.setenv("TTS_CAPACITY", capacity)
    monkeypatch.setenv("TTS_PROGRESS", progress)
    names = [[(r.name, r.severity, r.for_s, r.description)
              for r in h.default_rules(h.Thresholds())]
             for h in (jhealth, thealth)]
    assert names[1] == names[0]
    assert len(names[0]) == 10 + int(capacity) + 2 * int(progress)


def test_seed_history_and_broken_rules_alike(monkeypatch):
    """Replayed store samples refill the rings alike; a rule that raises
    and a listener that raises are recorded as events, never a crash."""
    samples = [{"t": 100.0 + i, "history": {"queue_depth": i,
                                            "alerts_firing": i % 2,
                                            "gone": None}}
               for i in range(400)] + [{"t": 5.0}, {"history": {}}]
    out = []
    for name, health, met, log, audit_mod in PKGS:
        monkeypatch.setattr(health, "time", Clock(2000.0))

        def broken(ctx):
            raise ValueError("rule bug")

        mon = health.HealthMonitor(
            registry=met.Registry("tts"), interval_s=0,
            rules=[health.Rule("broken", broken),
                   health.Rule("on", lambda ctx: (True, {"x": 1}))])
        n = mon.seed_history(samples)
        mon.add_listener(lambda *a: 1 / 0)
        snap = mon.evaluate_now()
        ev = [{k: v for k, v in r.items() if k not in ("ts", "seq",
                                                       "thread")}
              for r in log.get().records()]
        out.append((n, {k: list(v) for k, v in mon.history.items()},
                    {k: v for k, v in snap.items() if k != "t"}, ev))
        mon.close()
    assert out[1] == out[0]
    assert out[0][0] == 800
    assert len(out[0][1]["queue_depth"]) == jhealth.HealthMonitor.HISTORY
    names = [e["name"] for e in out[0][3]]
    assert "alert.rule_error" in names and "alert.listener_error" in names
