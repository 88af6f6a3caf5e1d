"""The port's lane ledger and capacity model against the JAX package's.

The same events with explicit `now` (lane transitions, seeds and flushes;
admissions, rate seeds, progress, terminals and queue waits, all drawn
from a numpy seed) give equal `snapshot`, `conservation_errors`,
`lane.state` events and published series in both packages; `close`
retires the same series."""

import numpy as np
import pytest

from tpu_tree_search.obs import capacity as jcap
from tpu_tree_search.obs import metrics as jmetrics
from tpu_tree_search.obs import tracelog as jtracelog
from tpu_tree_search_torch.obs import capacity as tcap
from tpu_tree_search_torch.obs import metrics as tmetrics
from tpu_tree_search_torch.obs import tracelog as ttracelog

import _torch_isolation

PKGS = ((jcap, jmetrics, jtracelog), (tcap, tmetrics, ttracelog))
DROP = ("ts", "seq", "thread")


@pytest.fixture(autouse=True)
def iso():
    with _torch_isolation.isolated():
        yield


def lane_events(log) -> list:
    return [{k: v for k, v in r.items() if k not in DROP}
            for r in log.get().records() if r.get("name") == "lane.state"]


def drive_ledger(cap, met, seed: int):
    rng = np.random.default_rng(seed)
    reg = met.Registry("tts")
    lanes = list(range(int(rng.integers(1, 5))))
    led = cap.LaneLedger(reg, lanes, now=100.0)
    now = 100.0
    snaps = []
    for i in range(40):
        now += float(rng.random() * 3)
        op = int(rng.integers(0, 10))
        lane = int(rng.integers(0, len(lanes)))
        if op < 7:
            led.transition(lane, cap.LANE_STATES[int(rng.integers(
                0, len(cap.LANE_STATES)))], now=now)
        elif op == 7:
            led.seed(lane, "executing", float(rng.random() * 50))
        elif op == 8:
            led.flush(now=now)
        else:
            snaps.append((led.snapshot(now=now),
                          led.conservation_errors(now=now),
                          led.state_of(lane)))
    snaps.append((led.snapshot(now=now + 1), led.conservation_errors(
        now=now + 1), reg.to_json()))
    return snaps


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lane_ledger_matches_jax(seed):
    got = []
    for cap, met, log in PKGS:
        got.append((drive_ledger(cap, met, seed), lane_events(log)))
    assert got[1] == got[0]
    assert got[0][1], "the script should change lanes"
    last = got[0][0][-1][1]
    assert all(e < 1e-9 for e in last.values())


def drive_model(cap, met, seed: int):
    rng = np.random.default_rng(seed)
    reg = met.Registry("tts")
    model = cap.CapacityModel(reg, window_s=float(rng.integers(5, 60)),
                              ewma=float(rng.random()), now=0.0)
    shapes = ["20x20/lb2", "50x10/lb1", "20x5/lb2"]
    tenants = ["-", "acme", "beta"]
    now = 0.0
    docs = []
    for i in range(60):
        now += float(rng.random() * 2)
        op = int(rng.integers(0, 7))
        shape = shapes[int(rng.integers(0, 3))]
        tenant = tenants[int(rng.integers(0, 3))]
        if op == 0:
            model.on_admit(shape, tenant, now=now)
        elif op == 1:
            model.seed_rate(shape, float(rng.integers(0, 3)) * 1e6)
        elif op == 2:
            model.on_progress(shape, float(rng.random() * 2e8))
        elif op == 3:
            model.on_terminal(shape, int(rng.integers(0, 1 << 30)),
                              service_s=float(rng.random() * 9))
        elif op == 4:
            model.on_queue_wait(tenant, float(rng.random() * 4 - 0.5))
        else:
            lanes = int(rng.integers(1, 5))
            docs.append(model.snapshot(
                healthy_lanes=int(rng.integers(0, lanes + 1)),
                total_lanes=lanes, total_devices=8, now=now))
    docs.append(reg.to_json())
    model.close()
    docs.append(reg.to_json())
    return docs


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_capacity_model_matches_jax(seed):
    j = drive_model(jcap, jmetrics, seed)
    t = drive_model(tcap, tmetrics, seed)
    assert t == j
    assert any(d.get("utilization") is not None for d in j[:-2])
    assert any(d.get("what_if") for d in j[:-2])


def test_constants_match_jax():
    assert tcap.LANE_STATES == jcap.LANE_STATES
    assert (tcap.LANE_SECONDS_METRIC, tcap.LANE_SECONDS_DOC) == (
        jcap.LANE_SECONDS_METRIC, jcap.LANE_SECONDS_DOC)


def test_defaults_come_from_the_same_knobs(monkeypatch):
    """Window and EWMA from TTS_CAPACITY_WINDOW_S / TTS_CAPACITY_EWMA, and
    the registered defaults without them."""
    for env in ({}, {"TTS_CAPACITY_WINDOW_S": "42",
                     "TTS_CAPACITY_EWMA": "0.7"}):
        for k in ("TTS_CAPACITY_WINDOW_S", "TTS_CAPACITY_EWMA"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        j = jcap.CapacityModel(jmetrics.Registry("tts"), now=0.0)
        t = tcap.CapacityModel(tmetrics.Registry("tts"), now=0.0)
        assert (t.window_s, t.ewma) == (j.window_s, j.ewma)
