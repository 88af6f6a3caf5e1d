"""The port's resource sampler and device introspection against the JAX
package's.

The sampler publishes JAX's gauges (names, help strings, `device` and
`platform` labels) and `resource.sample` events with JAX's fields; the CPU
record of `utils/device_info` has the keys of JAX's CPU record and grows
with what the process holds; `print_device_info` prints JAX's line;
`distributed.search` on the CPU emits one `resource.sample` a segment, as
JAX's does for the same search, with the same counts, and a sample that
raises never stops it; the daemon thread runs only for `period_s > 0`.
The H100 rates of `chip_smoke.py`'s bounds live in `utils/device_info`.

Each test reads only what the samplers it started recorded: the events of
its own thread (or its daemon's registry), and the one-shot gauges as the
process's count of running daemons says they are published. A sampler an
earlier test file left running in the same process (a server that was
never closed) then changes nothing here."""

import contextlib
import io
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.obs import metrics as jmetrics
from tpu_tree_search.obs import resource as jresource
from tpu_tree_search.obs import tracelog as jtracelog
from tpu_tree_search.parallel.mesh import worker_mesh
from tpu_tree_search.utils import device_info as jdi
from tpu_tree_search_torch.engine import distributed as tdist
from tpu_tree_search_torch.obs import metrics as tmetrics
from tpu_tree_search_torch.obs import resource as tresource
from tpu_tree_search_torch.obs import tracelog as ttracelog
from tpu_tree_search_torch.problems.pfsp import PFSPInstance
from tpu_tree_search_torch.utils import device_info as tdi

import _torch_isolation
import _torch_threads

_torch_threads.share_cores()

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def iso():
    with _torch_isolation.isolated():
        yield


def gauges(reg) -> dict:
    """name -> (help, sorted label keys of every series)."""
    return {m.name: (m.help, sorted({k for _, key, _ in m.samples()
                                     for k, _ in key}))
            for m in reg.metrics()}


def series(reg, name: str) -> list:
    """(labels, value) of every series of metric `name` in `reg`."""
    return [(dict(k), v) for m in reg.metrics() if m.name == name
            for _, k, v in m.samples()]


def events(log, name: str) -> list:
    """The `name` events this test's thread recorded (a daemon left
    running by another test records on its own thread)."""
    here = threading.current_thread().name
    return [r for r in log.records()
            if r.get("name") == name and r.get("thread") == here]


def publishes(res) -> bool:
    """Whether a one-shot `sample_now` of package module `res` publishes
    gauges: only while no daemon sampler of that package runs in the
    process (a running daemon owns them)."""
    return res._ACTIVE_DAEMONS == 0


def test_gauges_help_labels_and_event_fields_are_jax():
    jreg, treg = jmetrics.Registry("tts"), tmetrics.Registry("tts")
    js = jresource.ResourceSampler(registry=jreg).sample()
    ts = tresource.ResourceSampler(registry=treg, platform="cpu").sample()
    assert tresource.GAUGES == jresource.GAUGES
    assert gauges(treg) == gauges(jreg)
    assert set(gauges(treg)) == set(tresource.GAUGES)
    # no limit series on the CPU, as in JAX
    assert {m.name for m in treg.metrics() if m.samples()} == set(
        tresource.GAUGES) - {"tts_device_bytes_limit"}
    assert set(ts) == set(js) == {"host_rss_bytes", "devices"}
    assert [set(d) for d in ts["devices"]] == [set(js["devices"][0])]
    assert ts["devices"][0]["platform"] == js["devices"][0]["platform"] \
        == "cpu"
    jev = events(jtracelog.get(), "resource.sample")
    tev = events(ttracelog.get(), "resource.sample")
    assert len(jev) == len(tev) == 1
    drop = {"ts", "seq", "thread"}
    assert set(tev[0]) - drop == set(jev[0]) - drop
    assert series(treg, "tts_device_bytes_in_use") == [
        ({"device": "0", "platform": "cpu"}, ts["devices"][0]["bytes_in_use"])]


def test_cpu_record_keys_and_growth():
    """Both CPU records carry `id`, `platform` and `bytes_in_use`, which
    grow by at least the bytes of a freshly written array (JAX: its live
    arrays; the port: the resident set)."""
    jrec, trec = jdi.memory_snapshot()[0], tdi.memory_snapshot("cpu")[0]
    assert set(trec) == set(jrec) == {"id", "platform", "bytes_in_use"}
    assert (trec["id"], trec["platform"]) == (0, "cpu")
    assert set(tdi.describe_devices("cpu")[0]) == set(
        jdi.describe_devices()[0])
    n = 64 << 20
    vals = np.random.default_rng(0).integers(0, 255, n, dtype=np.uint8)
    import jax.numpy as jnp
    j0, t0 = (jdi.memory_snapshot()[0]["bytes_in_use"],
              tdi.memory_snapshot("cpu")[0]["bytes_in_use"])
    held_j = jnp.asarray(vals)
    held_t = torch.from_numpy(vals.copy())
    held_t.add_(1)
    assert jdi.memory_snapshot()[0]["bytes_in_use"] - j0 >= n
    assert tdi.memory_snapshot("cpu")[0]["bytes_in_use"] - t0 >= n
    del held_j, held_t


def fake_card(monkeypatch, in_use: int, peak: int, total: int):
    class Props:
        name = "NVIDIA H100 80GB HBM3"
        total_memory = total

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": in_use,
        "allocated_bytes.all.peak": peak})


def test_card_record_and_devices_line_match_jax(monkeypatch):
    """On a card (its `torch.cuda` answers faked): the record reads the
    allocator's current and peak and the card's total memory, and the
    `devices` line is the one JAX prints for the same record."""
    fake_card(monkeypatch, 3 << 30, 5 << 30, 85_029_158_912)
    assert tdi.memory_snapshot() == [{
        "id": 0, "platform": "gpu", "bytes_in_use": 3 << 30,
        "peak_bytes_in_use": 5 << 30, "bytes_limit": 85_029_158_912}]
    recs = tdi.describe_devices()
    monkeypatch.setattr(jdi, "describe_devices", lambda: recs)
    out = []
    for fn in (jdi.print_device_info, tdi.print_device_info):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn()
        out.append(buf.getvalue())
    assert out[1] == out[0] == ("Device 0: gpu (NVIDIA H100 80GB HBM3) "
                                "process 0, HBM 3.00/79.19 GiB\n")
    reg = tmetrics.Registry("tts")
    tresource.ResourceSampler(registry=reg).sample()
    assert series(reg, "tts_device_bytes_limit") == [
        ({"device": "0", "platform": "gpu"}, 85_029_158_912)]


def test_platform_picks_the_backend_on_a_card_host(monkeypatch):
    """With a card visible, `platform="cpu"` (a search on CPU workers)
    reads the CPU, not the idle card; None and "gpu" read the card."""
    fake_card(monkeypatch, 3 << 30, 5 << 30, 85_029_158_912)
    assert [d["platform"] for d in tdi.memory_snapshot()] == ["gpu"]
    assert [d["platform"] for d in tdi.memory_snapshot("gpu")] == ["gpu"]
    cpu = tdi.memory_snapshot("cpu")
    assert [(d["id"], d["platform"]) for d in cpu] == [(0, "cpu")]
    assert cpu[0]["bytes_in_use"] > 0
    assert tdi.describe_devices("cpu")[0]["platform"] == "cpu"
    reg = tmetrics.Registry("tts")
    tresource.sample_now(registry=reg, platform="cpu")
    assert [lb for lb, _ in series(reg, "tts_device_bytes_in_use")] == (
        [{"device": "0", "platform": "cpu"}] if publishes(tresource)
        else [])
    assert series(reg, "tts_device_bytes_limit") == []
    with pytest.raises(ValueError, match="platform"):
        tdi.memory_snapshot("tpu")


def test_card_errors_propagate(monkeypatch):
    fake_card(monkeypatch, 0, 0, 1)

    def broken(i):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(torch.cuda, "memory_stats", broken)
    with pytest.raises(RuntimeError, match="launch failure"):
        tdi.memory_snapshot()


def test_search_samples_once_a_segment_like_jax(monkeypatch):
    """The same segmented search on two CPU workers: one `resource.sample`
    a segment in each package, the port's gauges published, the counts
    equal; a sample that raises is swallowed and the counts stay."""
    table = PFSPInstance.synthetic(8, 3, 6).p_times
    kw = dict(lb_kind=1, chunk=8, capacity=1 << 12, min_seed=4,
              segment_iters=8)
    reps_j, reps_t = [], []
    res_j = jdist.search(table, mesh=worker_mesh(2), heartbeat=reps_j.append,
                         **kw)
    res_t = tdist.search(table, devices=["cpu"] * 2,
                         heartbeat=reps_t.append, **kw)
    assert (res_t.explored_tree, res_t.explored_sol, res_t.best) == (
        res_j.explored_tree, res_j.explored_sol, res_j.best)
    assert len(reps_t) == len(reps_j) > 2
    assert len(events(ttracelog.get(), "resource.sample")) == len(reps_t)
    assert len(events(jtracelog.get(), "resource.sample")) == len(reps_j)
    use = series(tmetrics.default(), "tts_device_bytes_in_use")
    if publishes(tresource):
        assert [lb for lb, _ in use] == [{"device": "0", "platform": "cpu"}]
        assert series(tmetrics.default(), "tts_host_rss_bytes")
    else:
        assert use == []

    # the heartbeat names its workers' backend, so a CPU-worker search on
    # a host with a card samples the CPU
    asked = []
    monkeypatch.setattr(tresource, "sample_now",
                        lambda **k: asked.append(k.get("platform")))
    tdist.search(table, devices=["cpu"] * 2, **kw)
    assert asked and set(asked) == {"cpu"}

    def broken(*a, **k):
        raise RuntimeError("sampler down")

    monkeypatch.setattr(tresource, "sample_now", broken)
    res_b = tdist.search(table, devices=["cpu"] * 2, **kw)
    assert (res_b.explored_tree, res_b.best) == (res_t.explored_tree,
                                                 res_t.best)


def test_daemon_thread_and_its_switch():
    """`period_s <= 0` starts no thread; a running daemon samples on its
    cadence and owns the gauges (a one-shot `sample_now` then records its
    event only, in both packages), and `close` retires its series and
    gives the gauges back to the one-shot sweeps (unless another daemon
    still runs in the process)."""
    for res, met in ((jresource, jmetrics), (tresource, tmetrics)):
        off = res.ResourceSampler(registry=met.Registry("tts"), period_s=0)
        assert off._thread is None
        others = res._ACTIVE_DAEMONS
        reg = met.Registry("tts")
        on = res.ResourceSampler(registry=reg, period_s=0.01)
        try:
            assert res._ACTIVE_DAEMONS == others + 1
            deadline = time.monotonic() + 10
            while not series(reg, "tts_host_rss_bytes"):
                assert time.monotonic() < deadline
                time.sleep(0.01)
            glob = met.Registry("tts")
            res.sample_now(registry=glob)
            assert [m for m in glob.metrics() if m.samples()] == []
        finally:
            on.close()
        assert res._ACTIVE_DAEMONS == others
        assert all(not m.samples() for m in reg.metrics())
        res.sample_now(registry=glob)
        assert bool(series(glob, "tts_host_rss_bytes")) == publishes(res)


def test_h100_rates_live_in_device_info():
    assert tdi.HBM_BYTES_PER_S == 3.35e12
    assert tdi.INT32_OPS_PER_S == 64 * 132 * 1.98e9
    assert tdi.FP32_OPS_PER_S == 128 * 132 * 1.98e9
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert "from tpu_tree_search_torch.utils.device_info import" in smoke
    for name in ("HBM_BYTES_PER_S", "INT32_OPS_PER_S", "FP32_OPS_PER_S"):
        assert f"\n{name} = " not in smoke
