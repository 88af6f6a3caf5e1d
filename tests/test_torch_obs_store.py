"""The port's durable observability store and metric-name table against
the JAX package's.

The same `append` and trace-event sequence (fields drawn from a numpy
seed, wall clock patched to one value in both modules, one record a
batch so rotation lands alike) gives segment files with identical bytes;
each package's `read_store` reads the other's directory; `resume_counters`
seeds the same series; a corrupted line is skipped by both readers and
cut, counted and quarantined alike by both stores' replays; retention
prunes the same segments. `metric_names.REGISTRY` is JAX's table."""

import dataclasses
import os
import shutil
import time

import numpy as np
import pytest

from tpu_tree_search.obs import metric_names as jnames
from tpu_tree_search.obs import metrics as jmetrics
from tpu_tree_search.obs import store as jstore
from tpu_tree_search_torch.obs import metric_names as tnames
from tpu_tree_search_torch.obs import metrics as tmetrics
from tpu_tree_search_torch.obs import store as tstore

import _torch_isolation

PKGS = (("jax", jstore, jmetrics), ("torch", tstore, tmetrics))


@pytest.fixture(autouse=True)
def iso():
    with _torch_isolation.isolated():
        yield


class Clock:
    """A wall clock the test sets (`time.time` of a store module)."""

    def __init__(self, now: float):
        self.now = now

    def time(self) -> float:
        return self.now

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, s: float) -> None:
        time.sleep(s)


def wait_written(store, n: int) -> None:
    deadline = time.monotonic() + 10
    while store.records < n:
        assert time.monotonic() < deadline, (store.records, n)
        time.sleep(0.002)


def script(seed: int) -> list:
    """A sequence of appends and trace events from a numpy seed: samples
    with counters and gauges, control-plane events the sink keeps and
    engine events it drops."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(int(rng.integers(9, 14))):
        kind = int(rng.integers(0, 3))
        if kind == 0:
            ops.append(("sample", {
                "counters": [["tts_requests_total",
                              {"state": "DONE", "tenant": "a"},
                              float(rng.integers(1, 50))],
                             ["tts_alerts_fired_total",
                              {"rule": "stall"}, float(rng.integers(0, 3))],
                             ["tts_segments_total", {},
                              float(rng.integers(1, 9))]],
                "gauges": [["tts_device_bytes_in_use",
                            {"device": "0", "platform": "gpu"},
                            float(rng.integers(1, 1 << 40))]],
                "history": {"queue_depth": int(rng.integers(0, 9))}}))
        elif kind == 1:
            name = ["request.done", "request.failed", "alert.firing",
                    "lane.state"][int(rng.integers(0, 4))]
            ops.append(("event", {
                "kind": "event", "name": name, "ts": float(i), "seq": i,
                "thread": "t", "spent_s": float(rng.random() * 9),
                "tenant": "ab"[int(rng.integers(0, 2))],
                "rows": [int(x) for x in rng.integers(0, 99, 3)],
                "skip": object()}))
        else:
            ops.append(("event", {"kind": "event", "name": "segment.done",
                                  "ts": float(i), "seq": i, "thread": "t"}))
    return ops


def run_store(mod, reg_mod, root, ops, monkeypatch, segment_records=3):
    clock = Clock(1000.0)
    monkeypatch.setattr(mod, "time", clock)
    reg = reg_mod.Registry("tts")
    st = mod.ObsStore(root, "host-a:1", registry=reg,
                      segment_records=segment_records, fsync=False)
    n = 1
    wait_written(st, n)
    for kind, fields in ops:
        clock.now += 0.25
        before = st.records
        if kind == "sample":
            st.append("sample", **fields)
        else:
            st.on_trace_event(fields)
        if kind == "sample" or fields["name"] != "segment.done":
            n += 1
        wait_written(st, n)
        assert st.records in (before, before + 1)
    st.close()
    return st, reg


def files(root) -> dict:
    return {p: (root / p).read_bytes() for p in sorted(os.listdir(root))}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_files_byte_identical(tmp_path, monkeypatch, seed):
    ops = script(seed)
    got = {}
    for name, mod, reg_mod in PKGS:
        root = tmp_path / name
        st, reg = run_store(mod, reg_mod, root, ops, monkeypatch)
        got[name] = (files(root), st.snapshot(), reg.to_json(),
                     st.terminal_history())
    j, t = got["jax"], got["torch"]
    assert len(j[0]) > 1, "the script should rotate"
    assert t[0] == j[0]
    snap_j = {k: v for k, v in j[1].items() if k != "dir"}
    snap_t = {k: v for k, v in t[1].items() if k != "dir"}
    assert snap_t == snap_j
    assert t[2] == j[2]
    assert t[3] == j[3]


def test_read_store_reads_the_others_directory(tmp_path, monkeypatch):
    ops = script(7)
    for name, mod, reg_mod in PKGS:
        run_store(mod, reg_mod, tmp_path / name, ops, monkeypatch)
    for name in ("jax", "torch"):
        want = jstore.read_store(tmp_path / name)
        assert tstore.read_store(tmp_path / name) == want
        assert [r["k"] for r in want][0] == "boot"
    assert tstore.read_store(tmp_path / "jax") == \
        jstore.read_store(tmp_path / "torch")
    assert tstore.read_store(tmp_path / "absent") == []


def test_resume_counters_seeds_the_same_series(tmp_path, monkeypatch):
    ops = script(3)
    run_store(jstore, jmetrics, tmp_path, ops, monkeypatch)
    records = jstore.read_store(tmp_path)
    out = []
    for mod, reg_mod in ((jstore, jmetrics), (tstore, tmetrics)):
        reg = reg_mod.Registry("tts")
        n = mod.resume_counters(reg, records, "host_a_1")
        out.append((n, reg.to_json(), reg.to_prometheus()))
        assert mod.resume_counters(reg_mod.Registry("tts"), records,
                                   "other") == 0
    assert out[1] == out[0]
    assert out[0][0] >= 1
    # tts_segments_total rides the sample but is not a resumed counter
    assert "tts_requests_total" in out[0][2]
    assert "tts_segments_total" not in out[0][2]


def test_corrupted_line_is_skipped_alike(tmp_path, monkeypatch):
    ops = script(5)
    run_store(jstore, jmetrics, tmp_path / "src", ops, monkeypatch,
              segment_records=4)
    segs = sorted(os.listdir(tmp_path / "src"))
    assert len(segs) >= 3
    for name in ("jax", "torch"):
        shutil.copytree(tmp_path / "src", tmp_path / name)
        p = tmp_path / name / segs[1]
        data = bytearray(p.read_bytes())
        second = data.index(b"\n") + 1
        data[second + 10] ^= 0x01         # inside the second record
        p.write_bytes(bytes(data))
    assert tstore.read_store(tmp_path / "torch") == \
        jstore.read_store(tmp_path / "jax")
    stores = {}
    for name, mod, reg_mod in PKGS:
        monkeypatch.setattr(mod, "time", Clock(5000.0))
        st = mod.ObsStore(tmp_path / name, "host-a:1",
                          registry=reg_mod.Registry("tts"),
                          segment_records=4, fsync=False)
        stores[name] = (st.replayed, st.truncated, st.quarantined_segments,
                        st.records_replayed())
        st.close()
    assert stores["torch"] == stores["jax"]
    assert stores["jax"][1] > 0 and stores["jax"][2] > 0
    assert files(tmp_path / "torch") == files(tmp_path / "jax")


def test_retention_prunes_the_same_segments(tmp_path, monkeypatch):
    ops = script(11)
    out = {}
    for name, mod, reg_mod in PKGS:
        root = tmp_path / name
        root.mkdir()
        for i in (1, 2):
            seg = root / f"{mod.SEGMENT_PREFIX}host_a_1-0000000{i}.jsonl"
            seg.write_bytes(mod._line({"k": "boot", "t": float(i),
                                       "w": "host_a_1", "pid": i}))
        # segment 1 closed long ago; 2 is the one the store continues
        os.utime(root / f"{mod.SEGMENT_PREFIX}host_a_1-00000001.jsonl",
                 (10.0, 10.0))
        clock = Clock(time.time())
        monkeypatch.setattr(mod, "time", clock)
        st = mod.ObsStore(root, "host-a:1", segment_records=2,
                          retain_s=60.0, fsync=False)
        for kind, fields in ops[:4]:
            st.append("sample", n=len(kind))
        st.flush()
        st.close()
        out[name] = sorted(os.listdir(root))
    assert out["torch"] == out["jax"]
    assert f"{jstore.SEGMENT_PREFIX}host_a_1-00000001.jsonl" \
        not in out["jax"]


def test_metric_names_table_is_jax_table():
    assert list(tnames.REGISTRY) == list(jnames.REGISTRY)
    for name, m in jnames.REGISTRY.items():
        assert dataclasses.asdict(tnames.REGISTRY[name]) == \
            dataclasses.asdict(m)
    assert (tstore.RESUME_COUNTERS, tstore.SAMPLE_GAUGES,
            tstore.EVENT_PREFIXES, tstore.TERMINAL_EVENTS) == (
        jstore.RESUME_COUNTERS, jstore.SAMPLE_GAUGES,
        jstore.EVENT_PREFIXES, jstore.TERMINAL_EVENTS)
