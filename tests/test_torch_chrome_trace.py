"""The port's `obs/chrome_trace.py` against the JAX package's.

The export half is JAX's: one record list (spans, events, lane-state
transitions, request lifelines, search-telemetry and memory counters)
gives JSON-equal documents through both packages' `to_chrome`, and both
read the same JSONL sink back alike. The import half reads
`torch.profiler`'s traces: on one nested synthetic event list whose
events are at once in a ``tf_XLA`` thread lane (JAX's CPU-backend lane)
and of the ``cpu_op`` category (the port's CPU lane), `self_times` and
`bucketed_self_times` equal JAX's; on the card's lane, where nothing
nests but records of one stream can overlap, each event is charged its
own duration; a CPU capture made through
`profiler.capture` loads through `load_profile_trace` and names the CPU
ops its worker thread ran; the card's own kernel names (as a trace on the
H100 spells them) land in JAX's bucket names. Tolerance is exact: the
documents are built from the same numbers by the same arithmetic."""

import json
import threading

import pytest
import torch

from tpu_tree_search.obs import chrome_trace as jct
from tpu_tree_search.obs import tracelog as jtracelog
from tpu_tree_search_torch.obs import chrome_trace as tct
from tpu_tree_search_torch.obs import metrics, profiler
from tpu_tree_search_torch.obs import tracelog as ttracelog

import _torch_isolation
import _torch_threads

_torch_threads.share_cores()


@pytest.fixture(autouse=True)
def iso():
    with _torch_isolation.isolated():
        yield


def recorded(mod) -> list[dict]:
    """One session's records through a package's own recorder: spans on
    two submeshes, request events with tags, a telemetry segment, a
    memory sample and lane-state transitions."""
    log = mod.TraceLog(capacity=1 << 10)
    with log.context(request_id="req-0000", submesh=0, tag="t0"):
        with log.span("request.execute", dispatch=1):
            log.event("request.dispatch", queue_depth=0)
            log.event("search.telemetry", pruning_rate=0.5,
                      frontier_depth=7, pool=1234, steal_sent=1,
                      steal_recv=2, segment=1)
        log.event("lane.state", prev="executing", state="idle",
                  seconds=0.25)
    with log.context(request_id="req-0001", submesh=1):
        with log.span("checkpoint.save", bytes=4096):
            pass
        log.event("request.done", tree=80062)
    log.event("resource.sample", host_rss_bytes=1 << 30,
              devices=[{"id": 0, "bytes_in_use": 1 << 20,
                        "peak_bytes_in_use": 1 << 21},
                       {"id": 1, "bytes_in_use": None}, "bad"])
    log.event("lane.state", prev="compiling", state="executing",
              seconds=0.0, submesh=1)
    log.event("server.close")
    return log.records()


def test_to_chrome_equals_jax():
    recs = recorded(ttracelog)
    # the records carry the recorder's own clock: the JAX recorder's list
    # has the same shape and both packages convert either list alike
    for records in (recs, recorded(jtracelog)):
        want = jct.to_chrome(records)
        got = tct.to_chrome(records)
        assert json.dumps(got, sort_keys=True) \
            == json.dumps(want, sort_keys=True)
    lanes = {e["args"]["name"] for e in got["traceEvents"]
             if e["ph"] == "M"}
    assert {"submesh-0", "submesh-1", "request-t0", "lane-0-state",
            "lane-1-state"} <= lanes
    counters = {e["name"] for e in got["traceEvents"] if e["ph"] == "C"}
    assert "pool (submesh-0)" in counters
    assert any(c.startswith("device0 bytes_peak") for c in counters)


def test_write_and_read_jsonl_equal_jax(tmp_path):
    log = ttracelog.TraceLog(capacity=1 << 10,
                             sink_path=tmp_path / "t.jsonl")
    with log.span("segment", segment=1):
        log.event("request.admit", request_id="req-0000")
    log.set_sink(None)
    with open(tmp_path / "t.jsonl", "a") as f:
        f.write('{"kind": "event", "name": "torn')      # a killed writer
    assert tct.read_jsonl(tmp_path / "t.jsonl") \
        == jct.read_jsonl(tmp_path / "t.jsonl")
    recs = tct.read_jsonl(tmp_path / "t.jsonl")
    assert [r["name"] for r in recs] == ["request.admit", "segment"]
    a = tct.write_chrome(tmp_path / "port" / "t.json", recs)
    b = jct.write_chrome(tmp_path / "jax" / "t.json", recs)
    assert json.loads(open(a).read()) == json.loads(open(b).read())


def nested_events() -> list[dict]:
    """Two CPU lanes (threads) of nested ops, each event in a ``tf_XLA``
    thread lane (JAX's CPU-backend lane) and of the ``cpu_op`` category
    (the port's CPU lane), plus events neither package may count."""
    meta = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": t,
             "args": {"name": f"tf_XLAEigen/{t}"}} for t in (7, 8)]

    def x(name, ts, dur, tid=7):
        return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1,
                "tid": tid, "ts": ts, "dur": dur}

    return meta + [
        x("while.body", 0.0, 100.0), x("sort.3", 10.0, 30.0),
        x("gather.1", 12.0, 5.0), x("copy.2", 50.0, 20.0),
        x("aten::scatter.4", 80.0, 10.0), x("pad", 120.0, 4.0),
        x("sort.3", 0.0, 8.0, tid=8), x("concatenate", 9.0, 2.0, tid=8),
        x("mystery", 20.0, 1.5, tid=8),
        {"ph": "X", "cat": "user_annotation", "name": "window", "pid": 1,
         "tid": 9, "ts": 0.0, "dur": 500.0},
        {"ph": "i", "name": "instant", "pid": 1, "tid": 7, "ts": 1.0}]


def test_self_times_equal_jax():
    ev = nested_events()
    want_us, want_n = jct.self_times(ev)
    got_us, got_n = tct.self_times(ev)
    assert got_us == want_us and got_n == want_n
    assert got_us["while.body"] == 100.0 - 30.0 - 20.0 - 10.0
    assert got_us["sort.3"] == 30.0 - 5.0 + 8.0 and got_n["sort.3"] == 2
    # the lane named outright gives the same table
    assert tct.self_times(ev, lane="cpu") == (got_us, got_n)
    assert tct.self_times(ev, lane="device") == ({}, {})


def test_device_events_are_charged_their_own_time():
    """On the card's lane nothing nests: kernels that overlap in one
    stream's lane (a replayed graph's branches, a dependent launch) are
    each charged their own duration, and the device lane wins over the
    CPU ops of the same trace."""
    def k(name, ts, dur, cat="kernel", tid=7):
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid,
                "ts": ts, "dur": dur}

    ev = [k("fused_prep", 0.0, 10.0), k("fused_main", 5.0, 20.0),
          k("index_copy", 6.0, 3.0), k("Memcpy DtoD", 30.0, 2.0,
                                       cat="gpu_memcpy"),
          k("Memset", 40.0, 1.0, cat="gpu_memset", tid=8),
          k("aten::mm", 0.0, 100.0, cat="cpu_op", tid=1)]
    us, n = tct.self_times(ev)
    assert dict(us) == {"fused_prep": 10.0, "fused_main": 20.0,
                        "index_copy": 3.0, "Memcpy DtoD": 2.0,
                        "Memset": 1.0}
    assert sum(n.values()) == 5


def test_bucketed_self_times_equal_jax():
    """Op names that bucket alike in both packages (the XLA-only
    substrings `fusion.`, `pallas` and `dynamic-update-slice` have no
    counterpart on the card) fold alike."""
    self_us, _ = tct.self_times(nested_events())
    want = jct.bucketed_self_times(self_us)
    got = tct.bucketed_self_times(self_us)
    assert got == want
    assert set(got) == {"other", "sort", "gather", "copy_concat_pad",
                        "scatter_write"}
    assert {b for b, _ in tct.SELF_TIME_BUCKETS} \
        == {b for b, _ in jct.SELF_TIME_BUCKETS}


# kernel names as a trace on the H100 spells them (torch 2.11, CUDA 12.8)
CARD_NAMES = {
    "void (anonymous namespace)::lb2_sweep_kernel<1, 4>(int const*, long "
    "long, unsigned int const*, long long, int, int const*, int, int, int, "
    "int, int4 const*, int4 const*, int*)": "lb2_pair_sweep",
    "void (anonymous namespace)::fused_main<20, 20>(int const*, int "
    "const*, short const*, int const*)": "expand_kernel",
    "void (anonymous namespace)::fused_prep<20, 20>(int const*)":
        "expand_kernel",
    "void (anonymous namespace)::expand_main<20, 20, false>((anonymous "
    "namespace)::Args, int)": "expand_kernel",
    "void (anonymous namespace)::expand_prep<10, 10>((anonymous "
    "namespace)::Args)": "expand_kernel",
    "void at::native::index_elementwise_kernel<128, 4, "
    "at::native::gpu_index_kernel<at::native::index_kernel_impl<"
    "at::native::OpaqueType<4> >(at::TensorIteratorBase&)": "gather",
    "void at::native::_scatter_gather_elementwise_kernel<128, 8, "
    "at::native::_cuda_scatter_gather_internal_kernel<false, at::native::"
    "OpaqueType<4> >": "gather",
    "void at::native::index_elementwise_kernel<128, 4, "
    "at::native::index_copy_kernel_impl<at::native::OpaqueType<2> >("
    "at::TensorIterator&, long, long, long)": "scatter_write",
    "void at::native::_scatter_gather_elementwise_kernel<128, 8, "
    "at::native::_cuda_scatter_gather_internal_kernel<true, at::native::"
    "OpaqueType<4> >": "scatter_write",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy_"
    "vectorized<at::native::(anonymous namespace)::OpaqueType<4u>, "
    "unsigned int, 1, 128, 1, 16, 4>(char*)": "copy_concat_pad",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_"
    "kernel_cuda(at::TensorIteratorBase&)": "copy_concat_pad",
    "Memcpy DtoD (Device -> Device)": "copy_concat_pad",
    "Memset (Unknown)": "copy_concat_pad",
    "void at::native::vectorized_elementwise_kernel<4, "
    "at::native::CUDAFunctor_add<int>, std::array<char*, 3ul> >": "other",
    "aten::index": "gather", "aten::index_copy_": "scatter_write",
    "aten::cat": "copy_concat_pad", "aten::sort": "sort", "aten::mm":
        "other"}


def test_card_names_land_in_jax_buckets():
    got = {name: tct.bucket_of(name) for name in CARD_NAMES}
    assert got == CARD_NAMES


def test_cpu_capture_loads_and_names_its_ops(tmp_path):
    """A timed capture of a worker thread's CPU ops (the session records
    every thread, as a live server's executors need): the artifact sits
    in JAX's layout and its self-time table names the ops."""
    reg = metrics.Registry()
    sess = profiler.ProfilerSession(registry=reg)
    stop, started = threading.Event(), threading.Event()

    def work():
        a = torch.ones(32, 32)
        while not stop.is_set():
            torch.sort(a @ a)
            started.set()

    th = threading.Thread(target=work)
    th.start()
    try:
        started.wait(timeout=10)
        art = sess.capture(0.05, sess.fresh_dir(tmp_path))
    finally:
        stop.set()
        th.join(timeout=10)
    paths = list((tmp_path).glob("capture-*/plugins/profile/*/"
                                 "*.trace.json.gz"))
    assert len(paths) == 1 and str(paths[0]).startswith(art)
    events = tct.load_profile_trace(art)
    self_us, counts = tct.self_times(events)
    assert counts["aten::mm"] > 0 and counts["aten::sort"] > 0
    assert self_us["aten::mm"] > 0
    assert tct.bucketed_self_times(self_us)["sort"] > 0
    assert tct.load_profile_trace(tmp_path / "nothing") == []
