"""The port's overlapped segment driver and its asynchronous checkpoint
writer against the synchronous driver and the JAX package's.

Ports the overlap half of `tests/test_overlap.py` to the port's
`distributed.search(overlap=...)` on four CPU workers, with the JAX
package on `worker_mesh(4)` of the conftest's CPU mesh, on
`PFSPInstance.synthetic(8, 4, 7)` at LB1 and ub=opt: the totals, every
worker's counters and every `SegmentReport` but its wall-clock field,
segment by segment, overlap on against off and against JAX's runs in both
modes (the overlapped driver drains the segment in flight at an exit, so
its last report, of a no-op segment, repeats the totals); the TTS_OVERLAP
flag through the `overlapped` span; lossless growth from a small pool;
resume across modes and across packages; a stop event; a corrupted async
write rolling back to `.prev`; the writer's rotation order; its
saturated error path staying live; the gap metric; the round-trip audit
across the async edge; and the chunk ladder under overlap, its rung
sequence and every worker's state at every dispatch equal to JAX's. On
CPU workers nothing is asynchronous (`run_async` runs its
macro-iterations eagerly): these tests hold the order and the counts,
the card holds the timing. All exact (integer math)."""

import contextlib
import dataclasses
import threading
import warnings

import numpy as np
import pytest

from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.parallel.mesh import worker_mesh
from tpu_tree_search_torch.engine import checkpoint as tckpt
from tpu_tree_search_torch.engine import device as tdevice
from tpu_tree_search_torch.engine import distributed as tdist
from tpu_tree_search_torch.engine import sequential as tseq
from tpu_tree_search_torch.obs import metrics as tmetrics
from tpu_tree_search_torch.obs import tracelog as ttracelog
from tpu_tree_search_torch.ops import batched
from tpu_tree_search_torch.problems.pfsp import PFSPInstance
from tpu_tree_search_torch.utils import faults

import _torch_isolation
import _torch_threads

_torch_threads.share_cores()

D = 4
INST = PFSPInstance.synthetic(jobs=8, machines=4, seed=7)
OPT = INST.brute_force_optimum()
KW = dict(lb_kind=1, init_ub=OPT, chunk=4, capacity=1 << 12, min_seed=8)


@pytest.fixture(autouse=True)
def _isolated():
    with _torch_isolation.isolated():
        yield


@pytest.fixture
def fault_plan():
    yield faults.configure
    faults.reset()


def _port(**kw):
    reports = []
    kw.setdefault("heartbeat", reports.append)
    res = tdist.search(INST.p_times, devices=["cpu"] * D, **{**KW, **kw})
    return res, reports


def _jax(**kw):
    reports = []
    kw.setdefault("heartbeat", reports.append)
    res = jdist.search(INST.p_times, mesh=worker_mesh(D), **{**KW, **kw})
    return res, reports


def _totals(res):
    return (res.explored_tree, res.explored_sol, res.best, res.complete)


def _want():
    w = tseq.pfsp_search(INST, lb=1, init_ub=OPT)
    return (w.explored_tree, w.explored_sol, w.best, True)


def _rows(reports):
    """The reports without their wall-clock field, as plain values."""
    out = []
    for r in reports:
        d = dataclasses.asdict(r)
        d.pop("elapsed")
        if d["per_worker"] is not None:
            d["per_worker"] = {k: [int(x) for x in v]
                               for k, v in d["per_worker"].items()}
        out.append(d)
    return out


def _same_reports(overlapped, sync):
    """Segment by segment equal; a drained trailing segment (a no-op at
    exhaustion) repeats the last report's counts."""
    on, off = _rows(overlapped), _rows(sync)
    assert on[:len(off)] == off
    for extra in on[len(off):]:
        assert {**extra, "segment": off[-1]["segment"]} == off[-1]


def _same_per_device(got, want):
    for f, v in want.per_device.items():
        np.testing.assert_array_equal(got.per_device[f], np.asarray(v),
                                      err_msg=f)


@pytest.mark.parametrize("every", [1, 2])
def test_overlap_bit_parity(tmp_path, every):
    """Overlap on against off in the port, and each against JAX's run in
    the same mode: the totals, every worker's counters and every segment
    report but its wall-clock field, checkpointing every `every`
    segments."""
    ck = dict(segment_iters=2, checkpoint_every=every)
    off, r_off = _port(checkpoint_path=str(tmp_path / "off.npz"),
                       overlap=False, **ck)
    on, r_on = _port(checkpoint_path=str(tmp_path / "on.npz"),
                     overlap=True, **ck)
    j_off, rj_off = _jax(checkpoint_path=str(tmp_path / "joff.npz"),
                         overlap=False, **ck)
    j_on, rj_on = _jax(checkpoint_path=str(tmp_path / "jon.npz"),
                       overlap=True, **ck)
    assert _totals(on) == _totals(off) == _totals(j_on) == _want()
    for got, want in ((on, off), (off, j_off), (on, j_on)):
        _same_per_device(got, want)
    _same_reports(r_on, r_off)
    assert _rows(r_off) == _rows(rj_off)
    assert _rows(r_on) == _rows(rj_on)
    assert len(r_on) == len(r_off) + 1      # the drained last segment


def _segmented(tables, overlap, **kw):
    reports = []
    state = tdevice.init_state(INST.jobs, 1 << 10, OPT,
                               p_times=INST.p_times, device="cpu")
    out = tckpt.run_segmented(
        lambda s, t: tdevice.run(tables, s, 1, 8, max_iters=t), state,
        segment_iters=2, heartbeat=reports.append, overlap=overlap, **kw)
    return out, reports


@pytest.mark.parametrize("kw", [{}, dict(max_segments=5),
                                dict(max_total_iters=7)],
                         ids=["exhaust", "max_segments", "max_total_iters"])
def test_run_segmented_overlap_matches_sync_on_one_device(kw):
    """`run_segmented(overlap=True)` with a synchronous `run_fn` (one
    device's `device.run`): the same state and reports as the synchronous
    driver, segment by segment."""
    tables = batched.make_tables(INST.p_times, device="cpu")
    off, r_off = _segmented(tables, False, **kw)
    on, r_on = _segmented(tables, True, **kw)
    assert tdevice.counters(on) == tdevice.counters(off)
    _same_reports(r_on, r_off)


def test_overlap_refuses_post_segment():
    """The host tier's per-segment merge needs the synchronous boundary:
    overlap with `post_segment` raises before any segment runs."""
    tables = batched.make_tables(INST.p_times, device="cpu")
    with pytest.raises(ValueError, match="post_segment"):
        _segmented(tables, True, post_segment=lambda s: s)


def test_overlap_env_flag(monkeypatch):
    """overlap=None reads TTS_OVERLAP; the overlapped segment spans show
    which driver ran."""
    monkeypatch.setenv("TTS_OVERLAP", "1")
    res, _ = _port(segment_iters=2, overlap=None)
    assert _totals(res) == _want()
    spans = [r for r in ttracelog.get().records()
             if r.get("name") == "segment"]
    assert spans and all(r.get("overlapped") for r in spans)


def test_overlap_overflow_grows_losslessly(monkeypatch):
    """Pools too small for the run (11x4 LB1_d at ub=inf, transfer blocks
    of 8) overflow and grow in the middle of the pipeline, and the search
    resumes from where the loop stopped: JAX's overlapped run's totals and
    every worker's counters, and the port's synchronous run's."""
    table = PFSPInstance.synthetic(jobs=11, machines=4, seed=11).p_times
    kw = dict(lb_kind=0, init_ub=None, chunk=8, transfer_cap=8, min_seed=8,
              capacity=1 << 8, segment_iters=4, heartbeat=None)
    grown = []
    orig = tckpt.grow
    monkeypatch.setattr(tckpt, "grow",
                        lambda s, c: grown.append(c) or orig(s, c))
    res = tdist.search(table, devices=["cpu"] * D, overlap=True, **kw)
    assert grown, "the small pool never overflowed"
    want = jdist.search(table, mesh=worker_mesh(D), overlap=True, **kw)
    sync = tdist.search(table, devices=["cpu"] * D, overlap=False, **kw)
    assert _totals(res) == _totals(want) == _totals(sync)
    assert res.complete
    _same_per_device(res, want)
    _same_per_device(sync, want)


@pytest.mark.parametrize("first,then", [
    ("port-on", "port-off"), ("port-off", "port-on"),
    ("port-on", "jax-off"), ("jax-on", "port-on")])
def test_overlap_resume_across_modes_and_packages(tmp_path, first, then):
    """A checkpoint written through either driver of either package
    resumes under the other with the oracle's totals."""
    runs = {"port-on": lambda **k: _port(overlap=True, **k),
            "port-off": lambda **k: _port(overlap=False, **k),
            "jax-on": lambda **k: _jax(overlap=True, **k),
            "jax-off": lambda **k: _jax(overlap=False, **k)}
    ck = str(tmp_path / "x.npz")
    part, _ = runs[first](segment_iters=2, max_rounds=2, checkpoint_path=ck)
    assert not part.complete
    res, _ = runs[then](checkpoint_path=ck)
    assert _totals(res) == _want()


def test_overlap_stop_event_checkpoints_and_resumes(tmp_path):
    """A stop under overlap lands within one extra segment (the drained
    speculative dispatch), the writer has the state on disk before the
    call returns, and the resume, in either mode, ends at the oracle."""
    ck = tmp_path / "pre.npz"
    ev = threading.Event()
    seen = []

    def hb(rep):
        seen.append(rep.segment)
        if rep.segment >= 2:
            ev.set()

    part, _ = _port(segment_iters=2, checkpoint_path=str(ck), heartbeat=hb,
                    stop_event=ev, overlap=True)
    assert not part.complete and ck.exists()
    assert seen[-1] <= 3
    with np.load(ck) as z:
        assert int(z["meta_segment"]) == seen[-1]
    for overlap in (True, False):
        copy = tmp_path / f"copy{overlap}.npz"
        copy.write_bytes(ck.read_bytes())
        res, _ = _port(checkpoint_path=str(copy), overlap=overlap)
        assert _totals(res) == _want()


def test_async_writer_crash_during_write_rolls_back(tmp_path, fault_plan):
    """The last async write (segment 4 of a 4-segment run) is corrupted on
    the writer thread: the resume rolls back to `.prev` and ends at the
    oracle."""
    ck = tmp_path / "c.npz"
    fault_plan("corrupt_checkpoint=4")
    part, reps = _port(segment_iters=2, max_rounds=2,
                       checkpoint_path=str(ck), overlap=True)
    assert not part.complete and reps[-1].segment == 4
    assert ck.exists() and (tmp_path / "c.npz.prev").exists()
    saves = [r for r in ttracelog.get().records()
             if r.get("name") == "checkpoint.save"]
    assert saves and all(r["thread"] == "tts-ckpt-writer"
                         and r.get("async_write") for r in saves)
    faults.reset()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res, _ = _port(checkpoint_path=str(ck), overlap=True)
    assert any("corrupt" in str(x.message) for x in w)
    assert _totals(res) == _want()


def _mid_state(iters):
    tables = batched.make_tables(INST.p_times, device="cpu")
    s = tdevice.init_state(INST.jobs, 1 << 10, OPT, p_times=INST.p_times,
                           device="cpu")
    return tdevice.run(tables, s, 1, 8, max_iters=iters)


def test_writer_preserves_rotation_order(tmp_path):
    """After three submits through a one-deep queue, the current file
    holds the last state and `.prev` the one before."""
    ck = tmp_path / "w.npz"
    writer = tckpt.AsyncCheckpointWriter(max_pending=1)
    try:
        iters = []
        for k in (2, 4, 6):
            state = _mid_state(k)
            iters.append(tdevice.counters(state).iters)
            writer.submit(str(ck), state, {"mark": k}, segment=k)
        writer.drain()
    finally:
        writer.close()
    cur, meta = tckpt.load(ck, device="cpu")
    prev, prev_meta = tckpt.load(str(ck) + ".prev", device="cpu")
    assert int(meta["mark"]) == 6 and int(prev_meta["mark"]) == 4
    assert int(cur.iters) == iters[-1] and int(prev.iters) == iters[-2]
    assert writer.peak_pending >= 1


def test_async_writer_saturated_error_path_stays_live(tmp_path,
                                                      monkeypatch):
    """A full one-deep queue and a writer in its error path: every submit
    and the drain finish, and the write failure surfaces (the two-lock
    design; one lock would deadlock between the lock and the queue's
    capacity)."""
    state = _mid_state(2)

    def boom(path, arrays):
        raise OSError("disk on fire")

    monkeypatch.setattr(tckpt, "_write_snapshot", boom)
    writer = tckpt.AsyncCheckpointWriter(retry_attempts=1,
                                         retry_base_s=0.0, max_pending=1)
    errors = []

    def producer():
        for k in range(6):
            try:
                writer.submit(str(tmp_path / "w.npz"), state, segment=k)
            except OSError as e:
                errors.append(e)
        try:
            writer.drain()
        except OSError as e:
            errors.append(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    t.join(timeout=60)
    alive = t.is_alive()
    writer.close(raise_pending=False)
    assert not alive, "writer and producer wedged"
    assert errors and all("disk on fire" in str(e) for e in errors)


def test_overlap_gap_metric_zero():
    """With overlap on and no checkpoint, every recorded gap is 0 (each
    dispatch precedes the previous segment's read); the synchronous driver
    records positive gaps."""
    reg = tmetrics.default()
    _port(segment_iters=2, overlap=True)
    on = reg.histogram("tts_segment_gap_seconds", "").snapshot()
    assert on["count"] > 0 and on["sum"] == 0.0
    _port(segment_iters=2, overlap=False)
    both = reg.histogram("tts_segment_gap_seconds", "").snapshot()
    assert both["count"] > on["count"] and both["sum"] > 0.0


def test_overlap_audit_green_across_async_edge(tmp_path, monkeypatch):
    """TTS_AUDIT=full with TTS_AUDIT_HARD=1 over an overlapped,
    checkpointed run: the writer thread re-reads every snapshot against
    the sums taken where it was fetched, and every check passes."""
    monkeypatch.setenv("TTS_AUDIT", "full")
    monkeypatch.setenv("TTS_AUDIT_HARD", "1")
    res, reps = _port(segment_iters=2, overlap=True,
                      checkpoint_path=str(tmp_path / "a.npz"))
    assert _totals(res) == _want()
    checks = [r for r in ttracelog.get().records()
              if r.get("name") == "audit.check"
              and r.get("invariant") == "checkpoint_roundtrip"]
    assert len(checks) == len(reps)
    assert all(r["thread"] == "tts-ckpt-writer" for r in checks)
    reg = tmetrics.default()
    assert reg.counter("tts_audit_failures_total", "").value(
        invariant="checkpoint_roundtrip") == 0


@contextlib.contextmanager
def _dispatches(dist_mod, chunk_of):
    """(rung chunk, stacked host state) of every `run_async` call."""
    seen = []
    orig = dist_mod._DistDriver.run_async

    def run_async(self, state, *args, **kw):
        out = orig(self, state, *args, **kw)
        seen.append((chunk_of(self), dist_mod.fetch_state(out)))
        return out

    dist_mod._DistDriver.run_async = run_async
    try:
        yield seen
    finally:
        dist_mod._DistDriver.run_async = orig


def test_ladder_under_overlap_matches_jax(monkeypatch):
    """The chunk ladder on the overlapped driver (10x5 LB1 at chunk 2048,
    rungs 128, 512, 2048, 8-step segments): the rung of every dispatch and
    every worker's rows and counters after it equal JAX's ladder under
    overlap, and the totals equal the port's synchronous ladder run."""
    table = PFSPInstance.synthetic(jobs=10, machines=5, seed=1).p_times
    kw = dict(lb_kind=1, init_ub=697, chunk=2048, capacity=1 << 16,
              min_seed=8, segment_iters=8, ladder=True, heartbeat=None)
    with _dispatches(jdist, lambda d: d.loop_key[4]) as jseen:
        want = jdist.search(table, mesh=worker_mesh(D), overlap=True, **kw)
    with _dispatches(tdist, lambda d: d.key[3]) as tseen:
        got = tdist.search(table, devices=["cpu"] * D, overlap=True, **kw)
    assert [c for c, _ in tseen] == [c for c, _ in jseen]
    assert len({c for c, _ in tseen}) > 1          # the rung switched
    for (_, g), (_, w) in zip(tseen, jseen):
        for f in ("size", "best", "tree", "sol", "evals", "iters", "sent",
                  "recv", "steals", "overflow"):
            np.testing.assert_array_equal(np.asarray(getattr(g, f)),
                                          np.asarray(getattr(w, f)),
                                          err_msg=f)
        for d, n in enumerate(np.asarray(w.size)):
            for f in ("prmu", "depth", "aux"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(g, f))[d, ..., :n],
                    np.asarray(getattr(w, f))[d, ..., :n], err_msg=f)
    sync = tdist.search(table, devices=["cpu"] * D, overlap=False, **kw)
    assert _totals(got) == _totals(want) == _totals(sync)
