"""The port's checkpoint layer (`engine/checkpoint.py`) on the CPU.

Mirrors `tests/test_checkpoint.py` on the port's engine, then crosses the
file between the packages: a JAX snapshot (single-device, or stacked by the
JAX multi-device driver) resumes in the port, a port snapshot resumes in
the JAX engine, each to the oracle's totals, and the payload arrays and
their CRC32 are the same for the same state. All exact (integer math);
the instances are the JAX tests' seeded synthetic ones and Taillard's.
"""

import numpy as np
import pytest

from tpu_tree_search.engine import checkpoint as jcheckpoint
from tpu_tree_search.engine import device as jdevice
from tpu_tree_search.engine import distributed as jdistributed
from tpu_tree_search.engine import sequential as seq
from tpu_tree_search.ops import batched as jbatched
from tpu_tree_search.problems.pfsp import PFSPInstance
from tpu_tree_search_torch.engine import checkpoint, device
from tpu_tree_search_torch.ops import batched
from tpu_tree_search_torch.problems import taillard


import _torch_threads

_torch_threads.share_cores()


def _setup(seed=21):
    inst = PFSPInstance.synthetic(jobs=8, machines=4, seed=seed)
    opt = inst.brute_force_optimum()
    tables = batched.make_tables(inst.p_times, device="cpu")
    return inst, opt, tables


def _init(inst, capacity, ub, **kw):
    return device.init_state(inst.jobs, capacity, ub, p_times=inst.p_times,
                             device="cpu", **kw)


def _totals(state):
    c = device.counters(state)
    return c.tree, c.sol, c.best


def _want(inst, opt, lb=1):
    w = seq.pfsp_search(inst, lb=lb, init_ub=opt)
    return w.explored_tree, w.explored_sol, w.best


def test_save_load_roundtrip(tmp_path):
    inst, opt, tables = _setup()
    state = device.run(tables, _init(inst, 1 << 10, opt), 1, 8, max_iters=4)
    path = tmp_path / "ckpt.npz"
    checkpoint.save(path, state, meta={"segment": 1})
    restored, meta = checkpoint.load(path, device="cpu")
    assert int(meta["segment"]) == 1
    n = device.counters(state).size  # only live rows are snapshotted
    for f, a, b in zip(state._fields, state, restored):
        if f in checkpoint.POOL_FIELDS:
            a, b = a[..., :n], b[..., :n]
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    assert restored.prmu.shape == state.prmu.shape  # capacity re-homed


def test_resume_reaches_same_result(tmp_path):
    """Interrupt mid-search, reload, finish: totals equal an uninterrupted
    run."""
    inst, opt, tables = _setup()
    state = device.run(tables, _init(inst, 1 << 10, opt), 1, 8, max_iters=3)
    checkpoint.save(tmp_path / "c.npz", state)
    restored, _ = checkpoint.load(tmp_path / "c.npz", device="cpu")
    assert _totals(device.run(tables, restored, 1, 8)) == _want(inst, opt)


def test_segmented_driver(tmp_path):
    # Discovery mode (UB=inf): the search spans several segments of 2
    inst, opt, tables = _setup()
    ub0 = 1 << 20
    reports = []

    def run_fn(state, target_iters):
        return device.run(tables, state, 1, 2, max_iters=target_iters)

    final = checkpoint.run_segmented(
        run_fn, _init(inst, 1 << 10, ub0), segment_iters=2,
        checkpoint_path=str(tmp_path / "seg.npz"), heartbeat=reports.append)
    assert device.counters(final).best == opt
    assert device.counters(final).tree > 0
    assert len(reports) >= 2
    assert (tmp_path / "seg.npz").exists()
    assert reports[-1].pool_size == 0


def test_segmented_resume_offsets_targets(tmp_path):
    """Resuming run_segmented from a checkpoint whose iters already exceed
    segment_iters keeps making progress (targets offset by start iters)."""
    inst, opt, tables = _setup()

    def run_fn(state, target_iters):
        return device.run(tables, state, 1, 2, max_iters=target_iters)

    state = device.run(tables, _init(inst, 1 << 10, 1 << 20), 1, 2,
                       max_iters=10)
    assert device.counters(state).size > 0
    checkpoint.save(tmp_path / "mid.npz", state)
    restored, _ = checkpoint.load(tmp_path / "mid.npz", device="cpu")
    final = checkpoint.run_segmented(run_fn, restored, segment_iters=2,
                                     heartbeat=None)
    c = device.counters(final)
    assert c.size == 0 and c.best == opt


@pytest.mark.parametrize("capacity", [48, 96])
def test_overflow_state_is_recoverable(capacity):
    """An overflow, at the first step (48 rows: no usable row above the
    scratch margin) or inside the loop (96: 32 usable rows), leaves the
    live region and counters as before the overflowing step, so grow +
    resume gives exactly the unconstrained run's totals."""
    inst, opt, tables = _setup()
    ub0 = 1 << 20
    want = device.run(tables, _init(inst, 1 << 12, ub0), 1, 8)
    assert not device.counters(want).overflow

    small = device.run(tables, _init(inst, capacity, ub0), 1, 8)
    assert device.counters(small).overflow
    if capacity == 96:
        assert device.counters(small).iters > 0      # the loop really ran
    final = device.run(tables, checkpoint.grow(small, 1 << 12), 1, 8)
    assert not device.counters(final).overflow
    assert _totals(final) == _totals(want)


def test_load_pre_aux_checkpoint(tmp_path):
    """Checkpoints written before the pool carried aux tables load by
    rebuilding aux from p_times (a row-major schema-1 file)."""
    inst, opt, tables = _setup()
    state = device.run(tables, _init(inst, 1 << 10, opt), 1, 8, max_iters=4)
    arrays = {f: x.numpy() for f, x in zip(state._fields, state)
              if f != "aux"}
    arrays["prmu"] = arrays["prmu"].T.copy()
    np.savez_compressed(tmp_path / "old.npz", **arrays)

    with pytest.raises(ValueError, match="pre-aux"):
        checkpoint.load(tmp_path / "old.npz", device="cpu")
    restored, _ = checkpoint.load(tmp_path / "old.npz", p_times=inst.p_times,
                                  device="cpu")
    n = device.counters(state).size
    np.testing.assert_array_equal(restored.aux[:, :n].numpy(),
                                  state.aux[:, :n].numpy())
    assert _totals(device.run(tables, restored, 1, 8)) == _want(inst, opt)


def test_segmented_stall_detection():
    inst, opt, tables = _setup()
    state = device.run(tables, _init(inst, 1 << 10, 1 << 20), 1, 8,
                       max_iters=2)
    assert device.counters(state).size > 0
    with pytest.raises(RuntimeError, match="stalled"):
        checkpoint.run_segmented(lambda s, target: s, state, segment_iters=4,
                                 heartbeat=None, stall_limit=2)


# ------------------------------------------------- across the two packages
# seed 7: the largest ub=opt tree of the tiny synthetic family (495 pushed
# nodes), so a stop at 3 steps interrupts it


def _jax_mid(inst, opt, iters, telemetry=False):
    jt = jbatched.make_tables(inst.p_times)
    js = jdevice.init_state(inst.jobs, 1 << 10, opt, p_times=inst.p_times,
                            telemetry=telemetry)
    return jt, jdevice.run(jt, js, 1, 8, max_iters=iters)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    inst, opt, tables = _setup(7)
    _, js = _jax_mid(inst, opt, 3)
    assert int(js.size) > 0
    jcheckpoint.save(tmp_path / "j.npz", js, meta={"segment": 3})
    state, meta, used = checkpoint.load_resilient(tmp_path / "j.npz",
                                                  device="cpu")
    assert int(meta["segment"]) == 3 and used == tmp_path / "j.npz"
    assert device.counters(state).iters == 3
    assert _totals(device.run(tables, state, 1, 8)) == _want(inst, opt)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    inst, opt, tables = _setup(7)
    state = device.run(tables, _init(inst, 1 << 10, opt), 1, 8, max_iters=3)
    assert device.counters(state).size > 0
    checkpoint.save(tmp_path / "t.npz", state, meta={"segment": 3})
    js, meta, _ = jcheckpoint.load_resilient(tmp_path / "t.npz")
    assert int(meta["segment"]) == 3
    out = jdevice.run(jbatched.make_tables(inst.p_times), js, 1, 8)
    assert (int(out.tree), int(out.sol), int(out.best)) == _want(inst, opt)


@pytest.mark.parametrize("telemetry", [False, True])
def test_payload_and_crc_equal_across_packages(telemetry):
    """The same 3 steps on both engines give the same checkpoint payload:
    every array's name, dtype, shape and values, and the CRC32."""
    inst, opt, tables = _setup(7)
    _, js = _jax_mid(inst, opt, 3, telemetry)
    state = device.run(tables, _init(inst, 1 << 10, opt, telemetry=telemetry),
                       1, 8, max_iters=3)
    meta = {"segment": 1, "warmup_tree": 0,
            "host_prmu": np.zeros((0, inst.jobs), np.int16)}
    want = jcheckpoint.snapshot_arrays(js, meta)
    got = checkpoint.snapshot_arrays(state, meta)
    assert sorted(got) == sorted(want)
    for k in want:
        assert (got[k].dtype, got[k].shape) == (want[k].dtype,
                                                want[k].shape), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert checkpoint._payload_crc(got) == jcheckpoint._payload_crc(want)
    assert want["telemetry"].shape == ((60,) if telemetry else (0,))


def test_stacked_jax_checkpoint_collapses_onto_port(tmp_path):
    """A partial 2-device JAX run of ta003 LB2 (the stacked checkpoint the
    JAX multi-device driver writes) resumes on the port's one pool through
    `collapse_to_single_device`: the warm-up frontier's nodes (meta) plus
    the device tree give the golden 80062. With ub=opt the pushed set is
    the same in any order, so the resume takes a wider chunk (few, wide
    steps keep the CPU run short on a loaded host)."""
    p = taillard.processing_times(3)
    opt = taillard.optimal_makespan(3)
    ckpt = tmp_path / "stacked.npz"
    part = jdistributed.search(p, lb_kind=2, init_ub=opt, n_devices=2,
                               chunk=8, capacity=1 << 16, min_seed=8,
                               segment_iters=20, max_rounds=10,
                               checkpoint_path=str(ckpt), heartbeat=None)
    assert not part.complete, "partial run finished — nothing to resume"
    state, meta, _ = checkpoint.load_resilient(ckpt, p_times=p, device="cpu")
    assert tuple(state.prmu.shape) == (2, 20, 1 << 16)
    sizes = state.size.tolist()
    one = checkpoint.collapse_to_single_device(state, 4096, 20,
                                               device="cpu")
    assert one.prmu.dim() == 2 and one.prmu.shape[1] >= 2 << 16
    c = device.counters(one)
    assert c.size == sum(sizes) and c.sent == c.recv > 0
    out = device.run(batched.make_tables(p, device="cpu"), one, 2, 4096)
    c = device.counters(out)
    assert (c.tree + int(meta["warmup_tree"]), c.sol, c.best) == \
        (80062, 0, opt)


@pytest.mark.parametrize("workers", [3, 1])
def test_reshard_matches_jax_with_telemetry(workers):
    """The port's reshard of a telemetry-carrying state equals the JAX
    package's: every field of every new pool, the merged telemetry vector
    (`telemetry.merge`) on worker 0 included; the per-segment telemetry
    deltas (`delta_counts`) agree too."""
    from tpu_tree_search.engine import telemetry as jtele
    from tpu_tree_search_torch.engine import telemetry as tele

    inst, opt, tables = _setup(7)
    _, js = _jax_mid(inst, opt, 3, telemetry=True)
    state = device.run(tables, _init(inst, 1 << 10, opt, telemetry=True),
                       1, 8, max_iters=3)
    want = jcheckpoint.reshard_state(js, workers, squeeze=workers == 1)
    got = checkpoint.reshard_state(state, workers, squeeze=workers == 1,
                                   device="cpu")
    assert int(np.asarray(want.telemetry).any())
    for f in state._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    before = np.asarray(js.telemetry)
    after = np.asarray(want.telemetry).reshape(-1, before.shape[-1])
    assert tele.delta_counts(tele.merge(after), before) == \
        jtele.delta_counts(jtele.merge(after), before)


def test_segment_reports_and_trace_match_jax(tmp_path):
    """The same segmented run (2-step segments, a checkpoint each,
    telemetry on) through the JAX driver and the port's: the same
    SegmentReports (all but the wall time) and the same `segment` spans'
    counters and `search.telemetry` events in the flight recorder."""
    from tpu_tree_search.obs import tracelog as jtracelog
    from tpu_tree_search_torch.obs import tracelog

    inst, opt, tables = _setup(7)
    jt = jbatched.make_tables(inst.p_times)

    def drive(driver, log_mod, run_fn, state, path):
        log = log_mod.TraceLog()
        prev = log_mod.install(log)
        reports = []
        try:
            driver.run_segmented(run_fn, state, segment_iters=2,
                                 checkpoint_path=str(path),
                                 heartbeat=reports.append)
        finally:
            log_mod.install(prev)
        recs = [{k: v for k, v in r.items()
                 if k not in ("ts", "dur", "seq", "pid", "thread", "path")}
                for r in log.records()
                if r["name"] in ("segment", "search.telemetry")]
        return [{k: v for k, v in vars(r).items()
                 if k not in ("elapsed", "per_worker")} for r in reports], \
            recs

    want = drive(jcheckpoint, jtracelog,
                 lambda s, t: jdevice.run(jt, s, 1, 8, max_iters=t),
                 jdevice.init_state(inst.jobs, 1 << 10, opt,
                                    p_times=inst.p_times, telemetry=True),
                 tmp_path / "j.npz")
    got = drive(checkpoint, tracelog,
                lambda s, t: device.run(tables, s, 1, 8, max_iters=t),
                _init(inst, 1 << 10, opt, telemetry=True), tmp_path / "t.npz")
    assert len(want[0]) > 2 and want[0][-1]["pool_size"] == 0
    assert got == want
