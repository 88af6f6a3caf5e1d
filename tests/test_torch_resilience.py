"""The port's resilience layer on the CPU: atomic, checksummed checkpoints
with last-good rollback, the reshard onto other worker counts, retry and
backoff (`utils/retry.py`), the watchdog and the fault-injection harness
(`utils/faults.py`) in the segmented driver, and the `pfsp` CLI's
segmented, checkpointed runs.

Mirrors the single-device tests of `tests/test_resilience.py` and the
tests of `tests/test_retry.py` on the port. Beyond them: `device.run`
updates the pool in place, so a segment that stepped and then failed is
retried from the device copy `run_segmented` keeps (the oracle's totals);
a CUDA runtime error and a watchdog timeout are not retried; the
`pause_server` drill is a plain wedge without a `service/` package; the
overlapped driver gives the synchronous driver's state and reports; and
the CLI's `[segment k]` lines equal the
JAX CLI's for the same run and resume. Every comparison is exact.
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpu_tree_search.engine import sequential as seq
from tpu_tree_search.problems.pfsp import PFSPInstance
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.engine import checkpoint, device
from tpu_tree_search_torch.ops import batched
from tpu_tree_search_torch.parallel import balance as bal
from tpu_tree_search_torch.utils import config, faults, retry

import _torch_threads

_torch_threads.share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fault_plan():
    """Install a fault plan for the test, always disarmed afterwards."""
    yield faults.configure
    faults.reset()


def _setup():
    # seed=7: the largest ub=opt tree of the tiny synthetic family (495
    # pushed nodes), so interruption points actually interrupt
    inst = PFSPInstance.synthetic(jobs=8, machines=4, seed=7)
    opt = inst.brute_force_optimum()
    tables = batched.make_tables(inst.p_times, device="cpu")
    return inst, opt, tables


def _init(inst, ub, capacity=1 << 10):
    return device.init_state(inst.jobs, capacity, ub, p_times=inst.p_times,
                             device="cpu")


def _mid_state(inst, opt, tables, iters=3):
    state = device.run(tables, _init(inst, opt), 1, 8, max_iters=iters)
    assert device.counters(state).size > 0
    return state


def _totals(state):
    c = device.counters(state)
    return c.tree, c.sol, c.best


def _want(inst, opt):
    w = seq.pfsp_search(inst, lb=1, init_ub=opt)
    return w.explored_tree, w.explored_sol, w.best


def _run_fn(tables, chunk=8):
    def run_fn(state, target):
        return device.run(tables, state, 1, chunk, max_iters=target)
    return run_fn


# ------------------------------------------------------------- waterfill


def test_waterfill_counts():
    assert bal.waterfill_counts(10, 4).tolist() == [3, 3, 2, 2]
    assert bal.waterfill_counts(0, 3).tolist() == [0, 0, 0]
    assert bal.waterfill_counts(2, 5).tolist() == [1, 1, 0, 0, 0]
    for total, m in ((17, 8), (8, 17), (1, 1)):
        c = bal.waterfill_counts(total, m)
        assert c.sum() == total
        assert c.max() - c.min() <= 1


# ------------------------------------------- atomic save / integrity


def test_save_rotates_last_good(tmp_path):
    inst, opt, tables = _setup()
    state = _mid_state(inst, opt, tables)
    path = tmp_path / "c.npz"
    checkpoint.save(path, state, meta={"segment": 1})
    assert not checkpoint.last_good_path(path).exists()
    checkpoint.save(path, device.run(tables, state, 1, 8, max_iters=5),
                    meta={"segment": 2})
    prev = checkpoint.last_good_path(path)
    assert prev.exists()
    assert int(checkpoint.load(path, device="cpu")[1]["segment"]) == 2
    assert int(checkpoint.load(prev, device="cpu")[1]["segment"]) == 1
    assert not path.with_suffix(".tmp.npz").exists()


def _two_saves(tmp_path, inst, opt, tables):
    """Segment 1's snapshot, then segment 2's (rotating 1 to last-good)."""
    state = _mid_state(inst, opt, tables)
    path = tmp_path / "c.npz"
    checkpoint.save(path, state, meta={"segment": 1})
    state = device.run(tables, state, 1, 8, max_iters=5)
    checkpoint.save(path, state, meta={"segment": 2})
    return path, state


def test_truncated_checkpoint_rolls_back(tmp_path):
    inst, opt, tables = _setup()
    path, _ = _two_saves(tmp_path, inst, opt, tables)
    data = path.read_bytes()
    path.write_bytes(data[:len(data) // 3])       # torn write
    with pytest.raises(checkpoint.CheckpointCorrupt):
        checkpoint.load(path, device="cpu")
    with pytest.warns(RuntimeWarning, match="last-good"):
        st, meta, used = checkpoint.load_resilient(path, device="cpu")
    assert used == checkpoint.last_good_path(path)
    assert int(meta["segment"]) == 1
    assert _totals(device.run(tables, st, 1, 8)) == _want(inst, opt)


def test_flipped_bytes_roll_back(tmp_path):
    inst, opt, tables = _setup()
    path, _ = _two_saves(tmp_path, inst, opt, tables)
    faults.corrupt_file(path)
    with pytest.raises(checkpoint.CheckpointCorrupt):
        checkpoint.load(path, device="cpu")
    with pytest.warns(RuntimeWarning, match="last-good"):
        _, meta, _ = checkpoint.load_resilient(path, device="cpu")
    assert int(meta["segment"]) == 1


def test_embedded_crc_catches_valid_zip_with_wrong_payload(tmp_path):
    """Damage the zip container cannot see (a member rewritten whole)
    still fails the embedded payload CRC."""
    inst, opt, tables = _setup()
    path = tmp_path / "c.npz"
    checkpoint.save(path, _mid_state(inst, opt, tables))
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["best"] = np.asarray(arrays["best"] - 1)   # silent bit rot
    np.savez_compressed(path, **arrays)               # valid zip again
    with pytest.raises(checkpoint.CheckpointCorrupt, match="CRC32"):
        checkpoint.load(path, device="cpu")


def test_future_schema_version_fails_clearly(tmp_path):
    inst, opt, tables = _setup()
    state = _mid_state(inst, opt, tables)
    path = tmp_path / "c.npz"
    checkpoint.save(path, state, meta={"segment": 1})
    checkpoint.save(path, state, meta={"segment": 2})
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["meta_schema_version"] = np.asarray(checkpoint.SCHEMA_VERSION + 1)
    np.savez_compressed(path, **arrays)
    with pytest.raises(checkpoint.CheckpointSchemaError,
                       match="schema version"):
        checkpoint.load(path, device="cpu")
    # not shadowed by the older last-good snapshot
    with pytest.raises(checkpoint.CheckpointSchemaError):
        checkpoint.load_resilient(path, device="cpu")


def test_interrupted_write_uses_last_good(tmp_path):
    """Crash between the two renames: temp file present, current file
    missing, last-good holds the previous snapshot."""
    inst, opt, tables = _setup()
    path = tmp_path / "c.npz"
    checkpoint.save(path, _mid_state(inst, opt, tables), meta={"segment": 1})
    os.replace(path, checkpoint.last_good_path(path))
    path.with_suffix(".tmp.npz").write_bytes(b"half-written garbage")
    assert checkpoint.resume_path(path) == checkpoint.last_good_path(path)
    st, meta, used = checkpoint.load_resilient(path, device="cpu")
    assert used == checkpoint.last_good_path(path)
    assert int(meta["segment"]) == 1
    assert _totals(device.run(tables, st, 1, 8)) == _want(inst, opt)


def test_corrupt_current_is_quarantined_not_rotated(tmp_path):
    """A skipped corrupt current file is renamed aside, so the next save
    keeps the GOOD segment-1 snapshot as last-good."""
    inst, opt, tables = _setup()
    path, _ = _two_saves(tmp_path, inst, opt, tables)
    faults.corrupt_file(path)
    with pytest.warns(RuntimeWarning, match="last-good"):
        st, meta, _ = checkpoint.load_resilient(path, device="cpu")
    assert int(meta["segment"]) == 1
    assert not path.exists()
    assert path.with_name(path.name + ".corrupt").exists()
    checkpoint.save(path, device.run(tables, st, 1, 8, max_iters=5),
                    meta={"segment": 3})
    prev = checkpoint.last_good_path(path)
    assert int(checkpoint.load(prev, device="cpu")[1]["segment"]) == 1
    assert int(checkpoint.load(path, device="cpu")[1]["segment"]) == 3


def test_everything_corrupt_raises_clear_error(tmp_path):
    inst, opt, tables = _setup()
    state = _mid_state(inst, opt, tables)
    path = tmp_path / "c.npz"
    checkpoint.save(path, state, meta={"segment": 1})
    checkpoint.save(path, state, meta={"segment": 2})
    faults.corrupt_file(path)
    faults.corrupt_file(checkpoint.last_good_path(path))
    with pytest.warns(RuntimeWarning):
        with pytest.raises(checkpoint.CheckpointCorrupt,
                           match="no loadable checkpoint"):
            checkpoint.load_resilient(path, device="cpu")


# ------------------------------------------------------ reshard


def test_reshard_preserves_totals_and_rows():
    inst, opt, tables = _setup()
    state = _mid_state(inst, opt, tables)

    def live_rows(s):
        a = {f: getattr(s, f).numpy() for f in s._fields}
        if a["prmu"].ndim == 2:
            a = {f: x[None, ...] for f, x in a.items()}
        rows = []
        for d in range(a["prmu"].shape[0]):
            for r in range(int(np.atleast_1d(a["size"])[d])):
                rows.append((tuple(a["prmu"][d, :, r].tolist()),
                             int(a["depth"][d, r]),
                             tuple(a["aux"][d, :, r].tolist())))
        return sorted(rows)

    before = live_rows(state)
    c = device.counters(state)
    for m in (1, 3, 5, 8):
        out = checkpoint.reshard_state(state, m, device="cpu")
        assert out.prmu.shape[0] == m
        assert int(out.size.max() - out.size.min()) <= 1   # water-filled
        assert live_rows(out) == before                    # no node lost
        assert (int(out.tree.sum()), int(out.sol.sum()),
                int(out.evals.sum()), int(out.best.min())) == \
            (c.tree, c.sol, c.evals, c.best)
        assert (out.iters == c.iters).all()
        assert not out.overflow.any()
    # squeeze round-trips to the single-device shape device.run takes
    back = checkpoint.reshard_state(
        checkpoint.reshard_state(state, 5, device="cpu"), 1, squeeze=True,
        device="cpu")
    assert back.prmu.dim() == 2
    assert live_rows(back) == before
    assert _totals(device.run(tables, back, 1, 8)) == _want(inst, opt)


# ------------------------------------- retry / watchdog / fault harness


def test_fault_spec_parsing():
    plan = faults.FaultPlan.parse(
        "kill_after_segment=3, corrupt_checkpoint=2,"
        "delay_segment=4:0.25,fail_host_fetch=2,pause_server=1:0.2")
    assert plan.kill_after_segment == 3
    assert plan.corrupt_checkpoint == 2
    assert plan.delay_segment == (4, 0.25)
    assert plan.fail_host_fetch == 2
    assert plan.pause_server == (1, 0.2, None)
    with pytest.raises(ValueError, match="unknown fault"):
        faults.FaultPlan.parse("tip_over_rack=1")


def test_transient_fetch_failures_are_retried(fault_plan):
    inst, opt, tables = _setup()
    fault_plan("fail_host_fetch=2")
    with pytest.warns(RuntimeWarning, match="transient"):
        final = checkpoint.run_segmented(_run_fn(tables), _init(inst, opt),
                                         segment_iters=4, heartbeat=None,
                                         retry_base_s=0.01)
    assert _totals(final) == _want(inst, opt)


def test_retry_gives_up_after_attempts(fault_plan):
    inst, opt, tables = _setup()
    fault_plan("fail_host_fetch=100")
    with pytest.warns(RuntimeWarning, match="transient"):
        with pytest.raises(faults.InjectedFault):
            checkpoint.run_segmented(_run_fn(tables), _init(inst, opt),
                                     segment_iters=4, heartbeat=None,
                                     retry_attempts=2, retry_base_s=0.01)


def test_segment_watchdog_times_out():
    inst, opt, tables = _setup()
    calls = []

    def hung_run_fn(s, target):
        calls.append(target)
        time.sleep(3)
        return s

    with pytest.raises(checkpoint.SegmentTimeout, match="watchdog"):
        checkpoint.run_segmented(hung_run_fn, _mid_state(inst, opt, tables),
                                 segment_iters=4, heartbeat=None,
                                 segment_timeout_s=0.2, retry_attempts=3)
    assert len(calls) == 1                     # a timeout is never retried


def test_delay_segment_injection(fault_plan):
    inst, opt, tables = _setup()
    fault_plan("delay_segment=1:0.3")
    t0 = time.perf_counter()
    checkpoint.run_segmented(_run_fn(tables), _init(inst, opt),
                             segment_iters=4, heartbeat=None, max_segments=1)
    assert time.perf_counter() - t0 >= 0.3


def test_corrupt_checkpoint_injection_rolls_back(fault_plan, tmp_path):
    """The corrupt-checkpoint injection tears the file written at segment
    2; the resume lands on segment 1's last-good snapshot and still
    finishes to the exact oracle totals."""
    inst, opt, tables = _setup()
    fault_plan("corrupt_checkpoint=2")
    path = tmp_path / "c.npz"
    part = checkpoint.run_segmented(_run_fn(tables, 2), _init(inst, opt),
                                    segment_iters=1,
                                    checkpoint_path=str(path),
                                    heartbeat=None, max_segments=2)
    assert device.counters(part).size > 0, "run finished inside 2 segments"
    faults.reset()
    with pytest.raises(checkpoint.CheckpointCorrupt):
        checkpoint.load(path, device="cpu")
    with pytest.warns(RuntimeWarning, match="last-good"):
        st, meta, _ = checkpoint.load_resilient(path, device="cpu")
    assert int(meta["segment"]) == 1
    final = checkpoint.run_segmented(_run_fn(tables, 2), st,
                                     segment_iters=64, heartbeat=None)
    assert _totals(final) == _want(inst, opt)


def test_pause_server_is_a_plain_wedge_without_service(fault_plan):
    """`pause_server` reaches `service.lease`, which the port lacks: the
    drill sleeps at its segment (once) and changes no count."""
    inst, opt, tables = _setup()
    clean = checkpoint.run_segmented(_run_fn(tables), _init(inst, opt),
                                     segment_iters=2, heartbeat=None)
    fault_plan("pause_server=1:0.2")
    t0 = time.perf_counter()
    paused = checkpoint.run_segmented(_run_fn(tables), _init(inst, opt),
                                      segment_iters=2, heartbeat=None)
    assert time.perf_counter() - t0 >= 0.2
    assert faults.active().pauses_fired == 1
    assert device.counters(paused) == device.counters(clean)


def test_overlap_is_refused(tmp_path):
    """Once a refusal, now a run: `run_segmented(overlap=True)` (the
    pipelined driver, its checkpoints on the writer thread) against the
    synchronous driver on one device, with a checkpoint every segment: the
    same final state and file, the oracle's totals, and every segment
    report but its wall-clock field, segment by segment (the pipelined
    driver's last report is the drained no-op segment's, with the same
    counts)."""
    inst, opt, tables = _setup()
    runs = []
    for overlap in (False, True):
        reports = []
        path = tmp_path / f"overlap{int(overlap)}.npz"
        out = checkpoint.run_segmented(
            _run_fn(tables), _init(inst, opt), segment_iters=2,
            heartbeat=reports.append, overlap=overlap,
            checkpoint_path=str(path))
        rows = [{**dataclasses.asdict(r), "elapsed": 0} for r in reports]
        runs.append((out, rows, checkpoint.load(path, device="cpu")[0]))
    (off, r_off, f_off), (on, r_on, f_on) = runs
    assert device.counters(on) == device.counters(off)
    assert device.counters(f_on) == device.counters(f_off)
    assert _totals(on) == _want(inst, opt)
    assert r_on[:len(r_off)] == r_off
    assert [{**r, "segment": 0} for r in r_on[len(r_off):]] == \
        [{**r_off[-1], "segment": 0}] * (len(r_on) - len(r_off))


# --------------------------------------- retry of a segment run in place


def test_segment_retry_restores_the_pool_run_updated_in_place():
    """`device.run` writes the pool in place. A segment that stepped and
    then failed with a transient error is retried from the device copy
    `run_segmented` took before it, so the retry redoes the same work:
    the totals are the oracle's, not those of a run that lost or doubled
    a segment."""
    inst, opt, tables = _setup()
    failed = []

    def run_fn(state, target):
        out = device.run(tables, state, 1, 8, max_iters=target)
        if not failed:
            failed.append(device.counters(out))
            raise faults.InjectedFault("after the segment stepped")
        return out

    with pytest.warns(RuntimeWarning, match="segment execution"):
        final = checkpoint.run_segmented(run_fn, _init(inst, opt),
                                         segment_iters=2, heartbeat=None,
                                         retry_base_s=0.0)
    assert failed[0].iters == 2 and failed[0].tree > 0   # it had stepped
    assert _totals(final) == _want(inst, opt)


@pytest.mark.parametrize("error", [
    torch.AcceleratorError("CUDA error: an illegal memory access was "
                           "encountered"),
    RuntimeError("CUDA error: unspecified launch failure")])
def test_cuda_runtime_error_is_not_retried(error):
    """A CUDA runtime error poisons the context: it propagates at once."""
    inst, opt, tables = _setup()
    calls = []

    def run_fn(state, target):
        calls.append(target)
        raise error

    with pytest.raises(RuntimeError, match="CUDA error"):
        checkpoint.run_segmented(run_fn, _init(inst, opt), heartbeat=None,
                                 retry_attempts=3, retry_base_s=0.0)
    assert len(calls) == 1


def test_allocation_failure_is_retried():
    """An allocation that failed (raised before any launch) is transient."""
    inst, opt, tables = _setup()
    calls = []

    def run_fn(state, target):
        calls.append(target)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return device.run(tables, state, 1, 8, max_iters=target)

    with pytest.warns(RuntimeWarning, match="transient"):
        final = checkpoint.run_segmented(run_fn, _init(inst, opt),
                                         segment_iters=4, heartbeat=None,
                                         retry_base_s=0.0)
    assert calls[0] == calls[1]
    assert _totals(final) == _want(inst, opt)


# ------------------------------------------------------------ retry helper


class Boom(RuntimeError):
    pass


class Other(RuntimeError):
    pass


def test_retry_success_passthrough():
    calls = []
    assert retry.retry_call(lambda: calls.append(1) or 42,
                            transient=(Boom,)) == 42
    assert len(calls) == 1


def test_retry_transient_with_exponential_backoff():
    delays = []
    attempts = {"n": 0}

    def flaky():
        attempts["n"] += 1
        if attempts["n"] < 3:
            raise Boom("transient")
        return "ok"

    out = retry.retry_call(flaky, attempts=4, base_s=0.5,
                           transient=(Boom,),
                           on_retry=lambda a, d, e: delays.append(d),
                           sleep=lambda s: None)
    assert out == "ok"
    assert attempts["n"] == 3
    assert delays == [0.5, 1.0]        # base * 2**k, no jitter


def test_retry_non_transient_propagates_immediately():
    attempts = {"n": 0}

    def bad():
        attempts["n"] += 1
        raise Other("deterministic")

    with pytest.raises(Other):
        retry.retry_call(bad, attempts=5, transient=(Boom,),
                         sleep=lambda s: None)
    assert attempts["n"] == 1


def test_retry_exhaustion_reraises_last_transient():
    attempts = {"n": 0}

    def always():
        attempts["n"] += 1
        raise Boom(f"try {attempts['n']}")

    with pytest.raises(Boom, match="try 3"):
        retry.retry_call(always, attempts=3, transient=(Boom,),
                         on_retry=lambda a, d, e: None,
                         sleep=lambda s: None)
    assert attempts["n"] == 3


def test_retry_attempts_floor_is_one():
    attempts = {"n": 0}

    def always():
        attempts["n"] += 1
        raise Boom("x")

    with pytest.raises(Boom):
        retry.retry_call(always, attempts=0, transient=(Boom,),
                         sleep=lambda s: None)
    assert attempts["n"] == 1


def test_retry_default_on_retry_warns():
    state = {"n": 0}

    def flaky():
        state["n"] += 1
        if state["n"] == 1:
            raise Boom("once")
        return 1

    with pytest.warns(RuntimeWarning, match="transient widget failure"):
        assert retry.retry_call(flaky, what="widget", attempts=2,
                                base_s=0.0, transient=(Boom,)) == 1


def test_retry_backoff_schedule():
    assert retry.backoff_delays(4, 0.25) == [0.25, 0.5, 1.0]
    assert retry.backoff_delays(1, 0.25) == []
    assert retry.backoff_delay(3, 0.5) == 4.0


def test_checkpoint_retry_uses_shared_helper():
    """checkpoint._retry is the shared helper bound to TRANSIENT_ERRORS
    (injected faults retry; ValueError does not)."""
    state = {"n": 0}

    def flaky():
        state["n"] += 1
        if state["n"] == 1:
            raise faults.InjectedFault("transient")
        return "ok"

    with pytest.warns(RuntimeWarning):
        assert checkpoint._retry(flaky, "op", 3, 0.0) == "ok"
    with pytest.raises(ValueError):
        checkpoint._retry(lambda: (_ for _ in ()).throw(ValueError("x")),
                          "op", 3, 0.0)


def test_knobs_are_registered(monkeypatch):
    """The env knobs read the JAX spellings and defaults; an unregistered
    TTS_* name raises at its first read or write."""
    assert config.env_int("TTS_RETRY_ATTEMPTS") == 3
    assert config.env_float("TTS_SEG_TIMEOUT_S") == 0.0
    monkeypatch.setenv("TTS_RETRY_BASE_S", "bad")
    assert config.env_float("TTS_RETRY_BASE_S") == 0.5
    config.set_env("TTS_RETRY_ATTEMPTS", 5)
    assert config.env_int("TTS_RETRY_ATTEMPTS") == 5
    monkeypatch.delenv("TTS_RETRY_ATTEMPTS")
    with pytest.raises(KeyError, match="unregistered"):
        config.env_int("TTS_RETRY_ATTEMPTZ")
    with pytest.raises(KeyError, match="unregistered"):
        config.set_env("TTS_NOPE", 1)


# --------------------------------------------------------------------- CLI


def _cli(main, argv):
    """rc, stdout and stderr of one in-process CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _segment_lines(text):
    """The `[segment k]` lines without their wall time."""
    return [ln.rsplit(" t=", 1)[0] for ln in text.splitlines()
            if ln.startswith("[segment ")]


def _result(text):
    return tuple(int(ln.rsplit(": ", 1)[1]) for ln in text.splitlines()
                 if ln.startswith(("Size of the explored tree",
                                   "Number of explored solutions",
                                   "Optimal makespan")))


# ta003 LB2 at chunk 4096 takes 34 steps: few, wide steps keep the CPU
# runs short on a loaded host
TA003 = ["pfsp", "-i", "3", "-l", "2", "-u", "1", "--chunk", "4096",
         "--segment-iters", "5"]
GOLDEN_TA003 = (80062, 0, 1081)


TA002 = ["pfsp", "-i", "2", "-l", "1", "-u", "1", "--segment-iters", "2"]
GOLDEN_TA002 = (30, 0, 1359)


def test_cli_stop_and_resume_matches_jax_cli(tmp_path):
    """ta002 LB1 stopped after 4 steps and resumed, through the port's CLI
    and the JAX CLI on one device, each resuming its own checkpoint and
    the other's: every run prints the same `[segment k]` lines (up to the
    wall time) and `Resumed from` at the same point, and ends at the
    golden."""
    import shutil

    from tpu_tree_search import cli as jcli

    clis = {"port": (cli.main, ["--device", "cpu"]),
            "jax": (jcli.main, ["-D", "1"])}
    stops, resumes = {}, {}
    for name, (main, extra) in clis.items():
        ck = tmp_path / f"{name}.npz"
        rc, out, _ = _cli(main, TA002 + extra + [
            "--checkpoint", str(ck), "--max-iters", "4"])
        assert rc == 0 and "truncated run" in out, name
        stops[name] = _segment_lines(out)
        shutil.copy(ck, tmp_path / f"{name}_copy.npz")
    for name, (main, extra) in clis.items():
        for origin in clis:
            ck = tmp_path / (f"{origin}.npz" if origin == name
                             else f"{origin}_copy.npz")
            rc, out, _ = _cli(main, TA002 + extra + ["--checkpoint",
                                                     str(ck)])
            assert rc == 0 and _result(out) == GOLDEN_TA002, (name, origin)
            assert f"Resumed from {ck} (segment 2, iters 4, pool" in out
            resumes[name, origin] = _segment_lines(out)
    assert stops["port"] == stops["jax"] and len(stops["port"]) == 2
    assert len(set(map(tuple, resumes.values()))) == 1
    assert len(resumes["port", "port"]) == 2


def test_cli_overflow_then_grow_capacity(tmp_path):
    """Too small a pool: `error: pool overflow ...` and exit 1, with the
    state checkpointed; `--grow-capacity` resumes it to the golden."""
    ck = str(tmp_path / "o.npz")
    args = TA003 + ["--device", "cpu", "--checkpoint", ck]
    rc, _, err = _cli(cli.main, args + ["--capacity", "82944"])
    assert rc == 1 and "error: pool overflow" in err
    rc, out, _ = _cli(cli.main, args + ["--capacity", "82944",
                                        "--grow-capacity", "1048576"])
    assert rc == 0 and "Resumed from" in out
    assert _result(out) == GOLDEN_TA003


def test_cli_corrupt_checkpoint_rolls_back(tmp_path):
    ck = str(tmp_path / "r.npz")
    args = TA003 + ["--device", "cpu", "--checkpoint", ck]
    rc, _, _ = _cli(cli.main, args + ["--max-iters", "10",
                                      "--faults", "corrupt_checkpoint=2"])
    assert rc == 0 and faults.active() is None    # the plan was the call's
    with pytest.warns(RuntimeWarning, match="last-good"):
        rc, out, _ = _cli(cli.main, args)
    assert rc == 0 and "(segment 1, iters 5," in out
    assert _result(out) == GOLDEN_TA003
    assert os.path.exists(ck + ".corrupt")


def test_cli_refuses_a_host_tier_checkpoint(tmp_path):
    """A checkpoint holding nodes of the -C host tier (meta host_prmu/
    host_depth) is resumed without that tier: the nodes go back into the
    pool, none is lost, and the run ends at the ta003 golden. (The port
    refused such a checkpoint before it had the host tier; the name is
    kept.)"""
    from tpu_tree_search_torch.engine import distributed, hybrid
    from tpu_tree_search_torch.problems import taillard

    p = taillard.processing_times(3)
    fr = distributed.bfs_warmup(p, 2, 1081, target=64)
    dmask, h_prmu, h_depth = hybrid.split_host_share(fr.prmu, fr.depth, 4)
    assert len(h_depth) > 0
    state = device.init_state(20, 1 << 20, 1081, prmu0=fr.prmu[dmask],
                              depth0=fr.depth[dmask], p_times=p,
                              device="cpu")
    ck = tmp_path / "h.npz"
    checkpoint.save(ck, state, meta={
        "warmup_tree": fr.tree, "warmup_sol": fr.sol,
        "host_prmu": h_prmu, "host_depth": h_depth})
    rc, out, _ = _cli(cli.main, TA003 + ["--device", "cpu",
                                         "--checkpoint", str(ck)])
    assert rc == 0
    assert f"iters 0, pool {len(fr.depth)})" in out
    assert _result(out) == GOLDEN_TA003


def test_cli_kill_after_segment_then_resume(tmp_path):
    """`--faults kill_after_segment=2` ends the process with exit 137 after
    segment 2's checkpoint (a preemption); the same command without it
    resumes to the ta002 golden."""
    ck = str(tmp_path / "k.npz")
    cmd = [sys.executable, "-m", "tpu_tree_search_torch", "pfsp", "-i", "2",
           "-l", "1", "-u", "1", "--device", "cpu", "--segment-iters", "1",
           "--checkpoint", ck]
    env = {**os.environ, "PYTHONPATH": REPO}
    killed = subprocess.run(cmd + ["--faults", "kill_after_segment=2"],
                            env=env, cwd=REPO, timeout=300,
                            capture_output=True, text=True)
    assert killed.returncode == faults.KILL_EXIT_CODE, killed.stderr
    assert "[segment 2]" in killed.stdout and "[segment 3]" not in \
        killed.stdout
    done = subprocess.run(cmd, env=env, cwd=REPO, timeout=300,
                          capture_output=True, text=True)
    assert done.returncode == 0, done.stderr
    assert "Resumed from" in done.stdout and "(segment 2, iters 2," in \
        done.stdout
    assert _result(done.stdout) == (30, 0, 1359)
