"""The port's `obs/profiler.py` and `profile` command against the JAX
package's.

Mirrors `tests/test_profiling.py`'s session tests on the CPU: one capture
at a time (a second `start` raises `ProfilerBusyError` and leaves the
first running; `stop` with no capture raises), `fresh_dir` reserves a
unique directory even when threads race for one, and each finished
capture emits one `profiler.capture` event and one
`tts_profile_captures_total` increment, in the same schema as JAX's for
the same calls. The `profile` command at a small size prints JAX's JSON
keys and counts exactly the iterations and evaluations that the same
steps take without the profiler, and `profile_step` goes through the
same session (a capture held elsewhere makes it wait its turn by raising
`ProfilerBusyError`, as JAX's tools do)."""

import contextlib
import io
import json
import threading

import pytest

from tpu_tree_search.obs import metrics as jmetrics
from tpu_tree_search.obs import profiler as jprofiler
from tpu_tree_search.obs import tracelog as jtracelog
from tpu_tree_search_torch import cli, profile_step
from tpu_tree_search_torch.engine import device
from tpu_tree_search_torch.obs import metrics, profiler, tracelog
from tpu_tree_search_torch.ops import batched
from tpu_tree_search_torch.problems import taillard

import _torch_isolation
import _torch_threads

_torch_threads.share_cores()

# the JSON keys of JAX's `run_profile` line (tpu_tree_search/cli.py)
JAX_PROFILE_KEYS = {"artifact", "inst", "lb", "iters", "evals",
                    "device_self_ms", "buckets_ms"}


@pytest.fixture(autouse=True)
def iso():
    with _torch_isolation.isolated():
        yield


def captures(log) -> list[dict]:
    return [r for r in log.records() if r["name"] == "profiler.capture"]


def test_one_capture_at_a_time(tmp_path):
    sess = profiler.ProfilerSession(registry=metrics.Registry())
    with pytest.raises(RuntimeError, match="no profiler capture"):
        sess.stop()
    d1 = sess.fresh_dir(tmp_path)
    assert sess.start(d1) == d1 and sess.active and sess.log_dir == d1
    with pytest.raises(profiler.ProfilerBusyError):
        sess.start(sess.fresh_dir(tmp_path))
    # the first capture runs on, untouched
    assert sess.active and sess.log_dir == d1
    assert sess.stop() == d1 and not sess.active
    with pytest.raises(RuntimeError):
        sess.stop()
    # released: the next capture works
    with sess.trace(sess.fresh_dir(tmp_path)):
        pass
    assert not sess.active


def test_fresh_dir_unique_under_racing_threads(tmp_path):
    sess = profiler.ProfilerSession()
    got, barrier = [], threading.Barrier(8)

    def grab():
        barrier.wait()
        got.append(sess.fresh_dir(tmp_path))

    threads = [threading.Thread(target=grab) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(got) == len(set(got)) == 8
    assert all((tmp_path / p).is_dir() for p in got)


def test_event_and_counter_as_jax(tmp_path):
    """Two captures: two `profiler.capture` events (the first naming its
    directory) and the counter at 2, in both packages; the events hold
    the same keys."""
    out = {}
    for name, prof_mod, log_mod, reg_mod in (
            ("torch", profiler, tracelog, metrics),
            ("jax", jprofiler, jtracelog, jmetrics)):
        log = log_mod.TraceLog(capacity=1 << 10)
        prev_log = log_mod.install(log)
        reg = reg_mod.Registry()
        prev_reg = reg_mod.install(reg)
        try:
            sess = prof_mod.ProfilerSession()
            root = tmp_path / name
            d1 = sess.fresh_dir(root)
            with sess.trace(d1):
                pass
            sess.capture(0.01, sess.fresh_dir(root))
        finally:
            log_mod.install(prev_log)
            reg_mod.install(prev_reg)
        caps = captures(log)
        assert len(caps) == 2 and caps[0]["logdir"] == d1
        assert reg.counter("tts_profile_captures_total").value() == 2
        out[name] = [sorted(c) for c in caps]
    assert out["torch"] == out["jax"]


def test_the_process_session_is_one():
    assert profiler.session() is profiler.session()
    sess = profiler.session()
    assert not sess.active


def profile_json(argv) -> dict:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    assert rc == 0, err.getvalue()
    text = out.getvalue()
    line = json.loads(text.splitlines()[0])
    assert "# top ops by device self-time" in text
    assert f"# artifact: {line['artifact']}" in text
    return line


def test_profile_command_on_the_cpu(tmp_path):
    line = profile_json(["profile", "-i", "3", "-l", "1", "--chunk", "16",
                         "--capacity", "4096", "--warm", "3", "--iters",
                         "4", "--top", "5", "--out", str(tmp_path),
                         "--device", "cpu"])
    assert set(line) == JAX_PROFILE_KEYS
    assert line["inst"] == 3 and line["lb"] == 1
    assert line["artifact"].startswith(str(tmp_path))
    # the window's counts are those of the same steps without a profiler
    p = taillard.processing_times(3)
    tables = batched.make_tables(p, device="cpu")
    state = device.init_state(p.shape[1], 4096, taillard.optimal_makespan(3),
                              p_times=p, device="cpu")
    state = device.run(tables, state, 1, 16, max_iters=3)
    warm = device.counters(state)
    done = device.counters(device.run(tables, state, 1, 16, max_iters=7))
    assert line["iters"] == done.iters - warm.iters == 4
    assert line["evals"] == done.evals - warm.evals > 0
    # on the CPU the self-times are the CPU ops', bucketed by JAX's names
    assert line["device_self_ms"] > 0
    assert set(line["buckets_ms"]) <= {"lb2_pair_sweep", "expand_kernel",
                                       "sort", "gather", "scatter_write",
                                       "copy_concat_pad", "other"}
    assert line["buckets_ms"].get("gather", 0) > 0


def test_profile_step_goes_through_the_one_session(tmp_path):
    sess = profiler.session()
    held = sess.start(sess.fresh_dir(tmp_path))
    try:
        with pytest.raises(profiler.ProfilerBusyError):
            profile_step.profile(2, 1, 64, 1 << 12, warm=2, steps=3,
                                 dev=device.resolve_device("cpu"))
    finally:
        assert sess.stop() == held
    out = profile_step.profile(2, 1, 64, 1 << 12, warm=2, steps=3,
                               dev=device.resolve_device("cpu"))
    assert out["steps"] == 3 and out["device_busy_share"] is None
