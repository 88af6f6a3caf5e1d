"""The port's progress estimator against the JAX package's.

The `SegmentReport`s of a small segmented PFSP search, with telemetry on
and off, are the same in both packages but for their wall clocks; fed
with the same reports (the port's `elapsed` on both sides), the two
estimators give the same sequence of readiness, progress, total, ETA,
snapshot and state vector (relative tolerance 1e-12), with and without a
depth hint; `to_list` of one package continues in the other's
`from_list`, and both refuse the same foreign vectors. After the pool
drains and `finalize`, the estimate is the explored tree."""

import math

import pytest

from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.obs import estimate as jest
from tpu_tree_search.parallel.mesh import worker_mesh
from tpu_tree_search_torch.engine import distributed as tdist
from tpu_tree_search_torch.obs import estimate as test_
from tpu_tree_search_torch.problems.pfsp import PFSPInstance

import _torch_isolation
import _torch_threads

_torch_threads.share_cores()

REL = 1e-12
FIELDS = ("segment", "iters", "tree", "sol", "best", "pool_size", "evals",
          "telemetry")


@pytest.fixture(autouse=True)
def iso():
    with _torch_isolation.isolated():
        yield


@pytest.fixture(scope="module", params=[False, True],
                ids=["telemetry_off", "telemetry_on"])
def reports(request):
    """(JAX's reports, the port's reports, the port's result) of one
    segmented search on two workers."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TTS_SEARCH_TELEMETRY", "1" if request.param else "0")
    table = PFSPInstance.synthetic(10, 4, 2).p_times
    kw = dict(lb_kind=1, chunk=32, capacity=1 << 14, min_seed=4,
              segment_iters=4)
    try:
        with _torch_isolation.isolated():
            reps_j, reps_t = [], []
            jdist.search(table, mesh=worker_mesh(2),
                         heartbeat=reps_j.append, **kw)
            res = tdist.search(table, devices=["cpu"] * 2,
                               heartbeat=reps_t.append, **kw)
    finally:
        mp.undo()
    assert (reps_t[-1].telemetry is not None) == request.param
    return reps_j, reps_t, res


def close(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(a, b, rel_tol=REL, abs_tol=0.0) or a == b
    return a == b


def reading(est) -> dict:
    return {"ready": est.ready, "progress": est.progress,
            "est_total": est.est_total, "eta_s": est.eta_s(),
            "eta_fallback": est.eta_s(fallback_rate=1e6),
            "snapshot": est.snapshot(fallback_rate=1e6),
            "state": est.to_list()}


def feed(est, rep, elapsed: float) -> bool:
    return est.update(tree=rep.tree, pool=rep.pool_size, elapsed=elapsed,
                      telemetry=rep.telemetry)


def test_reports_match_jax_but_for_wall_clock(reports):
    reps_j, reps_t, _ = reports
    assert len(reps_t) == len(reps_j) > 8
    for rj, rt in zip(reps_j, reps_t):
        assert {f: getattr(rt, f) for f in FIELDS} == \
            {f: getattr(rj, f) for f in FIELDS}


@pytest.mark.parametrize("kw", [
    dict(), dict(warmup_segments=2, warmup_nodes=50),
    dict(warmup_segments=1, warmup_nodes=0, alpha=0.5, depth_hint=10)],
    ids=["defaults", "short_warmup", "depth_hint"])
def test_estimator_sequences_match_jax(reports, kw):
    reps_j, reps_t, res = reports
    ej, et = jest.ProgressEstimator(**kw), test_.ProgressEstimator(**kw)
    seq_j, seq_t = [], []
    for rj, rt in zip(reps_j, reps_t):
        seq_j.append((feed(ej, rj, rt.elapsed), reading(ej)))
        seq_t.append((feed(et, rt, rt.elapsed), reading(et)))
    assert close(seq_t, seq_j)
    for e in (ej, et):
        e.finalize()
    assert close(reading(et), reading(ej))
    # the pool drained: nothing remains, the estimate is the tree
    assert reps_t[-1].pool_size == 0
    assert et.est_total == reps_t[-1].tree == \
        res.explored_tree - res.warmup_tree
    assert et.progress == 1.0 and et.eta_s() == 0.0


def test_state_vector_crosses_packages(reports):
    """Half the reports into one package's estimator; its `to_list` read
    back by both packages' `from_list` (a restored estimator is on a new
    dispatch: its rate clock restarts), and the rest into both: the same
    readings."""
    reps_j, reps_t, _ = reports
    half = len(reps_t) // 2
    kw = dict(warmup_segments=2, warmup_nodes=50, depth_hint=10)
    for src in (jest, test_):
        a = src.ProgressEstimator(**kw)
        for rt in reps_t[:half]:
            feed(a, rt, rt.elapsed)
        vec = a.to_list()
        bj = jest.ProgressEstimator.from_list(vec, **kw)
        bt = test_.ProgressEstimator.from_list(vec, **kw)
        assert close(bt.to_list(), bj.to_list())
        assert close(bt.to_list()[:8], vec[:8])
        t0 = reps_t[half - 1].elapsed
        for rt in reps_t[half:]:
            feed(bj, rt, rt.elapsed - t0)
            feed(bt, rt, rt.elapsed - t0)
            assert close(reading(bt), reading(bj))


@pytest.mark.parametrize("vec", [[], [2.0] * 11, [1.0] * 9, ["x"] * 11,
                                 None])
def test_foreign_vectors_refused_alike(vec):
    assert test_.ProgressEstimator.from_list(vec) is None
    assert jest.ProgressEstimator.from_list(vec) is None


def test_defaults_come_from_the_same_knobs(monkeypatch):
    for env in ({}, {"TTS_PROGRESS_WARMUP_SEGMENTS": "5",
                     "TTS_PROGRESS_WARMUP_NODES": "77",
                     "TTS_PROGRESS_EWMA": "0.9"}):
        for k in ("TTS_PROGRESS_WARMUP_SEGMENTS",
                  "TTS_PROGRESS_WARMUP_NODES", "TTS_PROGRESS_EWMA"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        j, t = jest.ProgressEstimator(), test_.ProgressEstimator()
        assert (t.warmup_segments, t.warmup_nodes, t.alpha) == (
            j.warmup_segments, j.warmup_nodes, j.alpha)
    assert test_.DEPTH_BUCKETS == jest.DEPTH_BUCKETS
