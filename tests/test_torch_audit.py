"""The port's result and reshard audits against the JAX package's.

`check_result` and `check_reshard` of both packages on the same result and
state give the same findings (invariant names and `ok` flags), on a sound
result and state and on ones with a tampered `tree`, `sent` or telemetry;
both packages' `distributed.search` audit every result, raising
`AuditError` under TTS_AUDIT_HARD=1 when the telemetry disagrees with the
counters; an elastic resume records `elastic_resume_conservation` in both;
and the findings ring keeps, filters and clears. Inputs are
`PFSPInstance.synthetic(7, 3, seed)` tables; exact (integer math)."""

import copy

import numpy as np
import pytest

from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.engine.device import SearchState as JState
from tpu_tree_search.obs import audit as jaudit
from tpu_tree_search.parallel.mesh import worker_mesh
from tpu_tree_search_torch import convert
from tpu_tree_search_torch.engine import distributed as tdist
from tpu_tree_search_torch.obs import audit as taudit
from tpu_tree_search_torch.problems.pfsp import PFSPInstance

import _torch_isolation
import _torch_threads

_torch_threads.share_cores()

D = 2
CPUS = ["cpu"] * D
KW = dict(chunk=8, capacity=1 << 12, min_seed=4)


@pytest.fixture(autouse=True)
def iso():
    with _torch_isolation.isolated():
        jaudit.clear_findings()
        taudit.clear_findings()
        yield


def outcomes(findings):
    return [(f.invariant, f.ok) for f in findings]


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    """A telemetry result of the port's search, and a stacked state."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TTS_SEARCH_TELEMETRY", "1")
    try:
        res = tdist.search(PFSPInstance.synthetic(7, 3, 1).p_times,
                           devices=CPUS, **KW)
        ck = tmp_path_factory.mktemp("audit") / "s.npz"
        tdist.search(PFSPInstance.synthetic(7, 3, 2).p_times, devices=CPUS,
                     segment_iters=8, checkpoint_path=str(ck),
                     should_stop=lambda rep: True, **KW)
    finally:
        mp.undo()
    from tpu_tree_search_torch.engine import checkpoint as tckpt
    state, _ = tckpt.load(ck, device="cpu")
    return res, state


@pytest.mark.parametrize("tamper", [None, "tree", "sent", "branched",
                                    "complete"])
def test_check_result_matches_jax(sound, tamper):
    res = copy.deepcopy(sound[0])
    if tamper == "tree":
        res.explored_tree += 1
    elif tamper == "sent":
        res.per_device["sent"] = res.per_device["sent"] + 1
    elif tamper == "branched":
        res.telemetry["branched"][0] += 1
    elif tamper == "complete":
        res.complete = not res.complete
    want = outcomes(jaudit.check_result(res))
    got = outcomes(taudit.check_result(res))
    assert got == want
    assert all(ok for _, ok in got) == (tamper is None)
    assert len(got) == 6      # conservation, drained, four telemetry


@pytest.mark.parametrize("tamper", [None, "tree", "sent", "best"])
def test_check_reshard_matches_jax(sound, tamper):
    state = sound[1]
    arrays = convert.state_to_numpy(state)
    before_t = taudit.state_sums(state)
    before_j = jaudit.state_sums(JState(**arrays))
    assert before_t == before_j
    after = dict(arrays)
    if tamper is not None:
        after[tamper] = after[tamper] + 1
    want = outcomes(jaudit.check_reshard(before_j, JState(**after),
                                         edge="elastic_resume"))
    got = outcomes(taudit.check_reshard(
        before_t, convert.state_from_numpy(after, "cpu"),
        edge="elastic_resume"))
    assert got == want
    assert {n for n, _ in got} == {"elastic_resume_conservation"}
    assert [ok for _, ok in got].count(False) == (tamper is not None)


def test_search_audits_every_result_and_raises_hard(monkeypatch):
    """A telemetry summary off by one from the counters: both packages'
    searches raise AuditError under TTS_AUDIT_HARD=1; without it the
    failure lands in the ring and the search returns."""
    monkeypatch.setenv("TTS_SEARCH_TELEMETRY", "1")
    table = PFSPInstance.synthetic(7, 3, 3).p_times
    for mod in (jdist, tdist):
        orig = mod.tele.summarize

        def off_by_one(arr, orig=orig):
            out = orig(arr)
            if out is not None:
                out["branched"][0] += 1
            return out

        monkeypatch.setattr(mod.tele, "summarize", off_by_one)
    monkeypatch.setenv("TTS_AUDIT_HARD", "1")
    with pytest.raises(jaudit.AuditError, match="branched_is_tree"):
        jdist.search(table, mesh=worker_mesh(D), **KW)
    with pytest.raises(taudit.AuditError, match="branched_is_tree"):
        tdist.search(table, devices=CPUS, **KW)
    monkeypatch.delenv("TTS_AUDIT_HARD")
    jaudit.clear_findings()
    taudit.clear_findings()
    res_j = jdist.search(table, mesh=worker_mesh(D), **KW)
    res_t = tdist.search(table, devices=CPUS, **KW)
    assert (res_t.explored_tree, res_t.best) == (res_j.explored_tree,
                                                 res_j.best)
    assert outcomes(taudit.findings()) == outcomes(jaudit.findings())
    failed = [f.invariant for f in taudit.recent_failures()]
    assert failed == ["branched_is_tree", "children_conservation",
                      "bound_hist_exact"]
    assert [f.invariant for f in taudit.recent_failures(60.0)] == failed


def test_search_result_findings_match_jax(monkeypatch):
    """A sound search records the same findings in both packages, all
    passing; `TTS_AUDIT=0` records none."""
    monkeypatch.setenv("TTS_SEARCH_TELEMETRY", "1")
    table = PFSPInstance.synthetic(7, 3, 4).p_times
    jdist.search(table, mesh=worker_mesh(D), **KW)
    tdist.search(table, devices=CPUS, **KW)
    got = outcomes(taudit.findings())
    assert got == outcomes(jaudit.findings()) and all(ok for _, ok in got)
    assert outcomes(taudit.findings(2)) == got[-2:]
    monkeypatch.setenv("TTS_AUDIT", "0")
    taudit.clear_findings()
    tdist.search(table, devices=CPUS, **KW)
    assert taudit.findings() == []


def test_elastic_resume_records_reshard_conservation(tmp_path):
    """A checkpoint of four workers resumed on two: both packages record
    `elastic_resume_conservation` for every summed quantity, all passing,
    and finish to the same totals."""
    table = PFSPInstance.synthetic(8, 3, 5).p_times
    opt = PFSPInstance.synthetic(8, 3, 5).brute_force_optimum()
    kw = dict(KW, init_ub=opt, segment_iters=8)
    ck = tmp_path / "e.npz"
    tdist.search(table, devices=["cpu"] * 4, checkpoint_path=str(ck),
                 should_stop=lambda rep: True, **kw)
    ck_j = tmp_path / "e_jax.npz"
    ck_j.write_bytes(ck.read_bytes())
    with pytest.warns(RuntimeWarning, match="resharding"):
        res_t = tdist.search(table, devices=CPUS, checkpoint_path=str(ck),
                             **kw)
    with pytest.warns(RuntimeWarning, match="resharding"):
        res_j = jdist.search(table, mesh=worker_mesh(D),
                             checkpoint_path=str(ck_j), **kw)
    assert (res_t.explored_tree, res_t.best, res_t.complete) == (
        res_j.explored_tree, res_j.best, True)

    def reshard(findings):
        return [(f.detail["quantity"], f.ok) for f in findings
                if f.invariant == "elastic_resume_conservation"]

    got = reshard(taudit.findings())
    assert got == reshard(jaudit.findings())
    assert {q for q, _ in got} >= {"size", "tree", "sol", "evals", "best"}
    assert all(ok for _, ok in got)


def test_findings_ring_is_bounded():
    for i in range(300):
        taudit.record("probe", i % 2 == 0, i=i)
    ring = taudit.findings()
    assert len(ring) == 256 and ring[-1].detail == {"i": 299}
    assert len(taudit.recent_failures()) == 128
    taudit.clear_findings()
    assert taudit.findings() == [] and taudit.recent_failures() == []


def test_arrays_sums_equal_state_sums(sound):
    state = sound[1]
    assert taudit.array_sums(convert.state_to_numpy(state)) == \
        taudit.state_sums(state)
    assert np.asarray(state.size).sum() == taudit.state_sums(state)["size"]


@pytest.mark.parametrize("tamper", [None, "tree", "sent", "evals",
                                    "telemetry", "off"])
def test_check_state_matches_jax(sound, tamper):
    """A state's telemetry against its own counters: the same findings,
    details and `edge` in both packages, sound and tampered; none without
    the telemetry vector."""
    from tpu_tree_search_torch.engine import telemetry as ttele

    arrays = dict(convert.state_to_numpy(sound[1]))
    if tamper == "telemetry":
        arrays["telemetry"] = arrays["telemetry"].copy()
        arrays["telemetry"][0, ttele.O_BRANCHED] += 1
    elif tamper == "off":
        arrays["telemetry"] = arrays["telemetry"][..., :0]
    elif tamper is not None:
        arrays[tamper] = arrays[tamper] + 1
    want = jaudit.check_state(JState(**arrays), edge="segment")
    got = taudit.check_state(convert.state_from_numpy(arrays, "cpu"),
                             edge="segment")
    assert [(f.invariant, f.ok, f.detail) for f in got] == \
        [(f.invariant, f.ok, f.detail) for f in want]
    if tamper == "off":
        assert got == []
    else:
        assert {f.invariant for f in got} == {
            "branched_is_tree", "children_conservation", "bound_hist_exact",
            "steal_flow"}
        assert all(f.detail["edge"] == "segment" for f in got)
        assert all(f.ok for f in got) == (tamper is None)
    assert outcomes(taudit.findings()[-len(got):] if got else []) == \
        outcomes(got)
