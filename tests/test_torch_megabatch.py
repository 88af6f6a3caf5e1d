"""The port's request megabatching against the JAX package's.

Mirrors `tests/test_megabatch.py`'s engine tests: B members of one table
shape go through `serve_batch` of both packages, the port's workers on
`[cpu] * D` and the JAX loop on `worker_mesh(D)` of the conftest's CPU
mesh (D = 2). Inputs are `PFSPInstance.synthetic(7, 3, seed)` tables (and
TSP and knapsack ones) with the JAX file's knobs `KW`. Compared exactly
(tolerance 0: integer math): `stack_states`/`slice_member` bytes on mixed
capacities; each member's `(tree, sol, best, complete)`, every
`per_device` array, the telemetry summary and every `SegmentReport` but
its wall-clock field, against JAX's batch and against the member's solo
search, under TTS_AUDIT_HARD=1; termination masks; whole-batch growth from
a tiny capacity; a stopped member's checkpoint resumed solo by both
packages; `MemberIncompatible`; the tuner-resolved `chunk=None`. The tests
JAX marks slow are marked slow here too."""

import dataclasses

import numpy as np
import pytest

from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.engine import megabatch as jmb
from tpu_tree_search.parallel.mesh import worker_mesh
from tpu_tree_search.tune import tuner as jtuner
from tpu_tree_search_torch.engine import checkpoint as tckpt
from tpu_tree_search_torch.engine import distributed as tdist
from tpu_tree_search_torch.engine import megabatch as tmb
from tpu_tree_search_torch.obs import audit as taudit
from tpu_tree_search_torch.problems.pfsp import PFSPInstance
from tpu_tree_search_torch.tune import tuner as ttuner

import _torch_isolation
import _torch_threads

_torch_threads.share_cores()

D = 2
CPUS = ["cpu"] * D
KW = dict(chunk=8, capacity=1 << 12, min_seed=4, segment_iters=16)
PER_DEVICE = ("tree", "sol", "iters", "evals", "sent", "recv", "steals",
              "final_size")


def small(seed, jobs=7):
    return PFSPInstance.synthetic(jobs=jobs, machines=3, seed=seed)


def tsp_table(n, seed):
    r = np.random.default_rng(seed)
    d = r.integers(1, 50, size=(n, n)).astype(np.int32)
    d = (d + d.T) // 2
    np.fill_diagonal(d, 0)
    return d


def ks_table(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 20, n)
    v = rng.integers(1, 30, n)
    row3 = np.zeros(n, np.int64)
    row3[0] = int(w.sum() // 2)
    return np.stack([w, v, row3]).astype(np.int32)


def res_tuple(res):
    return (res.explored_tree, res.explored_sol, res.best, res.complete)


def same_result(got, want):
    assert res_tuple(got) == res_tuple(want)
    for k in PER_DEVICE:
        np.testing.assert_array_equal(np.asarray(got.per_device[k]),
                                      np.asarray(want.per_device[k]),
                                      err_msg=k)
    assert got.telemetry == want.telemetry


def rows(reports):
    """Segment reports without their wall-clock field."""
    return [{**dataclasses.asdict(r), "elapsed": None} for r in reports]


def both(tables, problem="pfsp", lb_kind=1, specs_kw=None, **kw):
    """`serve_batch` of both packages on the same members, with every
    member's segment reports: ((jax results, jax reports), (port results,
    port reports))."""
    specs_kw = specs_kw or [{}] * len(tables)
    out = []
    for mod, where in ((jmb, dict(mesh=worker_mesh(D))),
                       (tmb, dict(devices=CPUS))):
        reps = {b: [] for b in range(len(tables))}
        res = mod.serve_batch(
            [mod.MemberSpec(table=t, **s) for t, s in zip(tables, specs_kw)],
            problem=problem, lb_kind=lb_kind,
            heartbeat=lambda b, r, reps=reps: reps[b].append(r),
            **where, **{**KW, **kw})
        out.append((res, reps))
    return out


@pytest.fixture
def iso():
    with _torch_isolation.isolated():
        yield


# ------------------------------------------------------------- stacking


def test_stack_and_slice_match_jax_on_mixed_capacities():
    rng = np.random.default_rng(0)

    def host_state(cap, tele_w):
        J, A = 7, 4
        return dict(
            prmu=rng.integers(0, 7, (D, J, cap)).astype(np.int16),
            depth=rng.integers(0, 7, (D, cap)).astype(np.int16),
            aux=rng.integers(0, 99, (D, A, cap)).astype(np.int16),
            size=rng.integers(0, cap, D).astype(np.int32),
            best=rng.integers(0, 99, D).astype(np.int32),
            tree=rng.integers(0, 99, D), sol=rng.integers(0, 9, D),
            iters=np.full(D, 16), evals=rng.integers(0, 999, D),
            sent=rng.integers(0, 9, D), recv=rng.integers(0, 9, D),
            steals=rng.integers(0, 9, D),
            overflow=np.zeros(D, bool),
            telemetry=rng.integers(0, 9, (D, tele_w)))

    from tpu_tree_search.engine.device import SearchState as JState
    from tpu_tree_search_torch.engine.device import SearchState as TState
    for tele_w in (0, 5):
        members = [host_state(c, tele_w) for c in (16, 64, 32)]
        for cap in (None, 128):
            want = jmb.stack_states([JState(**m) for m in members],
                                    capacity=cap)
            got = tmb.stack_states([TState(**m) for m in members],
                                   capacity=cap)
            for f, w, g in zip(TState._fields, want, got):
                assert g.dtype == np.asarray(w).dtype, f
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=f)
            for b in range(3):
                for f, w, g in zip(TState._fields,
                                   jmb.slice_member(want, b),
                                   tmb.slice_member(got, b)):
                    np.testing.assert_array_equal(g, np.asarray(w),
                                                  err_msg=f"{f} {b}")


# ---------------------------------------------------------------- parity


def test_batch_matches_jax_and_solo_lb1_telemetry_audit(monkeypatch, iso):
    """Per member: JAX's batch, the port's batch and the port's solo search
    agree on the counts, every per-worker counter, the telemetry summary
    and every segment report, with the auditor raising."""
    monkeypatch.setenv("TTS_SEARCH_TELEMETRY", "1")
    monkeypatch.setenv("TTS_AUDIT_HARD", "1")
    tables = [small(s).p_times for s in (1, 2)]
    (jres, jreps), (tres, treps) = both(tables)
    for b, t in enumerate(tables):
        solo_reps = []
        solo = tdist.search(t, problem="pfsp", lb_kind=1, devices=CPUS,
                            heartbeat=solo_reps.append, **KW)
        assert tres[b].telemetry is not None
        same_result(tres[b], jres[b])
        same_result(tres[b], solo)
        assert rows(treps[b]) == rows(jreps[b]) == rows(solo_reps)
    names = {f.invariant for f in taudit.findings()}
    assert {"node_conservation", "complete_means_drained",
            "branched_is_tree", "children_conservation",
            "bound_hist_exact", "steal_flow"} <= names
    assert not taudit.recent_failures()


@pytest.mark.slow
def test_batch_matches_jax_generic_step(monkeypatch, iso):
    """The problem-generic pipeline (TSP) under the batch."""
    monkeypatch.setenv("TTS_AUDIT_HARD", "1")
    tables = [tsp_table(6, s) for s in (1, 2, 3)]
    (jres, _), (tres, _) = both(tables, problem="tsp")
    for t, j, r in zip(tables, jres, tres):
        same_result(r, j)
        solo = tdist.search(t, problem="tsp", lb_kind=1, devices=CPUS, **KW)
        assert res_tuple(r) == res_tuple(solo)


@pytest.mark.slow
def test_batch_matches_jax_lb2_and_knapsack(monkeypatch, iso):
    monkeypatch.setenv("TTS_SEARCH_TELEMETRY", "1")
    monkeypatch.setenv("TTS_AUDIT_HARD", "1")
    tables = [small(s, jobs=8).p_times for s in (3, 4)]
    (jres, jreps), (tres, treps) = both(tables, lb_kind=2)
    for b, t in enumerate(tables):
        same_result(tres[b], jres[b])
        assert rows(treps[b]) == rows(jreps[b])
        solo = tdist.search(t, problem="pfsp", lb_kind=2, devices=CPUS, **KW)
        same_result(tres[b], solo)
    kt = [ks_table(10, s) for s in (5, 6)]
    (jres, _), (tres, _) = both(kt, problem="knapsack")
    for t, j, r in zip(kt, jres, tres):
        same_result(r, j)
        solo = tdist.search(t, problem="knapsack", lb_kind=1, devices=CPUS,
                            **KW)
        assert res_tuple(r) == res_tuple(solo)


@pytest.mark.slow
def test_termination_masks():
    """A member whose bound seed of 1 collapses its tree drains segments
    before its batchmate; its result is its solo run's, and the batchmate
    completes."""
    t0, t1 = small(3).p_times, small(4).p_times
    s0 = tdist.search(t0, problem="pfsp", lb_kind=1, init_ub=1,
                      devices=CPUS, **KW)
    done = []
    out = tmb.serve_batch(
        [tmb.MemberSpec(table=t0, init_ub=1), tmb.MemberSpec(table=t1)],
        problem="pfsp", lb_kind=1, devices=CPUS,
        on_member_done=lambda b, res: done.append((b, res.per_device[
            "iters"].max())), **KW)
    assert [b for b, _ in done] == [0, 1]
    assert done[0][1] < done[1][1]
    assert res_tuple(out[0]) == res_tuple(s0)
    assert out[1].complete


def test_frozen_member_is_bit_stable():
    """One dispatch in which member 0 is past its ceiling: its whole state
    (pools, counters, telemetry) is the same bytes after it, while member
    1 steps."""
    drv_states = []

    def capture(driver_cls):
        orig = driver_cls.run_once

        def run_once(self, states, targets, caps):
            before = [tdist.fetch_state(sb) for sb in states]
            out = orig(self, states, targets, caps)
            drv_states.append((list(targets), before,
                               [tdist.fetch_state(sb) for sb in out]))
            return out
        return run_once

    mp = pytest.MonkeyPatch()
    mp.setattr(tmb.BatchedDriver, "run_once", capture(tmb.BatchedDriver))
    try:
        tmb.serve_batch([tmb.MemberSpec(table=small(3).p_times, init_ub=1),
                         tmb.MemberSpec(table=small(4).p_times)],
                        problem="pfsp", lb_kind=1, devices=CPUS, **KW)
    finally:
        mp.undo()
    frozen = 0
    for targets, before, after in drv_states:
        for b in range(2):
            if int(np.asarray(before[b].iters).max()) >= targets[b] or \
                    int(np.asarray(before[b].size).sum()) == 0:
                frozen += 1
                for f, x, y in zip(before[b]._fields, before[b], after[b]):
                    np.testing.assert_array_equal(x, y, err_msg=f)
    assert frozen > 0


def test_whole_batch_growth_matches_jax(monkeypatch):
    """From a capacity the trees outgrow, every member's pool grows x2
    (whole batch) and the same targets are dispatched again: the counts,
    per-worker counters and reports equal JAX's, after the same growths."""
    from tpu_tree_search.engine import checkpoint as jckpt

    grows = {"jax": [], "port": []}
    for mod, who in ((jckpt, "jax"), (tckpt, "port")):
        orig = mod.grow
        monkeypatch.setattr(mod, "grow", lambda s, c, orig=orig, who=who: (
            grows[who].append(c), orig(s, c))[1])
    tables = [small(s, jobs=8).p_times for s in (5, 6)]
    (jres, jreps), (tres, treps) = both(tables, capacity=128,
                                        transfer_cap=8, min_transfer=16)
    # the port grows each worker's pool: D calls a member a growth
    assert grows["jax"] and grows["port"] == [
        c for c in grows["jax"] for _ in range(2 * D)]
    for b in range(2):
        same_result(tres[b], jres[b])
        assert rows(treps[b]) == rows(jreps[b])


def test_stopped_member_resumes_solo_in_both_packages(tmp_path, iso):
    """`member_stop` stops member 1 at segment 2: its checkpoint, resumed
    by either package's solo search, reaches the uninterrupted totals, and
    member 0 still completes."""
    tables = [small(s, jobs=8).p_times for s in (7, 8)]
    full = tdist.search(tables[1], lb_kind=1, devices=CPUS, **KW)
    ck = tmp_path / "m1.npz"
    stopped = []
    out = tmb.serve_batch(
        [tmb.MemberSpec(table=tables[0]),
         tmb.MemberSpec(table=tables[1], checkpoint_path=str(ck))],
        problem="pfsp", lb_kind=1, devices=CPUS,
        member_stop=lambda b, rep: b == 1 and rep.segment == 2,
        on_member_stopped=lambda b, res: stopped.append(b), **KW)
    assert stopped == [1] and not out[1].complete and out[0].complete
    assert ck.exists()
    ck_j = tmp_path / "m1_jax.npz"
    ck_j.write_bytes(ck.read_bytes())
    port = tdist.search(tables[1], lb_kind=1, devices=CPUS,
                        checkpoint_path=str(ck), **KW)
    jax_ = jdist.search(tables[1], lb_kind=1, mesh=worker_mesh(D),
                        checkpoint_path=str(ck_j), **KW)
    assert res_tuple(port) == res_tuple(jax_) == res_tuple(full)


def test_batch_resumes_elastic_and_audits(tmp_path, iso):
    """A member resumed in a batch from a checkpoint of four workers is
    resharded onto the batch's two (`elastic_resume_conservation` recorded,
    all passing) and reaches the totals of its uninterrupted solo run
    (ub = the optimum: the tree does not depend on the worker count)."""
    inst = small(11, jobs=8)
    opt = inst.brute_force_optimum()
    kw = dict(KW, init_ub=opt)
    full = tdist.search(inst.p_times, lb_kind=1, devices=CPUS, **kw)
    ck = tmp_path / "r.npz"
    tdist.search(inst.p_times, lb_kind=1, devices=["cpu"] * 4,
                 checkpoint_path=str(ck), should_stop=lambda rep: True, **kw)
    taudit.clear_findings()
    out = tmb.serve_batch(
        [tmb.MemberSpec(table=small(12, jobs=8).p_times),
         tmb.MemberSpec(table=inst.p_times, init_ub=opt,
                        checkpoint_path=str(ck))],
        problem="pfsp", lb_kind=1, devices=CPUS, **KW)
    assert res_tuple(out[1]) == res_tuple(full)
    reshard = [f for f in taudit.findings()
               if f.invariant == "elastic_resume_conservation"]
    assert reshard and all(f.ok for f in reshard)


def test_member_incompatible(tmp_path, monkeypatch):
    """A cross-problem checkpoint and a telemetry width other than the
    majority's are refused, naming the member."""
    ck = tmp_path / "q.npz"
    tdist.search(tsp_table(6, 1), problem="tsp", lb_kind=1, devices=CPUS,
                 checkpoint_path=str(ck), should_stop=lambda rep: True,
                 **KW)
    specs = [tmb.MemberSpec(table=small(1).p_times),
             tmb.MemberSpec(table=small(2).p_times,
                            checkpoint_path=str(ck))]
    with pytest.raises(tmb.MemberIncompatible, match="problem 'tsp'") as e:
        tmb.serve_batch(specs, problem="pfsp", devices=CPUS, **KW)
    assert e.value.member == 1
    # a telemetry checkpoint in a batch without telemetry
    ck2 = tmp_path / "tele.npz"
    monkeypatch.setenv("TTS_SEARCH_TELEMETRY", "1")
    tdist.search(small(9).p_times, lb_kind=1, devices=CPUS,
                 checkpoint_path=str(ck2), should_stop=lambda rep: True,
                 **KW)
    monkeypatch.delenv("TTS_SEARCH_TELEMETRY")
    specs = [tmb.MemberSpec(table=small(9).p_times, checkpoint_path=str(ck2)),
             tmb.MemberSpec(table=small(1).p_times),
             tmb.MemberSpec(table=small(2).p_times)]
    with pytest.raises(tmb.MemberIncompatible, match="telemetry") as e:
        tmb.serve_batch(specs, problem="pfsp", devices=CPUS, **KW)
    assert e.value.member == 0


def test_tuner_resolved_chunk_matches_jax(iso):
    """`chunk=None` with a tuner resolves the batched key's defaults row
    (never a probe), the same value in both packages, and the batch then
    equals JAX's."""
    tables = [small(s).p_times for s in (1, 2)]
    kw = {k: v for k, v in KW.items() if k != "chunk"}
    out = []
    for mod, tuner, where in (
            (jmb, jtuner.Autotuner(), dict(mesh=worker_mesh(D))),
            (tmb, ttuner.Autotuner(device="cpu"), dict(devices=CPUS))):
        res = mod.serve_batch([mod.MemberSpec(table=t) for t in tables],
                              problem="pfsp", lb_kind=1, chunk=None,
                              tuner=tuner, **where, **kw)
        out.append(res)
    for j, r in zip(*out):
        same_result(r, j)



def test_multi_process_batch_names_its_roadmap_item(monkeypatch):
    """A batch in a multi-process job is refused, naming ROADMAP A8b."""
    monkeypatch.setattr(tmb.mesh, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP A8b"):
        tmb.serve_batch([tmb.MemberSpec(table=small(1).p_times)],
                        devices=CPUS, **KW)
