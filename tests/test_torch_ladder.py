"""The port's chunk ladder (`engine/ladder.py`, `distributed._ladder_plan`
and the ladder in `distributed.search`) against the JAX package's.

Exact (integer math): `rungs_for`, `min_rung_for`, `rungs_from_profile`,
`fused_for` and `_profile_rows` on a grid and on seeded profiles with
malformed rows; `RungController` on seeded pool sequences, with ramp
momentum and the memory-pressure hint, its rung after every boundary, its
switches, events and counter equal. `distributed.search` with the ladder
on four CPU workers against JAX's on `worker_mesh(4)`, on the instances
of `tests/test_ladder.py` (10x5 seed 1, LB1, ub 697, chunk 2048; 11x20
seed 1, LB2, ub 1810, chunk 1024; `segment_iters` 8): the same rung
sequence, every worker's live rows and counters at every segment
boundary, and the same totals, which also equal the port's ladder-off
run. A ladder checkpoint of either package resumes in the other on its
recorded rung; a ladder checkpoint resumes on the plain driver and a
plain one on the ladder. The ladder stays off without segments, at one
rung and beside a host tier, and `TTS_LADDER=1` engages it through the
`pfsp -D` command."""

import contextlib
import io

import numpy as np
import pytest

from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.engine import ladder as jladder
from tpu_tree_search.obs import metrics as jmetrics
from tpu_tree_search.obs import tracelog as jtracelog
from tpu_tree_search.parallel.mesh import worker_mesh
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.engine import distributed as tdist
from tpu_tree_search_torch.engine import ladder as tladder
from tpu_tree_search_torch.obs import metrics as tmetrics
from tpu_tree_search_torch.obs import tracelog as ttracelog
from tpu_tree_search_torch.problems.pfsp import PFSPInstance

import _torch_isolation
import _torch_threads

_torch_threads.share_cores()

D = 4
CPUS = ["cpu"] * D
_COUNTERS = ("size", "best", "tree", "sol", "evals", "iters", "sent",
             "recv", "steals", "overflow")
# the flight recorder's own fields, which differ between two recorders
_STAMP = ("ts", "seq", "pid", "thread")


@pytest.fixture(autouse=True)
def _isolated():
    with _torch_isolation.isolated():
        yield


def ladder_events(tracelog_mod):
    return [{k: v for k, v in r.items() if k not in _STAMP}
            for r in tracelog_mod.get().records()
            if r.get("name", "").startswith("ladder.")]


def totals(res):
    return (res.explored_tree, res.explored_sol, res.best, res.complete)


# ---------------------------------------------------------- the helpers

def test_rung_geometry_matches_jax():
    for c in (1, 2, 3, 16, 63, 64, 65, 100, 255, 256, 257, 1000, 1024,
              2048, 4096, 5000, 65536, 1 << 20):
        for n in (1, 2, 3, 4):
            for f in (2, 3, 4, 8):
                for m in (1, 32, 64, 256, 512):
                    assert tladder.rungs_for(c, n, f, m) == \
                        jladder.rungs_for(c, n, f, m), (c, n, f, m)
        assert tladder.rungs_for(c) == jladder.rungs_for(c)
    for lb in (0, 1, 2):
        assert tladder.min_rung_for(lb) == jladder.min_rung_for(lb)
    for name in ("LADDER_FACTOR", "LADDER_RUNGS", "LADDER_MIN_CHUNK",
                 "LADDER_MIN_CHUNK_LB2"):
        assert getattr(tladder, name) == getattr(jladder, name)
    assert tladder.rungs_for(65536) == (4096, 16384, 65536)
    assert tladder.rungs_for(4096, min_chunk=256) == (256, 1024, 4096)


def _random_profile(rng, chunk):
    """A per-rung profile as a tuning cache could hold it: rows for some
    of the rung chunks (and others), each field present, None or absent,
    and malformed rows among them."""
    rows = []
    cands = [chunk // 4 ** k for k in range(4)] + [chunk * 2, 7]
    for c in cands:
        if rng.random() < 0.3:
            continue
        row = {"chunk": c if rng.random() < 0.8 else str(c)}
        for f in ("ms_per_iter", "ms_per_iter_fused",
                  "ms_per_iter_unfused", "evals_per_s_fused"):
            u = rng.random()
            if u < 0.6:
                row[f] = float(rng.integers(0, 20))   # 0.0: falsy
            elif u < 0.8:
                row[f] = None
        u = rng.random()
        if u < 0.8:
            row["winner"] = "fused" if rng.random() < 0.5 else "unfused"
        rows.append(row)
    bad = [None, {}, {"chunk": None}, {"chunk": "x"}, {"chunk": [1]}, 5]
    for _ in range(int(rng.integers(0, 3))):
        rows.insert(int(rng.integers(0, len(rows) + 1)),
                    bad[int(rng.integers(len(bad)))])
    return tuple(rows) if rng.random() < 0.8 else rows


@pytest.mark.parametrize("seed", range(4))
def test_profile_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(300):
        chunk = int(rng.choice([256, 1024, 4096, 65536]))
        prof = _random_profile(rng, chunk)
        assert tladder._profile_rows(prof) == jladder._profile_rows(prof)
        for mode in ("off", "hw", "on", "interpret"):
            assert tladder.rungs_from_profile(chunk, prof,
                                              fused_mode=mode) == \
                jladder.rungs_from_profile(chunk, prof, fused_mode=mode)
            for c in {chunk // 4 ** k for k in range(4)} | {chunk * 2}:
                assert tladder.fused_for(c, prof, mode) == \
                    jladder.fused_for(c, prof, mode)
    for prof in (None, (), [], ({"chunk": 64},)):
        assert tladder.rungs_from_profile(256, prof) == \
            jladder.rungs_from_profile(256, prof)


@pytest.mark.parametrize("seed", range(4))
def test_rung_controller_matches_jax(seed):
    rng = np.random.default_rng(seed)
    chunks = {0: (64, 256, 1024), 1: (128, 512, 2048), 2: (256, 4096),
              3: (4096, 16384, 65536)}[seed]
    n_workers = int(rng.choice([1, 4, 8]))
    ctls = [m.RungController({c: f"d{c}" for c in chunks}, n_workers)
            for m in (tladder, jladder)]
    assert [c.current_chunk for c in ctls] == [chunks[-1]] * 2
    meta = int(rng.choice([chunks[0], chunks[-1], 3])) if seed % 2 else None
    pool = int(rng.integers(0, chunks[-1] * n_workers))
    for c in ctls:
        c.start(pool, meta_rung=meta)
    for seg in range(200):
        on = bool(rng.random() < 0.2)
        for m in (tladder, jladder):
            m.set_memory_pressure(on)
        # ramps, drains and plateaus, with doublings among them
        pool = int(max(0, pool * rng.choice([0.1, 0.5, 1, 1.5, 2.5, 4])
                       + rng.integers(0, 64)))
        for c in ctls:
            c.observe(pool, segment=seg + 1)
        assert ctls[0].current_chunk == ctls[1].current_chunk
        assert ctls[0].driver() == ctls[1].driver()
    assert ctls[0].snapshot() == ctls[1].snapshot()
    assert sum(ctls[0].switches.values()) > 0
    assert ladder_events(ttracelog) == ladder_events(jtracelog)
    for d in ("up", "down"):
        got, want = (m.default().counter("tts_ladder_switches_total")
                     .value(direction=d) for m in (tmetrics, jmetrics))
        assert got == want == ctls[0].switches[d]
    for m in (tladder, jladder):
        m.set_memory_pressure(False)
        assert m.memory_pressure() is False


# ---------------------------------------------- the search on the ladder

P_BIG = PFSPInstance.synthetic(jobs=10, machines=5, seed=1).p_times
OPT_BIG = 697
KW = dict(capacity=1 << 16, min_seed=8, segment_iters=8)
BIG = dict(lb_kind=1, init_ub=OPT_BIG, chunk=2048, **KW)
P_LB2 = PFSPInstance.synthetic(jobs=11, machines=20, seed=1).p_times
LB2 = dict(lb_kind=2, init_ub=1810, chunk=1024, capacity=1 << 15,
           min_seed=8, segment_iters=8)


@contextlib.contextmanager
def boundaries(dist_mod, chunk_of):
    """Record (rung chunk, stacked host state) after every `_DistDriver.
    run`: one per segment."""
    seen = []
    orig = dist_mod._DistDriver.run

    def run(self, state, *args, **kw):
        out = orig(self, state, *args, **kw)
        seen.append((chunk_of(self), dist_mod.fetch_state(out)))
        return out

    dist_mod._DistDriver.run = run
    try:
        yield seen
    finally:
        dist_mod._DistDriver.run = orig


def _jax_chunk(drv):
    return drv.loop_key[4]


def _port_chunk(drv):
    return drv.key[3]


def _same_workers(got, want):
    for f in _COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for d, n in enumerate(np.asarray(want.size)):
        for f in ("prmu", "depth", "aux"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got, f))[d, ..., :n],
                np.asarray(getattr(want, f))[d, ..., :n],
                err_msg=f"worker {d} {f}")


def _ladder_run(table, kw, monkeypatch):
    """Both packages' ladder runs (TTS_AUDIT_HARD on) with their segment
    boundaries and ladder events."""
    monkeypatch.setenv("TTS_AUDIT_HARD", "1")
    with boundaries(jdist, _jax_chunk) as jseen:
        want = jdist.search(table, mesh=worker_mesh(D), ladder=True, **kw)
    with boundaries(tdist, _port_chunk) as tseen:
        got = tdist.search(table, devices=CPUS, ladder=True, **kw)
    return (want, jseen, ladder_events(jtracelog)), \
        (got, tseen, ladder_events(ttracelog))


@pytest.mark.parametrize("case", ["10x5 lb1", "11x20 lb2"])
def test_ladder_matches_jax_at_every_boundary(case, monkeypatch):
    table, kw = (P_BIG, BIG) if case == "10x5 lb1" else (P_LB2, LB2)
    (want, jseen, jev), (got, tseen, tev) = _ladder_run(table, kw,
                                                        monkeypatch)
    assert tev == jev
    assert tev[0]["name"] == "ladder.start"
    assert tev[0]["source"] == "occupancy"
    assert [c for c, _ in tseen] == [c for c, _ in jseen]
    assert tseen[0][0] < kw["chunk"]             # a lower rung ran
    for (_, g), (_, w) in zip(tseen, jseen):
        _same_workers(g, w)
    assert totals(got) == totals(want) and got.complete
    for f, v in want.per_device.items():
        np.testing.assert_array_equal(got.per_device[f], np.asarray(v),
                                      err_msg=f)
    off = tdist.search(table, devices=CPUS, ladder=False, **kw)
    assert totals(off) == totals(got)
    if case == "10x5 lb1":
        # switches both ways on this one (the LB2 case stays on its
        # lowest rung, 256, from the start)
        dirs = {e["direction"] for e in tev if e["name"] == "ladder.switch"}
        assert dirs == {"up", "down"}


def test_memory_pressure_keeps_the_counts():
    ref = tdist.search(P_BIG, devices=CPUS, ladder=True, **BIG)
    tladder.set_memory_pressure(True)
    held = tdist.search(P_BIG, devices=CPUS, ladder=True, **BIG)
    assert totals(held) == totals(ref)


@pytest.mark.parametrize("kw", [
    dict(chunk=64),                      # one rung: the plain driver
    dict(segment_iters=None),            # no segments, no boundaries
    dict(host_fraction=8, host_threads=1),   # the host tier keeps it off
], ids=["one-rung", "unsegmented", "host-tier"])
def test_ladder_stays_off(kw):
    args = {**BIG, **kw}
    if args["segment_iters"] is None:
        del args["segment_iters"]
    got = tdist.search(P_BIG, devices=CPUS, ladder=True, **args)
    assert got.complete and got.best == OPT_BIG
    assert ladder_events(ttracelog) == []
    if "host_fraction" not in kw:
        off = tdist.search(P_BIG, devices=CPUS, ladder=False, **args)
        assert totals(off) == totals(got)


# ------------------------------------------------------- resume

@pytest.fixture(scope="module")
def jax_ladder(tmp_path_factory):
    """JAX's ladder run stopped after one balance round (its checkpoint
    records the live rung), and its uninterrupted ladder run."""
    path = tmp_path_factory.mktemp("jax_ladder") / "j.npz"
    with _torch_isolation.isolated():
        part = jdist.search(P_BIG, mesh=worker_mesh(D), ladder=True,
                            checkpoint_path=str(path), max_rounds=1, **BIG)
        full = jdist.search(P_BIG, mesh=worker_mesh(D), ladder=True, **BIG)
    assert not part.complete
    return path, full


def _rung_of(path):
    with np.load(path) as z:
        return int(z["meta_ladder_rung"])


def _start_event():
    return [e for e in ladder_events(ttracelog)
            if e["name"] == "ladder.start"][0]


def test_port_resumes_jax_ladder_checkpoint_on_its_rung(jax_ladder,
                                                        tmp_path):
    path, full = jax_ladder
    mine = tmp_path / "j.npz"
    mine.write_bytes(path.read_bytes())
    rung = _rung_of(mine)
    assert rung in tladder.rungs_for(2048)
    done = tdist.search(P_BIG, devices=CPUS, ladder=True,
                        checkpoint_path=str(mine), **BIG)
    assert totals(done) == totals(full)
    start = _start_event()
    assert start["source"] == "meta" and start["rung"] == rung


def test_jax_resumes_port_ladder_checkpoint_on_its_rung(jax_ladder,
                                                        tmp_path):
    _, full = jax_ladder
    path = tmp_path / "t.npz"
    part = tdist.search(P_BIG, devices=CPUS, ladder=True,
                        checkpoint_path=str(path), max_rounds=1, **BIG)
    assert not part.complete
    rung = _rung_of(path)
    done = jdist.search(P_BIG, mesh=worker_mesh(D), ladder=True,
                        checkpoint_path=str(path), **BIG)
    assert totals(done) == totals(full)
    start = [e for e in ladder_events(jtracelog)
             if e["name"] == "ladder.start"][0]
    assert start["source"] == "meta" and start["rung"] == rung


@pytest.mark.parametrize("first,then", [(True, False), (False, True)],
                         ids=["ladder-to-plain", "plain-to-ladder"])
def test_resume_across_modes(first, then, jax_ladder, tmp_path):
    _, full = jax_ladder
    path = tmp_path / "c.npz"
    part = tdist.search(P_BIG, devices=CPUS, ladder=first,
                        checkpoint_path=str(path), max_rounds=1, **BIG)
    assert not part.complete
    with np.load(path) as z:
        assert ("meta_ladder_rung" in z.files) == first
    done = tdist.search(P_BIG, devices=CPUS, ladder=then,
                        checkpoint_path=str(path), **BIG)
    assert totals(done) == totals(full)
    if then:
        assert _start_event()["source"] == "occupancy"


# ------------------------------------------------------- the command

def test_ladder_flag_engages_through_the_pfsp_command(monkeypatch):
    monkeypatch.setenv("TTS_LADDER", "1")
    # ta002 LB1 ub=opt (tree 30) at the CLI chunk: rungs 64 and 256
    argv = ["pfsp", "-i", "2", "-l", "1", "-u", "1", "--device", "cpu",
            "-D", "4", "-m", "1", "--capacity", "4096", "--segment-iters",
            "8"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    text = out.getvalue()
    assert rc == 0 and "Size of the explored tree: 30" in text
    assert "Optimal makespan: 1359" in text
    start = _start_event()
    assert start["rungs"] == [64, 256]
