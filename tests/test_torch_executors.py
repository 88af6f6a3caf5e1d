"""The port's executor cache against the JAX package's.

`ExecutorCache` of both packages takes the same keys and gives the same
hits, misses, entries, key strings, `tts_executor_cache_*` series and
ledger keys (the port's ledger adds `nvcc_s` and `captures`; its cost
fields stay None: a capture has no cost analysis). `distributed.search`
through a cache consults it once per driver and pool capacity, as JAX's
`_DistDriver._loop` does: a run whose pools grow adds a key per capacity,
and a second instance of the class hits every one of them, in both
packages (the port's `worker_ids=(0, 1)` against JAX's two devices, so
the key strings match). `distributed.prewarm` readies a key (then "warm",
and the search hits it, the capture planned), every ladder rung under
TTS_LADDER=1, and "skipped" without a cache; `SearchServer.prewarm_boot`
warms one key a slot. A cached loop's card path (its capture faked)
adopts the first request's pools, copies a later one's into them, captures
once a telemetry width and admits one driver at a time; at most
`device._GRAPH_CACHE` loops that no search holds keep graphs and pools,
and a driver without a cache runs a loop of its own a capacity. JAX's
own prewarm
is not compared (its AOT compile is refused on some CPUs, ROADMAP C1).
Exact: counters and strings."""

import numpy as np
import pytest
import torch

from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.obs import metrics as jmetrics
from tpu_tree_search.service import ExecutorCache as JCache
from tpu_tree_search_torch.engine import device as tdevice
from tpu_tree_search_torch.engine import distributed as tdist
from tpu_tree_search_torch.obs import metrics as tmetrics
from tpu_tree_search_torch.problems.pfsp import PFSPInstance
from tpu_tree_search_torch.service import ExecutorCache, SearchRequest
from tpu_tree_search_torch.service import SearchServer

import _torch_isolation
import _torch_threads

_torch_threads.share_cores()

KW = dict(chunk=8, capacity=1 << 12, min_seed=4)


@pytest.fixture(autouse=True)
def iso(monkeypatch):
    for k in ("TTS_LADDER", "TTS_OVERLAP", "TTS_SEARCH_TELEMETRY"):
        monkeypatch.delenv(k, raising=False)
    with _torch_isolation.isolated():
        yield


def small(seed, jobs=7):
    return PFSPInstance.synthetic(jobs=jobs, machines=3, seed=seed)


def _pool(v, w):
    """A worker state whose pools hold `v`, with `w` telemetry slots."""
    return tdist.SearchState(
        prmu=torch.full((3, 16), v, dtype=torch.int16),
        depth=torch.full((16,), v, dtype=torch.int16),
        aux=torch.full((3, 16), v, dtype=torch.int32),
        size=torch.zeros((), dtype=torch.int32),
        best=torch.zeros((), dtype=torch.int32),
        tree=torch.zeros((), dtype=torch.int64),
        sol=torch.zeros((), dtype=torch.int64),
        iters=torch.zeros((), dtype=torch.int64),
        evals=torch.zeros((), dtype=torch.int64),
        sent=torch.zeros((), dtype=torch.int64),
        recv=torch.zeros((), dtype=torch.int64),
        steals=torch.zeros((), dtype=torch.int64),
        overflow=torch.zeros((), dtype=torch.bool),
        telemetry=torch.zeros(w, dtype=torch.int64))


def test_cache_counters_keys_and_series_as_jax():
    rng = np.random.default_rng(7)
    keys = [("pfsp", 7, 3, int(lb), 8, "int16", 0, 1, int(cap))
            for lb, cap in zip(rng.integers(1, 3, 12),
                               rng.choice([4096, 8192], 12))]
    got = {}
    for name, Cache, met in (("jax", JCache, jmetrics),
                             ("torch", ExecutorCache, tmetrics)):
        reg = met.Registry("tts_service")
        cache = Cache(registry=reg)
        built = [cache.get_or_build(k, lambda: object()) for k in keys]
        got[name] = (cache.snapshot(), len(cache),
                     [r["key"] for r in cache.ledger_snapshot()],
                     sorted(set(cache.ledger_snapshot()[0])),
                     len({id(e) for e in built}),
                     {k: v for k, v in reg.to_json().items()
                      if k.startswith("tts_executor_cache")},
                     cache.storm_signal())
    j, t = got["jax"], got["torch"]
    assert t[:3] == j[:3] and t[4:] == j[4:]
    assert set(j[3]) | {"nvcc_s", "captures", "flops", "bytes_accessed",
                        "temp_bytes"} == set(t[3])


def test_search_consults_per_capacity_as_jax():
    """Two instances of one class through one cache, the first growing
    its pools from a capacity too small for its tree: the same keys, hits
    and misses in both packages, and each search its uncached totals."""
    kw = dict(chunk=32, capacity=1 << 8, min_seed=4)
    seeds = (5, 7)
    out = {}
    for name in ("jax", "torch"):
        cache = JCache() if name == "jax" else ExecutorCache()
        res = []
        for s in seeds:
            p = small(s, jobs=9).p_times
            if name == "jax":
                r = jdist.search(p, lb_kind=1, n_devices=2,
                                 loop_cache=cache, **kw)
            else:
                r = tdist.search(p, lb_kind=1, devices=["cpu"] * 2,
                                 loop_cache=cache, worker_ids=(0, 1), **kw)
            res.append((r.explored_tree, r.explored_sol, r.best))
        out[name] = (res, cache.snapshot(),
                     [r["key"] for r in cache.ledger_snapshot()])
    assert out["torch"] == out["jax"]
    snap, keys = out["torch"][1], out["torch"][2]
    assert len(keys) >= 2, keys          # the pools grew at least once
    assert snap == {"entries": len(keys), "hits": len(keys),
                    "misses": len(keys)}


def test_prewarm_readies_the_key_a_search_hits():
    cache = ExecutorCache()
    p = small(0).p_times
    assert tdist.prewarm(p, devices=["cpu"] * 2, **KW) == "skipped"
    assert tdist.prewarm(p, devices=["cpu"] * 2, loop_cache=cache,
                         **KW) == "compile"
    assert tdist.prewarm(small(3).p_times, devices=["cpu"] * 2,
                         loop_cache=cache, **KW) == "warm"
    assert cache.snapshot() == {"entries": 1, "hits": 1, "misses": 1}
    got = tdist.search(small(1).p_times, devices=["cpu"] * 2, lb_kind=1,
                       loop_cache=cache, **KW)
    want = tdist.search(small(1).p_times, devices=["cpu"] * 2, lb_kind=1,
                        **KW)
    assert (got.explored_tree, got.best) == (want.explored_tree, want.best)
    assert cache.snapshot() == {"entries": 1, "hits": 2, "misses": 1}
    assert (cache.compiles, cache.planned_compiles,
            cache.storm_signal()) == (1, 1, 0)
    assert cache.ledger_snapshot()[0]["via"] == "prewarm"


def test_prewarm_readies_every_ladder_rung(monkeypatch):
    monkeypatch.setenv("TTS_LADDER", "1")
    cache = ExecutorCache()
    p = small(5, jobs=8).p_times
    kw = dict(chunk=256, capacity=1 << 14, min_seed=4)
    assert tdist.prewarm(p, devices=["cpu"] * 2, loop_cache=cache,
                         **kw) == "compile"
    rungs = len(cache)
    assert rungs >= 2
    vias = sorted(r["via"] for r in cache.ledger_snapshot())
    assert vias == ["ladder"] * (rungs - 1) + ["prewarm"]
    assert cache.storm_signal() == 0
    res = tdist.search(p, devices=["cpu"] * 2, lb_kind=1, loop_cache=cache,
                       segment_iters=4, **kw)
    plain = tdist.search(p, devices=["cpu"] * 2, lb_kind=1,
                         segment_iters=4, **kw)
    assert (res.explored_tree, res.best) == (plain.explored_tree,
                                             plain.best)
    assert cache.snapshot()["hits"] >= rungs


def test_server_prewarm_boot_one_key_a_slot(tmp_path):
    with SearchServer(n_submeshes=2, devices=["cpu"] * 4, workdir=tmp_path,
                      health_interval_s=0, resource_sample_s=0) as srv:
        summary = srv.prewarm_boot("7x3")
        assert summary["shapes"] == 1 and summary["warms"] == 2
        assert summary["by"] == {"disk": 0, "compile": 2, "warm": 0,
                                 "skipped": 0} and summary["errors"] == 0
        again = srv.prewarm_boot("7x3")
        assert again["by"]["warm"] == 2
        rid = srv.submit(SearchRequest(p_times=small(2).p_times,
                                       min_seed=32, capacity=None))
        assert srv.result(rid, timeout=300).state == "DONE"
        snap = srv.status_snapshot()
    assert snap["executor_cache"]["misses"] == 2
    assert snap["executor_cache"]["hits"] >= 3
    with SearchServer(n_submeshes=1, devices=["cpu"], autostart=False,
                      workdir=tmp_path / "b", health_interval_s=0,
                      resource_sample_s=0) as srv:
        with pytest.raises(ValueError, match="unknown prewarm token"):
            srv.prewarm_boot("nope")


def test_cached_loop_homes_pools_and_captures_once():
    """The card's path of a cached loop, its capture faked: the first
    request's pools are adopted, a later request's are copied into them
    (its own tensors left as they were), one capture a telemetry width,
    booked once on the entry; the tables are the loop's own copy."""
    cache = ExecutorCache()
    t = {"cpu": torch.as_tensor(small(0).p_times.copy())}
    entry = cache.get_or_build(("k",), lambda: tdist._Loop(
        tdist._clone_tables(t), lambda ts: ts))
    loop = entry.fn
    assert loop.tables["cpu"].data_ptr() != t["cpu"].data_ptr()
    mk = _pool
    captured = []

    def capture(states):
        captured.append([s.prmu.data_ptr() for s in states])
        return len(captured)

    first = [mk(1, 0), mk(2, 0)]
    s1, g1 = loop.graph(first, capture, entry.book)
    second = [mk(7, 0), mk(8, 0)]
    s2, g2 = loop.graph(second, capture, entry.book)
    assert g1 == g2 == 1 and len(captured) == 1
    assert [s.prmu.data_ptr() for s in s2] == captured[0]
    assert [int(s.prmu[0, 0]) for s in s2] == [7, 8]
    assert int(second[0].prmu[0, 0]) == 7 and int(first[0].prmu[0, 0]) == 7
    _, g3 = loop.graph([mk(3, 60), mk(4, 60)], capture, entry.book)
    assert g3 == 2
    rec = cache.ledger_snapshot()[0]
    assert rec["captures"] == 2 and rec["method"] == "capture"
    assert cache.compiles == 1
    other = tdist._DistDriver.__new__(tdist._DistDriver)
    loop.take(entry, t)
    with pytest.raises(RuntimeError, match="held by another search"):
        loop.take(other, t)
    loop.release(entry)
    loop.take(other, t)


def test_resident_loops_are_bounded():
    """At most `device._GRAPH_CACHE` loops that no search holds keep their
    graphs and pools (captures faked): using one more lets the least
    recently used unheld loop go, a held loop stays, a loop that went
    captures again at its next use, and `clear_graphs` drops them all."""
    tdevice.clear_graphs()
    t = {"cpu": torch.as_tensor(small(0).p_times.copy())}
    n = tdevice._GRAPH_CACHE
    loops = [tdist._Loop(tdist._clone_tables(t), lambda ts: ts)
             for _ in range(n + 2)]
    captured = []

    def use(loop):
        loop.graph([_pool(1, 0)], lambda st: captured.append(loop))

    owner = object()
    loops[0].take(owner, t)
    for loop in loops:
        use(loop)
    assert captured == loops
    resident = tdevice.resident()
    assert resident == [loops[0], *loops[3:]]
    assert loops[1].graphs == {} and loops[1].pools is None
    assert loops[0].graphs and loops[0].pools is not None
    use(loops[1])
    assert captured[-1] is loops[1] and len(captured) == n + 3
    assert tdevice.resident() == [loops[0], *loops[4:], loops[1]]
    loops[0].release(owner)
    tdevice.clear_graphs()
    assert tdevice.resident() == []
    assert all(x.graphs == {} and x.pools is None for x in loops)


def test_driver_keeps_one_loop_a_capacity():
    """Without an executor cache a driver runs its own `_Loop` over its
    own tables (no copy), one a capacity; a larger capacity lets the
    smaller one go, and `donate` shares the loop."""
    table = small(0).p_times
    drv = tdist._problem_driver(tdist._resolve_problem("pfsp"),
                                ["cpu"] * 2, table, 1, 4, 2, 16, 4)
    small_loop = drv.loop(1 << 10)
    assert drv.loop(1 << 10, donate=True) is small_loop
    assert drv.body(1 << 10) is small_loop.body
    assert small_loop.tables is drv.tables
    big = drv.loop(1 << 11)
    assert big is not small_loop and list(drv._loops) == [1 << 11]
