"""The port's tuner (`tune/cache.py`, `tune/probe.py`, `tune/tuner.py`,
`distributed.search(tuner=...)`, `tune_report.py`) against the JAX
package's.

Exact on the CPU, at the JAX tuner tests' scale (8x3 seed 1, chunks (8,
16), periods (2, 4), window 6, warm 20, capacity 2^12):

- `Autotuner.key` and the cache file names, for PFSP, TSP and knapsack,
  with a batch suffix and with both packages' fused mode patched to "hw";
- `ProbeHarness.measure`'s counts (`evals`, `window_iters`, `pool_start`,
  `underfilled`, `transfer_cap`) at LB1 and LB2, every repeat equal;
- `Autotuner.tune` with each package's harness replaced by one seeded fake
  rate table: the persisted payloads (less `sweep_seconds`), the returned
  `Params`, the probe ledgers and the `tuner.*` / `tuner_cache.*` events,
  with the fused route off and on, an underfilled winner, a dropped
  candidate and the rung probes;
- the cache file across the packages (fingerprints patched to one value,
  `time.time` fixed): equal bytes, each package loading the other's
  entry; quarantine of bad magic, a truncation and a CRC flip, with
  distinct forensic copies and JAX's error strings;
- `distributed.search(chunk=None, tuner=...)` on two CPU workers against
  JAX's `search` on `worker_mesh(2)` from one cache entry, with and
  without the ladder (the entry's `rung_modes` admitting a rung); a
  tuner of another device type refused.

The port's real harness also runs a cold sweep, a zero-probe warm boot,
the hot path and the `tune_sweep` command. Every cache lives under
`tmp_path`; `TTS_*` variables go through `monkeypatch`; recorders and
registries through `_torch_isolation.isolated()`."""

import dataclasses
import json
import time

import numpy as np
import pytest

from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.obs import tracelog as jtracelog
from tpu_tree_search.ops import pallas_fused as jfused
from tpu_tree_search.parallel.mesh import worker_mesh
from tpu_tree_search.problems.pfsp import PFSPInstance
from tpu_tree_search.tune import cache as jcache, probe as jprobe
from tpu_tree_search.tune import tuner as jtuner
from tpu_tree_search_torch import tune as ttune, tune_report, tune_sweep
from tpu_tree_search_torch.engine import distributed as tdist
from tpu_tree_search_torch.engine import ladder as tladder
from tpu_tree_search_torch.obs import metrics as tmetrics
from tpu_tree_search_torch.obs import tracelog as ttracelog
from tpu_tree_search_torch.ops import fused as tfused
from tpu_tree_search_torch.problems import knapsack as tks, tsp as ttsp
from tpu_tree_search_torch.tune import cache as tcache, probe as tprobe
from tpu_tree_search_torch.tune import tuner as ttuner

import _torch_isolation
import _torch_threads

_torch_threads.share_cores()

TUNE_KW = dict(chunks=(8, 16), periods=(2, 4), window_iters=6,
               warm_iters=20, capacity=1 << 12, repeats=1)
FP = {"platform": "test", "device_count": 1, "device_kinds": ["test"],
      "process_count": 1}
# the flight recorder's own fields, which differ between two recorders
_STAMP = ("ts", "dur", "seq", "pid", "thread")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for name in ("TTS_TUNE_CHUNKS", "TTS_TUNE_PERIODS", "TTS_TUNE_WINDOW",
                 "TTS_TUNE_WARM", "TTS_TUNE_RUNGS", "TTS_FUSED",
                 "TTS_FUSED_INTERPRET", "TTS_LADDER"):
        monkeypatch.delenv(name, raising=False)
    with _torch_isolation.isolated():
        yield


@pytest.fixture
def one_fingerprint(monkeypatch):
    """Both packages' caches pinned to one fingerprint."""
    monkeypatch.setattr(jcache, "tuning_fingerprint",
                        lambda extra=None: dict(FP, **(extra or {})))
    monkeypatch.setattr(tcache, "tuning_fingerprint",
                        lambda extra=None, device="cuda":
                        dict(FP, **(extra or {})))


def small(seed=1, jobs=8, machines=3):
    return PFSPInstance.synthetic(jobs=jobs, machines=machines,
                                  seed=seed).p_times


def events(tracelog_mod, prefix="tuner"):
    return [{k: v for k, v in r.items() if k not in _STAMP}
            for r in tracelog_mod.get().records()
            if r.get("name", "").startswith(prefix)]


# ------------------------------------------------------------------ key

@pytest.mark.parametrize("fused", ["off", "hw"])
@pytest.mark.parametrize("batch", [None, 1, 4])
def test_key_and_file_name_match_jax(monkeypatch, fused, batch):
    # the port's own mode: "hw" on the card, nothing on the CPU
    assert ttuner.Autotuner.key(20, 20, 2, 4, device="cuda") \
        == ("pfsp", 20, 20, 2, 4, "fused", "hw")
    assert ttuner.Autotuner.key(20, 20, 2, 4, device="cpu") \
        == ("pfsp", 20, 20, 2, 4)
    if fused == "hw":
        monkeypatch.setattr(jfused, "resolve_mode", lambda flag=None: "hw")
        monkeypatch.setattr(tfused, "resolve_mode",
                            lambda mode=None, on_cuda=False: "hw")
    tables = {"pfsp": small(), "tsp": ttsp.TSPInstance.synthetic(7, 0).d,
              "knapsack": tks.KnapsackInstance.synthetic(10, 0).table}
    for problem in tables:
        for jobs, machines, lb, n in ((8, 3, 1, 1), (20, 20, 2, 4)):
            want = jtuner.Autotuner.key(jobs, machines, lb, n, problem,
                                        batch=batch)
            got = ttuner.Autotuner.key(jobs, machines, lb, n, problem,
                                       batch=batch, device="cpu")
            assert got == want
            assert tcache._key_digest(got) == jcache._key_digest(want)
    # the fused suffix only for a problem with a fused pipeline
    assert ttuner.Autotuner.key(8, 3, 1, 1, "tsp", device="cpu")[-1] == 1


# ---------------------------------------------------------------- probe

@pytest.mark.parametrize("lb_kind", [1, 2])
def test_probe_harness_counts_match_jax(monkeypatch, lb_kind):
    """The same warmed state and window in both packages: equal counts per
    candidate; every call of a port candidate (the first, which would
    capture on the card, and both repeats) counts the same."""
    calls = []
    real = tdist._DistDriver._drive

    def drive(self, states, ceiling, capacity):
        out, status = real(self, states, ceiling, capacity)
        calls.append((self.key[3], self.balance_period,
                      int(out[0].evals), int(out[0].iters)))
        return out, status

    monkeypatch.setattr(tdist._DistDriver, "_drive", drive)
    kw = dict(lb_kind=lb_kind, capacity=1 << 12, warm_chunk=8,
              warm_iters=20, window_iters=6)
    jh = jprobe.ProbeHarness(small(), repeats=1, **kw)
    th = tprobe.ProbeHarness(small(), repeats=2, device="cpu", **kw)
    assert (th.pool, th.iters0) == (jh.pool, jh.iters0)
    fields = ("evals", "window_iters", "pool_start", "underfilled",
              "transfer_cap", "chunk", "balance_period", "fused")
    for chunk in (8, 16):
        for period in (2, 4):
            want, got = jh.measure(chunk, period), th.measure(chunk, period)
            for f in fields:
                assert getattr(got, f) == getattr(want, f), (chunk, period,
                                                             f)
            assert got.evals > 0 and got.evals_per_s > 0
            mine = [c for c in calls if c[:2] == (chunk, period)]
            assert len(mine) == 3 and len(set(mine)) == 1
    # a chunk past the warmed pool is underfilled; one whose scratch
    # margin eats the pool is refused in both
    assert th.measure(256, 4).underfilled and jh.measure(256, 4).underfilled
    for h, err in ((jh, jprobe.ProbeError), (th, tprobe.ProbeError)):
        with pytest.raises(err, match="leaves no usable rows"):
            h.measure(1 << 11, 4)


def test_probe_harness_refuses_exhausted_instance():
    with pytest.raises(jprobe.ProbeError) as want:
        jprobe.ProbeHarness(small(jobs=4), warm_chunk=8, warm_iters=50,
                            capacity=1 << 12)
    with pytest.raises(ttune.ProbeError) as got:
        ttune.ProbeHarness(small(jobs=4), warm_chunk=8, warm_iters=50,
                           capacity=1 << 12, device="cpu")
    assert str(got.value) == str(want.value)


def test_measure_balance_periods_rows():
    rows = ttune.measure_balance_periods(small(), 1, 8, (2, 4),
                                         capacity=1 << 12, warm_iters=20,
                                         window_iters=6, repeats=1,
                                         device="cpu")
    assert [r["balance_period"] for r in rows] == [2, 4]
    assert all(r["ms_per_iter"] > 0 and r["evals_per_s"] > 0
               for r in rows)


# ------------------------------------------------ the sweep, fake rates

def fake_harness(probe_mod, seed, pool, drop, made):
    """A harness class whose rates come from a seeded table of (chunk,
    period, pipeline); the chunks in `drop` raise the package's
    ProbeError. `made` collects the constructor's arguments."""

    class Fake:
        def __init__(self, p_times, **kw):
            kw.pop("device", None)
            made.append(dict(kw, shape=np.shape(p_times)))

        def measure(self, chunk, balance_period, transfer_cap=None,
                    min_transfer=None, fused="off"):
            if chunk in drop:
                raise probe_mod.ProbeError(f"chunk {chunk} dropped")
            rng = np.random.default_rng(
                [seed, chunk, balance_period, int(fused != "off")])
            rate = round(float(rng.uniform(1e6, 1e8)), 1)
            return probe_mod.ProbeResult(
                chunk=chunk, balance_period=balance_period,
                transfer_cap=4 * chunk, evals_per_s=rate,
                ms_per_iter=round(float(rng.uniform(0.1, 5.0)), 4),
                window_iters=6, evals=int(rate), seconds=1.0,
                pool_start=pool, underfilled=pool < chunk, fused=fused)

    return Fake


SWEEPS = {
    # name: (fused route, seed, pool, dropped chunks, TTS_TUNE_RUNGS)
    "unfused-dropped": ("off", 0, 100, (64,), False),
    "unfused-rungs": ("off", 1, 100, (), True),
    "fused": ("hw", 2, 100, (), False),
    "fused-dropped": ("hw", 3, 100, (16,), False),
    "underfilled-winner": ("hw", 4, 4, (), False),
}


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_tune_matches_jax_under_fake_rates(tmp_path, monkeypatch,
                                           one_fingerprint, case):
    fused, seed, pool, drop, rungs = SWEEPS[case]
    if rungs:
        monkeypatch.setenv("TTS_TUNE_RUNGS", "1")
    if fused == "hw":
        monkeypatch.setattr(jfused, "resolve_mode", lambda flag=None: "hw")
    made = {"jax": [], "torch": []}
    monkeypatch.setattr(jtuner, "ProbeHarness",
                        fake_harness(jprobe, seed, pool, drop, made["jax"]))
    monkeypatch.setattr(ttuner, "ProbeHarness",
                        fake_harness(tprobe, seed, pool, drop,
                                     made["torch"]))
    kw = dict(chunks=(8, 16, 64, 256), periods=(1, 4, 16), window_iters=6,
              warm_iters=20, repeats=1)
    jt = jtuner.Autotuner(cache_dir=tmp_path / "jax", **kw)
    # the port's fused route is the card's: a tuner for the card
    tt = ttuner.Autotuner(cache_dir=tmp_path / "torch",
                          device="cuda" if fused == "hw" else "cpu", **kw)
    want = jt.resolve(20, 20, 2, n_workers=4, allow_probe=True,
                      p_times=small(jobs=20, machines=20))
    got = tt.resolve(20, 20, 2, n_workers=4, allow_probe=True,
                     p_times=small(jobs=20, machines=20))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.source == "probe" and bool(got.rung_modes) == (
        rungs or fused == "hw")
    assert made["torch"] == made["jax"]
    assert tt.ledger == jt.ledger and tt.probes_run == jt.probes_run
    key = ttuner.Autotuner.key(20, 20, 2, 4, device=tt.device)
    payloads = [c.cache.load(key) for c in (jt, tt)]
    for p in payloads:
        p.pop("sweep_seconds")
    assert payloads[0] == payloads[1]
    if drop:
        assert drop[0] not in [p["chunk"] for p in payloads[1]["probes"]]
    if pool == 4:
        assert all(p["underfilled"] for p in payloads[1]["probes"])
    jev, tev = events(jtracelog), events(ttracelog)
    for ev in (jev, tev):
        for e in ev:
            e.pop("bytes", None)      # the payload's seconds differ
    assert tev == jev
    names = [e["name"] for e in tev]
    assert "tuner.sweep" in names
    assert ("tuner.candidate_dropped" in names) == bool(drop)


# ----------------------------------------------- the real harness, CPU

def test_cold_sweep_then_zero_probe_warm_boot(tmp_path, monkeypatch):
    monkeypatch.setenv("TTS_TUNE_RUNGS", "1")
    reg = tmetrics.Registry("tts_test_tuner")
    root = tmp_path / "tune"
    t1 = ttune.Autotuner(cache_dir=root, registry=reg, device="cpu",
                         **TUNE_KW)
    assert t1.snapshot()["cache"]["entries"] == 0
    params = t1.resolve(8, 3, 1, allow_probe=True, p_times=small())
    assert params.source == "probe" and params.chunk in TUNE_KW["chunks"]
    assert params.balance_period in TUNE_KW["periods"] + (4,)
    assert t1.probes_run > 0 and len(t1.ledger) == t1.probes_run
    assert tuple(r["chunk"] for r in params.rung_modes) \
        == tladder.rungs_for(params.chunk, min_chunk=1)
    assert t1.cache.snapshot()["writes"] == 1
    flat = str(reg.to_json())
    assert "tts_tuner_probes_total" in flat
    assert "tts_tuner_probe_seconds" in flat
    assert "tts_tuner_cache_misses_total" in flat
    # the restarted process: the same directory, a fresh tuner, zero probes
    t2 = ttune.Autotuner(cache_dir=root, registry=reg, device="cpu",
                         **TUNE_KW)
    p2 = t2.resolve(8, 3, 1, allow_probe=True, p_times=small())
    assert p2 == dataclasses.replace(params, source="cache")
    assert t2.probes_run == 0 and t2.ledger == []
    assert t2.cache.snapshot()["hits"] == 1
    assert "tts_tuner_cache_hits_total" in str(reg.to_json())
    # the hot path never probes: a cold key resolves to the defaults
    t3 = ttune.Autotuner(cache_dir=tmp_path / "cold", device="cpu",
                         **TUNE_KW)
    hot = t3.resolve(8, 3, 1, allow_probe=False, p_times=small())
    assert hot.source == "default" and t3.probes_run == 0
    assert ttune.Autotuner(device="cpu", **TUNE_KW).resolve(8, 3, 1) \
        .source == "default"
    assert ttune.Autotuner(device="cpu", **TUNE_KW).snapshot()["cache"] \
        is None
    # a non-PFSP probe without its table degrades to the defaults
    assert t3.resolve(9, 9, 1, allow_probe=True, problem="tsp").source \
        == "default"
    assert t3.probes_run == 0


def test_env_knobs_set_the_candidates(monkeypatch):
    monkeypatch.setenv("TTS_TUNE_CHUNKS", "64,256")
    monkeypatch.setenv("TTS_TUNE_PERIODS", "2,x")     # malformed: default
    monkeypatch.setenv("TTS_TUNE_WINDOW", "12")
    t = ttune.Autotuner(device="cpu")
    j = jtuner.Autotuner()
    assert (t.chunks, t.periods, t.window_iters, t.warm_iters) \
        == (j.chunks, j.periods, j.window_iters, j.warm_iters) \
        == ((64, 256), (1, 4, 16), 12, 200)


# ---------------------------------------------------------------- cache

def test_cache_bytes_and_loads_across_packages(tmp_path, monkeypatch,
                                               one_fingerprint):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    key = ("pfsp", 20, 20, 2, 4, "fused", "hw")
    payload = {"chunk": 65536, "balance_period": 4, "transfer_cap": None,
               "evals_per_s": 3.5e8, "sweep_seconds": 12.5,
               "rung_modes": [{"chunk": 4096, "winner": "fused"}],
               "probes": []}
    jc, tc = jcache.TuningCache(tmp_path / "j"), \
        tcache.TuningCache(tmp_path / "t", device="cpu")
    jc.store(key, payload, key_repr="/".join(map(str, key)))
    tc.store(key, payload, key_repr="/".join(map(str, key)))
    assert tc.path_for(key).name == jc.path_for(key).name
    assert tc.path_for(key).read_bytes() == jc.path_for(key).read_bytes()
    # each loads the other's file
    jc2, tc2 = jcache.TuningCache(tmp_path / "t"), \
        tcache.TuningCache(tmp_path / "j", device="cpu")
    assert jc2.load(key) == tc2.load(key) == payload
    assert tc2.snapshot()["hits"] == 1
    # another fingerprint is ignored, never consumed
    other = tcache.TuningCache(tmp_path / "j", device="cpu",
                               fingerprint_extra={"sim": "B"})
    assert other.load(key) is None
    snap = other.snapshot()
    assert (snap["mismatches"], snap["quarantined"]) == (1, 0)


def test_cpu_fingerprint_asks_nothing_of_cuda(monkeypatch):
    import torch

    def refuse(*a, **k):
        raise AssertionError("torch.cuda touched")

    for name in ("device_count", "get_device_properties", "is_available",
                 "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    fp = tcache.tuning_fingerprint(device="cpu")
    assert fp == {"platform": "cpu", "device_count": 1,
                  "device_kinds": ["cpu"], "process_count": 1}
    assert set(fp) == set(jcache.tuning_fingerprint())


def _damage(path, how):
    blob = bytearray(path.read_bytes())
    if how == "magic":
        blob[0] ^= 0xFF
    elif how == "truncate":
        blob = blob[:-3]
    else:                      # the payload's last byte: the CRC fails
        blob[-1] ^= 0x01
    path.write_bytes(bytes(blob))


@pytest.mark.parametrize("how", ["magic", "truncate", "crc"])
def test_damaged_entry_quarantined_as_jax(tmp_path, one_fingerprint, how):
    key = ("pfsp", 8, 3, 1, 4)
    caches = {"jax": jcache.TuningCache(tmp_path / "j"),
              "torch": tcache.TuningCache(tmp_path / "t", device="cpu")}
    for c in caches.values():
        for round_ in range(2):
            c.store(key, {"chunk": 64, "round": round_})
            _damage(c.path_for(key), how)
            assert c.load(key) is None
        copies = sorted(f.name for f in c.root.iterdir()
                        if f.name.endswith(".corrupt"))
        assert len(copies) == len(set(copies)) == 2      # both survive
        snap = c.snapshot()
        assert (snap["errors"], snap["quarantined"], snap["hits"]) \
            == (2, 2, 0)
        c.store(key, {"chunk": 128})
        assert c.load(key)["chunk"] == 128
    errors = {name: [e["error"] for e in events(mod, "tuner_cache.quar")]
              for name, mod in (("jax", jtracelog), ("torch", ttracelog))}
    assert errors["torch"] == errors["jax"] and len(errors["jax"]) == 2


def test_tune_report_renders_both_packages(tmp_path, one_fingerprint,
                                           capsys):
    root = tmp_path / "tune"
    jcache.TuningCache(root).store(("pfsp", 8, 3, 1, 1), {
        "chunk": 16, "balance_period": 2, "evals_per_s": 1234.5,
        "probes": [{}], "sweep_seconds": 1.5}, key_repr="pfsp/8/3/1/1")
    tcache.TuningCache(root, device="cpu").store(("pfsp", 8, 3, 1, 2), {
        "chunk": 8, "balance_period": 4, "evals_per_s": 99.0,
        "probes": [{}, {}], "sweep_seconds": 2.0}, key_repr="pfsp/8/3/1/2")
    (root / "deadbeef.tune.corrupt").write_bytes(b"garbage")
    (root / "torn.tune").write_bytes(b"garbage")
    # a flipped payload digit keeps the length and fails the CRC: the
    # tuner would quarantine it, so the report shows no chunk 9 row
    blob = tcache.TuningCache(root, device="cpu").path_for(
        ("pfsp", 8, 3, 1, 2)).read_bytes()
    assert blob.count(b'"chunk": 8') == 1
    (root / "flipped.tune").write_bytes(
        blob.replace(b'"chunk": 8', b'"chunk": 9'))
    entries = [tune_report.read_entry(str(f))
               for f in sorted(root.iterdir()) if f.suffix == ".tune"]
    table = tune_report.render(entries, ["deadbeef.tune.corrupt"])
    assert "| pfsp/8/3/1/1 | 16 | 2 | 1234 |" in table
    assert "| pfsp/8/3/1/2 | 8 | 4 | 99 |" in table
    assert "| 9 |" not in table
    assert "| flipped.tune | - |" in table and "CRC mismatch" in table
    assert "| torn.tune | - |" in table and "bad magic" in table
    assert "Quarantined" in table and "deadbeef" in table
    assert tune_report.main([str(root)]) == 0
    assert "4 entr(y/ies), 1 quarantined" in capsys.readouterr().out
    assert tune_report.main([str(root), "--json"]) == 0
    assert '"quarantined": [' in capsys.readouterr().out
    assert tune_report.main([str(root / "missing")]) == 2


# ------------------------------------------------- search(tuner=...)

PROFILE = [  # chunk 16's rungs: 4 beats the top rung's time, 1 does not
    {"chunk": 16, "winner": "unfused", "ms_per_iter": 2.0,
     "ms_per_iter_unfused": 2.0, "ms_per_iter_fused": None,
     "evals_per_s_unfused": 10.0, "evals_per_s_fused": None},
    {"chunk": 4, "winner": "unfused", "ms_per_iter": 1.0,
     "ms_per_iter_unfused": 1.0, "ms_per_iter_fused": None,
     "evals_per_s_unfused": 10.0, "evals_per_s_fused": None},
    {"chunk": 1, "winner": "unfused", "ms_per_iter": 3.0,
     "ms_per_iter_unfused": 3.0, "ms_per_iter_fused": None,
     "evals_per_s_unfused": 1.0, "evals_per_s_fused": None}]


@pytest.mark.parametrize("ladder", [False, True])
def test_search_consumes_the_entry_as_jax(tmp_path, one_fingerprint,
                                          ladder):
    p = small()
    root = tmp_path / "tune"
    key = ttuner.Autotuner.key(8, 3, 1, 2, device="cpu")
    tcache.TuningCache(root, device="cpu").store(key, {
        "chunk": 16, "balance_period": 2, "transfer_cap": None,
        "evals_per_s": 1.0, "rung_modes": PROFILE, "probes": []},
        key_repr="/".join(map(str, key)))
    kw = dict(lb_kind=1, chunk=None, balance_period=None, capacity=1 << 12,
              min_seed=4)
    if ladder:
        kw.update(ladder=True, segment_iters=4)
    jt = jtuner.Autotuner(cache_dir=root, **TUNE_KW)
    tt = ttune.Autotuner(cache_dir=root, device="cpu", **TUNE_KW)
    want = jdist.search(p, mesh=worker_mesh(2), tuner=jt, **kw)
    got = tdist.search(p, devices=["cpu"] * 2, tuner=tt, **kw)
    assert (got.explored_tree, got.explored_sol, got.best, got.complete) \
        == (want.explored_tree, want.explored_sol, want.best, want.complete)
    for f in ("tree", "sol", "evals", "iters", "steals", "sent", "recv"):
        np.testing.assert_array_equal(np.asarray(got.per_device[f]),
                                      np.asarray(want.per_device[f]),
                                      err_msg=f)
    assert jt.probes_run == tt.probes_run == 0
    jev = events(jtracelog, "tuner.resolve")
    tev = events(ttracelog, "tuner.resolve")
    assert tev == jev
    assert tev[0]["source"] == "cache" and tev[0]["chunk"] == 16
    assert tev[0]["balance_period"] == 2 and tev[0]["rung_profile"]
    if ladder:
        rungs = [r for r in ttracelog.get().records()
                 if r.get("name") == "ladder.start"]
        assert rungs and rungs[0]["rungs"] == [4, 16]


def test_search_refuses_a_tuner_of_another_device(tmp_path, one_fingerprint):
    """A tuner keys its entries by the device it probes on (the card's
    fused mode, the card's hardware): a card tuner whose cache holds an
    entry for this shape does not resolve the knobs of a search on CPU
    workers, and loads nothing on the way."""
    root = tmp_path / "tune"
    card = ttune.Autotuner(cache_dir=root, **TUNE_KW)
    key = ttuner.Autotuner.key(8, 3, 1, 2, device="cuda")
    assert key != ttuner.Autotuner.key(8, 3, 1, 2, device="cpu")
    card.cache.store(key, {
        "chunk": 16, "balance_period": 2, "transfer_cap": None,
        "evals_per_s": 1.0, "rung_modes": None, "probes": []},
        key_repr="/".join(map(str, key)))
    with pytest.raises(ValueError, match="device='cpu'"):
        tdist.search(small(), devices=["cpu"] * 2, tuner=card, lb_kind=1,
                     chunk=None, capacity=1 << 12, min_seed=4)
    with pytest.raises(ValueError, match="probes on 'cuda'"):
        card.resolve(8, 3, 1, n_workers=2, device="cpu")
    assert card.probes_run == 0
    assert card.cache.snapshot()["hits"] == 0
    # the same entry under the CPU tuner's key runs the search at its chunk
    cpu = ttune.Autotuner(cache_dir=root, device="cpu", **TUNE_KW)
    cpu.cache.store(ttuner.Autotuner.key(8, 3, 1, 2, device="cpu"), {
        "chunk": 16, "balance_period": 2, "transfer_cap": None,
        "evals_per_s": 1.0, "rung_modes": None, "probes": []})
    res = tdist.search(small(), devices=["cpu"] * 2, tuner=cpu, lb_kind=1,
                       chunk=None, capacity=1 << 12, min_seed=4)
    assert res.complete and cpu.cache.snapshot()["hits"] == 1
    (ev,) = events(ttracelog, "tuner.resolve")
    assert ev["source"] == "cache" and ev["chunk"] == 16


def test_tune_sweep_prints_every_probe_and_persists(tmp_path, capsys):
    """`python -m tpu_tree_search_torch.tune_sweep` on the CPU at the
    parity scale: one line per probe of the ledger, then the winner; its
    entry is the one a warm resolve then replays with zero probes."""
    root = tmp_path / "tune"
    assert tune_sweep.main(["-i", "1", "-l", "2", "--device", "cpu",
                            "--chunks", "8,16", "--warm", "20",
                            "--window", "6",
                            "--repeats", "1", "--cache", str(root)]) == 0
    *probes, last = [json.loads(x) for x in
                     capsys.readouterr().out.strip().splitlines()]
    assert last["probes"] == len(probes) >= 3
    assert (last["warm"], last["window"], last["repeats"]) == (20, 6, 1)
    assert {p["pool_start"] for p in probes} == {last["warm_pool"]}
    assert all(p["instance"] == 1 and p["evals"] > 0 for p in probes)
    win = last["winner"]
    assert win["source"] == "probe" and win["chunk"] in (8, 16)
    assert last["peak_memory_bytes"] is None and last["card"] is None
    warm = ttune.Autotuner(cache_dir=root, device="cpu", **TUNE_KW)
    got = warm.resolve(20, 5, 2, allow_probe=True)
    assert warm.probes_run == 0 and got.source == "cache"
    assert (got.chunk, got.balance_period) == (win["chunk"],
                                               win["balance_period"])
