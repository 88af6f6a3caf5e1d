"""The port's device-resident loop against the JAX engine.

`device.step` keeps every count on the device and reads nothing back:
during a CPU step on every route, the tensor methods that read a value to
the host raise, and the state after each step equals the JAX step's
(counters, live pool `[0, size)`, telemetry), with telemetry on and off.
`device.run` runs blocks of K steps whose steps past the loop condition
are device no-ops, and reads `size`, `overflow` and `iters` once a block;
its result equals JAX's `run` for several ceilings, block lengths,
`drain_min` and an overflow inside a block. The JAX fused kernel runs in
interpret mode through the `pl.store` stand-in of `test_torch_fused.py`.
All exact (tolerance 0: integer math); inputs from numpy seeds."""

import contextlib

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_tree_search.engine import device as jdevice
from tpu_tree_search.ops import batched as jbatched
from tpu_tree_search.problems.pfsp import PFSPInstance
from tpu_tree_search_torch import convert
from tpu_tree_search_torch.engine import checkpoint as tcheckpoint
from tpu_tree_search_torch.engine import device as tdevice
from tpu_tree_search_torch.ops import batched as tbatched, columns, kernels
from tpu_tree_search_torch.ops import expand as tex

import _torch_threads

_torch_threads.share_cores()

_FIELDS = ("prmu", "depth", "aux", "size", "best", "tree", "sol", "iters",
           "evals", "sent", "recv", "steals", "overflow", "telemetry")
# the tensor methods that hand a value to the host
_READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__index__",
          "__float__")


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX fused kernel runnable in interpret mode for this test (the
    same stand-in as `test_torch_fused.py`'s); its traces are dropped
    afterwards."""
    monkeypatch.setattr(pl, "store",
                        lambda r, idx, val: r.__setitem__(idx, val),
                        raising=False)
    yield
    jax.clear_caches()


@contextlib.contextmanager
def no_read_back():
    """Every read of a tensor's value to the host raises."""
    def refuse(self, *args, **kw):
        raise AssertionError("a tensor value was read back to the host")

    with pytest.MonkeyPatch.context() as mp:
        for name in _READS:
            mp.setattr(torch.Tensor, name, refuse)
        yield


def _instance(jobs, machines, seed):
    return PFSPInstance.synthetic(jobs=jobs, machines=machines,
                                  seed=seed).p_times


def _jnp_state(s) -> dict:
    return {f: np.asarray(getattr(s, f)) for f in _FIELDS}


def _assert_same(want: dict, got: dict, where: str):
    for f in ("size", "best", "tree", "sol", "iters", "evals", "overflow"):
        assert int(got[f]) == int(want[f]), f"{where}: {f}"
    np.testing.assert_array_equal(got["telemetry"], want["telemetry"],
                                  err_msg=f"{where}: telemetry")
    n = int(want["size"])
    for f in ("prmu", "aux"):
        np.testing.assert_array_equal(got[f][:, :n], want[f][:, :n],
                                      err_msg=f"{where}: {f}")
    np.testing.assert_array_equal(got["depth"][:n], want["depth"][:n],
                                  err_msg=f"{where}: depth")


@contextlib.contextmanager
def _routed(module, route):
    """`module.lb2_route` forced to `route` (None: unchanged)."""
    real = module.lb2_route
    if route is not None:
        module.lb2_route = lambda *a, **k: (route,) + tuple(real(*a, **k)[1:])
    try:
        yield
    finally:
        module.lb2_route = real


_JSTEPS = {}


def _jstep(route):
    """A jitted JAX step whose LB2 route is forced to `route`; a wrapper
    of its own per route, so its trace cache is its own."""
    def f(tables, lb_kind, chunk, state, tile, fused):
        with _routed(jdevice, route):
            return jdevice.step(tables, lb_kind, chunk, state, tile=tile,
                                fused=fused)
    if route not in _JSTEPS:
        _JSTEPS[route] = jax.jit(f, static_argnums=(1, 2),
                                 static_argnames=("tile", "fused"))
    return _JSTEPS[route]


def _pair(p, capacity, init_ub, telemetry):
    jobs = p.shape[1]
    js = jdevice.init_state(jobs, capacity, init_ub, p_times=p,
                            telemetry=telemetry)
    return (jbatched.make_tables(p), js, tbatched.make_tables(p, device="cpu"),
            convert.state_from_numpy(_jnp_state(js), device="cpu"))


# ------------------------------------------------------------------ step

STEP_ROUTES = [  # lb_kind, route, fused
    (1, None, "off"), (0, None, "off"), (2, "dense", "off"),
    (2, "prefilter", "off"), (1, None, "interpret"),
    (2, "prefilter", "interpret")]


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("lb_kind,route,fused", STEP_ROUTES)
def test_step_reads_nothing_back_and_matches_jax(request, lb_kind, route,
                                                 fused, telemetry):
    """8 multi-tile steps (chunk 32 in tiles of 16, 8 machines: LB2 splits
    into head and tail sweeps) from ub=inf, each with every host read
    refused, each state equal to the JAX step's."""
    if fused == "interpret":
        request.getfixturevalue("jax_fused")
    p = _instance(9, 8, 7)
    jt, js, tt, ts = _pair(p, 1 << 13, None, telemetry)
    jstep = _jstep(route)
    for k in range(8):
        js = jstep(jt, lb_kind, 32, js, tile=16, fused=fused)
        with no_read_back():
            ts = tdevice.step(tt, lb_kind, 32, ts, tile=16, route=route,
                              fused=fused)
        _assert_same(_jnp_state(js), convert.state_to_numpy(ts),
                     f"step {k + 1}")
    assert int(ts.size) > 32 and int(ts.tree) > 0


def test_no_read_back_guard_refuses_every_read():
    x = torch.tensor(3)
    with no_read_back():
        for read in (x.item, x.tolist, x.numpy, lambda: bool(x),
                     lambda: int(x), lambda: float(x), lambda: [0][x]):
            with pytest.raises(AssertionError, match="read back"):
                read()
    assert int(x) == 3


def test_counters_are_device_scalars_with_jax_dtypes():
    p = _instance(8, 4, 0)
    js = jdevice.init_state(8, 256, 700, p_times=p, telemetry=False)
    ts = tdevice.init_state(8, 256, 700, p_times=p, telemetry=False,
                            device="cpu")
    for f, dtype in tdevice.COUNTER_DTYPES.items():
        t = getattr(ts, f)
        assert isinstance(t, torch.Tensor) and t.shape == (), f
        assert t.dtype == dtype, f
        assert str(np.asarray(getattr(js, f)).dtype) == \
            str(dtype).split(".")[-1], f
    assert tdevice.counters(ts) == (1, 700, 0, 0, 0, 0, 0, 0, 0, False)
    grown = tcheckpoint.grow(ts._replace(overflow=torch.tensor(True)), 512)
    assert grown.overflow.dtype == torch.bool and not grown.overflow


def test_step_inactive_is_a_no_op():
    """A step whose `active` is False pops, commits and counts nothing:
    the counters, telemetry and live pool stay as they were."""
    p = _instance(9, 5, 3)
    tt = tbatched.make_tables(p, device="cpu")
    s = tdevice.init_state(9, 1 << 12, None, p_times=p, telemetry=True,
                           device="cpu")
    s = tdevice.run(tt, s, 1, 16, max_iters=4)
    before = convert.state_to_numpy(s)
    for fused in ("off", "interpret"):
        out = tdevice.step(tt, 1, 16, s, fused=fused,
                           active=torch.tensor(False))
        _assert_same(before, convert.state_to_numpy(out), fused)


# ------------------------------------------------------------------- run

_JRUNS = {}


def _jax_run(p, lb_kind, chunk, tile, capacity, max_iters, drain_min=1,
             telemetry=True, after=0):
    """JAX `run` from the root (after `after` iterations of a first run
    with drain_min 1), cached by its arguments."""
    key = (p.tobytes(), lb_kind, chunk, tile, capacity, max_iters,
           drain_min, telemetry, after)
    if key not in _JRUNS:
        jt, js, _, _ = _pair(p, capacity, None, telemetry)
        if after:
            js = jdevice.run(jt, js, lb_kind, chunk, max_iters=after,
                             tile=tile, fused="off")
        out = jdevice.run(jt, js, lb_kind, chunk, max_iters=max_iters,
                          tile=tile, drain_min=drain_min, fused="off")
        _JRUNS[key] = _jnp_state(out)
    return _JRUNS[key]


@pytest.mark.parametrize("K", [1, 7, 32])
@pytest.mark.parametrize("max_iters", [1, 5, 17])
def test_run_matches_jax_run(max_iters, K):
    """LB2 `prefilter` with telemetry, ub=inf: the state after `run` with a
    ceiling equals JAX's, whatever the block length."""
    p = _instance(9, 8, 7)
    want = _jax_run(p, 2, 32, 16, 1 << 13, max_iters)
    _, _, tt, ts = _pair(p, 1 << 13, None, True)
    out = tdevice.run(tt, ts, 2, 32, max_iters=max_iters, tile=16,
                      steps_per_check=K)
    _assert_same(want, convert.state_to_numpy(out), f"K={K}")
    assert int(want["iters"]) == max_iters


@pytest.mark.parametrize("lb_kind,route", [(1, None), (0, None),
                                           (2, "dense")])
def test_run_to_completion_matches_jax_run(lb_kind, route):
    """Every unfused route drained to the end (7-step blocks), telemetry
    off; the dense route forced on both sides."""
    p = _instance(8, 5, 2)
    jt, js, tt, ts = _pair(p, 1 << 12, None, False)
    with _routed(jdevice, route):
        # a (chunk, tile) no other test of this file uses, so the forced
        # route's trace is its own; dropped below
        want = _jnp_state(jdevice.run(jt, js, lb_kind, 24, tile=8,
                                      fused="off"))
    jax.clear_caches()
    with _routed(tdevice, route):
        out = tdevice.run(tt, ts, lb_kind, 24, tile=8, steps_per_check=7)
    _assert_same(want, convert.state_to_numpy(out), "drained")
    assert int(want["size"]) == 0 and int(want["iters"]) % 7 != 0


def test_run_fused_matches_jax_run(jax_fused):
    p = _instance(9, 8, 4)
    jt, js, tt, ts = _pair(p, 1 << 13, None, True)
    want = _jnp_state(jdevice.run(jt, js, 2, 32, max_iters=9, tile=16,
                                  fused="interpret"))
    out = tdevice.run(tt, ts, 2, 32, max_iters=9, tile=16,
                      fused="interpret", steps_per_check=4)
    _assert_same(want, convert.state_to_numpy(out), "fused")


@pytest.mark.parametrize("K", [7, 32])
def test_run_drain_min_matches_jax_run(K):
    """drain_min > 1: from a pool of a few hundred nodes (3 iterations
    from the root), the loop stops once it holds fewer than 100."""
    p = _instance(9, 8, 7)
    want = _jax_run(p, 2, 32, 16, 1 << 13, 60, drain_min=100, after=3)
    _, _, tt, ts = _pair(p, 1 << 13, None, True)
    ts = tdevice.run(tt, ts, 2, 32, max_iters=3, tile=16)
    assert int(ts.size) >= 100
    out = tdevice.run(tt, ts, 2, 32, max_iters=60, tile=16, drain_min=100,
                      steps_per_check=K)
    _assert_same(want, convert.state_to_numpy(out), f"K={K}")
    iters = int(want["iters"])
    assert int(want["size"]) < 100 and 3 < iters < 60 and iters % K != 0


@pytest.mark.parametrize("K", [7, 32])
def test_run_overflow_inside_a_block_matches_jax_run(K):
    """A pool whose usable rows run out mid-block: the overflowing step
    commits nothing but its iteration and the flag, every later step of
    the block is a no-op, and the state equals JAX's."""
    p = _instance(9, 8, 7)
    capacity = 32 * 9 + 120
    want = _jax_run(p, 2, 32, 16, capacity, None)
    _, _, tt, ts = _pair(p, capacity, None, True)
    out = tdevice.run(tt, ts, 2, 32, tile=16, steps_per_check=K)
    _assert_same(want, convert.state_to_numpy(out), f"K={K}")
    iters = int(want["iters"])
    assert bool(want["overflow"]) and iters % K != 0
    assert int(want["size"]) <= tdevice.row_limit(capacity, 32, 9)


def test_run_reads_three_counters_once_a_block():
    """One read at entry, then one per block of K steps; nothing else."""
    p = _instance(9, 8, 7)
    _, _, tt, ts = _pair(p, 1 << 13, None, False)
    reads = []
    real = torch.Tensor.tolist

    def counted(self):
        reads.append(tuple(self.shape))
        return real(self)

    with no_read_back(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "tolist", counted)
        out = tdevice.run(tt, ts, 1, 32, max_iters=17, tile=16,
                          steps_per_check=7)
    assert reads == [(3,)] * 4          # entry, then after 7, 14 and 17
    assert int(out.iters) == 17


def test_run_on_a_full_pool_reports_overflow():
    p = _instance(8, 4, 0)
    tt = tbatched.make_tables(p, device="cpu")
    s = tdevice.init_state(8, 128, None, p_times=p, device="cpu")
    full = s._replace(size=torch.tensor(100, dtype=torch.int32))
    out = tdevice.run(tt, full, 1, 8)
    assert bool(out.overflow) and int(out.iters) == 0


# ------------------------------------------------ pieces of the loop


@pytest.mark.parametrize("n,density,seed", [(0, 0.5, 0), (1, 1.0, 0),
                                            (1, 0.0, 0), (777, 0.3, 1),
                                            (4096, 0.93, 2), (513, 0.0, 3),
                                            (513, 1.0, 4)])
def test_partition_is_the_stable_argsort(n, density, seed):
    push = torch.as_tensor(np.random.default_rng(seed).random(n) < density)
    want = torch.argsort((~push).to(torch.uint8), stable=True)
    got = columns.partition(push)
    assert got.dtype == torch.int64 and torch.equal(got, want)


def test_lb2_bounds_live_count_masks_past_it():
    rng = np.random.default_rng(5)
    p = rng.integers(1, 100, size=(6, 12)).astype(np.int32)
    tt = tbatched.make_tables(p, device="cpu")
    prmu = torch.as_tensor(np.stack([rng.permutation(12) for _ in range(8)])
                           .T.astype(np.int16).copy())
    depth = torch.as_tensor(rng.integers(0, 12, (1, 8)).astype(np.int32))
    front = torch.zeros((6, 8), dtype=torch.int32)
    cf, sched = tex.expand_fronts_plain(tt, prmu, depth, front, 8)
    full = tex.lb2_bounds(tt, cf, sched)
    for live in (0, 1, 37, 96, 200):
        got = tex.lb2_bounds(tt, cf, sched,
                             live=torch.tensor(live, dtype=torch.int32))
        keep = torch.arange(96) < live
        assert torch.equal(got[0, keep], full[0, keep])
        assert (got[0, ~keep] == tex.I32_MAX).all()


def test_graph_key_follows_the_pool_storage():
    """A new pool (after `checkpoint.grow`) needs a new capture; new
    counters on the same pool do not."""
    p = _instance(8, 4, 0)
    tt = tbatched.make_tables(p, device="cpu")
    s = tdevice.init_state(8, 256, None, p_times=p, device="cpu")
    key = tdevice._graph_key(tt, s, 1, 8, 1024, "off", 32)
    other = s._replace(size=torch.tensor(0, dtype=torch.int32))
    assert tdevice._graph_key(tt, other, 1, 8, 1024, "off", 32) == key
    assert tdevice._graph_key(tt, tcheckpoint.grow(s, 512), 1, 8, 1024,
                              "off", 32) != key
    assert tdevice._graph_key(tt, s, 1, 8, 1024, "off", 7) != key


def test_captured_launches_count_at_each_replay(monkeypatch):
    """A launch under capture counts once per replay of its graph, not at
    capture."""
    class FakeGraph:
        replays = 0

        def replay(self):
            self.replays += 1

    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES,
                                                           0))
    monkeypatch.setattr(kernels, "CAPTURED", dict.fromkeys(kernels.LAUNCHES,
                                                           0))
    monkeypatch.setattr(kernels, "REPLAYED", dict.fromkeys(kernels.LAUNCHES,
                                                           0))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    for _ in range(3):
        kernels._count("fused_expand")
    kernels._count("lb2_sweep")
    tally = kernels.take_captured()
    assert tally == {"fused_expand": 3, "lb2_sweep": 1}
    assert not any(kernels.LAUNCHES.values())
    assert not any(kernels.CAPTURED.values())
    g = FakeGraph()
    for _ in range(2):
        kernels.replay(g, tally)
    assert g.replays == 2
    assert kernels.LAUNCHES["fused_expand"] == 6
    assert kernels.LAUNCHES["lb2_sweep"] == 2
    assert kernels.REPLAYED == kernels.LAUNCHES
    kernels.reset_launches()
    assert not any(kernels.REPLAYED.values())
