"""The port's search telemetry against the JAX package's.

The same JAX state (telemetry on) steps through both engines, and after
every step the port's telemetry vector must equal JAX's, with the
counters and the live pool, on each unfused route (LB1, LB1_d, the
`dense` LB2 route forced on both, `prefilter`); the fused routes are held
the same way in `test_torch_fused.py`. The update ops and the host view
are compared directly. All exact."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_tree_search.engine import device as jdevice
from tpu_tree_search.engine import telemetry as jtele
from tpu_tree_search.ops import batched as jbatched
from tpu_tree_search.problems.pfsp import PFSPInstance
from tpu_tree_search_torch import cli, convert
from tpu_tree_search_torch.engine import device as tdevice
from tpu_tree_search_torch.engine import telemetry as ttele
from tpu_tree_search_torch.ops import batched as tbatched

import _torch_threads

_torch_threads.share_cores()

_FIELDS = ("prmu", "depth", "aux", "size", "best", "tree", "sol", "iters",
           "evals", "sent", "recv", "steals", "overflow", "telemetry")


def _jnp_state(s) -> dict:
    return {f: np.asarray(getattr(s, f)) for f in _FIELDS}


def _instance(jobs, machines, seed):
    return PFSPInstance.synthetic(jobs=jobs, machines=machines,
                                  seed=seed).p_times


def test_layout_matches():
    names = ("DEPTH_BUCKETS", "BOUND_BINS", "RING", "O_POPPED", "O_BRANCHED",
             "O_PRUNED", "O_HIST_PRUNED", "O_HIST_SURV", "O_POOL_HW",
             "O_STEAL_SENT", "O_STEAL_RECV", "O_IMPROVED", "O_RING", "WIDTH",
             "ENV_FLAG")
    for n in names:
        assert getattr(ttele, n) == getattr(jtele, n), n
    assert ttele.WIDTH == 60


def test_off_by_default_zero_width(monkeypatch):
    p = _instance(7, 4, 0)
    monkeypatch.setenv(ttele.ENV_FLAG, "0")
    off = tdevice.init_state(7, 64, None, p_times=p, device="cpu")
    assert off.telemetry.shape == (0,) and off.telemetry.dtype == torch.int64
    monkeypatch.setenv(ttele.ENV_FLAG, "1")
    on = tdevice.init_state(7, 64, None, p_times=p, device="cpu")
    assert on.telemetry.shape == (ttele.WIDTH,)
    assert not on.telemetry.any()
    # an explicit argument wins over the flag
    assert tdevice.init_state(7, 64, None, p_times=p, telemetry=False,
                              device="cpu").telemetry.shape == (0,)


def _jstep_routed(route):
    """A jitted JAX step whose LB2 route is forced to `route` (the port's
    `route` argument); a wrapper of its own, so its trace cache is its
    own."""
    def f(tables, lb_kind, chunk, state, tile):
        real = jdevice.lb2_route
        jdevice.lb2_route = lambda *a, **k: (route,) + tuple(real(*a,
                                                                  **k)[1:])
        try:
            return jdevice.step(tables, lb_kind, chunk, state, tile=tile)
        finally:
            jdevice.lb2_route = real
    return jax.jit(f, static_argnums=(1, 2), static_argnames=("tile",))


_JSTEPS = {}


@pytest.mark.parametrize("lb_kind,route", [(1, None), (0, None),
                                           (2, "dense"), (2, "prefilter")])
def test_step_telemetry_matches_jax(lb_kind, route):
    """12 multi-tile steps (chunk 32 in tiles of 16) from ub=inf: the
    incumbent improves, so the ring fills, and the pool grows past a
    chunk."""
    p = _instance(9, 8, 7)
    jt = jbatched.make_tables(p)
    tt = tbatched.make_tables(p, device="cpu")
    js = jdevice.init_state(9, 1 << 13, None, p_times=p, telemetry=True)
    ts = convert.state_from_numpy(_jnp_state(js), device="cpu")
    jstep = _JSTEPS.setdefault(route, _jstep_routed(route or "prefilter"))
    for k in range(12):
        js = jstep(jt, lb_kind, 32, js, tile=16)
        ts = tdevice.step(tt, lb_kind, 32, ts, tile=16, route=route)
        want = _jnp_state(js)
        got = convert.state_to_numpy(ts)
        for f in ("size", "best", "tree", "sol", "iters", "evals"):
            assert int(got[f]) == int(want[f]), f"step {k + 1}: {f}"
        np.testing.assert_array_equal(got["telemetry"], want["telemetry"],
                                      err_msg=f"step {k + 1}")
        n = int(want["size"])
        np.testing.assert_array_equal(got["prmu"][:, :n],
                                      want["prmu"][:, :n])
    s = ttele.summarize(ts.telemetry)
    assert s == jtele.summarize(np.asarray(js.telemetry))
    assert s["improvements"] >= 1 and s["incumbent_ring"]
    # every evaluated child is branched, pruned or a leaf
    assert sum(s["branched"]) == ts.tree
    assert sum(s["branched"]) + sum(s["pruned"]) + ts.sol == ts.evals
    assert sum(s["bound_hist_surviving"]) == ts.tree
    assert sum(s["bound_hist_pruned"]) == sum(s["pruned"])


@pytest.mark.parametrize("fused", ["off", "interpret"])
def test_overflow_step_leaves_telemetry(fused):
    p = _instance(8, 4, 6)
    tt = tbatched.make_tables(p, device="cpu")
    state = tdevice.init_state(8, 128, None, p_times=p, telemetry=True,
                               device="cpu")
    state = tdevice.run(tt, state, 1, 8, max_iters=3, fused=fused)
    before = state.telemetry.clone()
    assert before.any()
    after = tdevice.step(tt, 1, 8, state, limit=state.size, fused=fused)
    assert after.overflow
    assert torch.equal(after.telemetry, before)


def test_telemetry_does_not_change_counts():
    p = _instance(9, 5, 1)
    tt = tbatched.make_tables(p, device="cpu")
    outs = []
    for on in (False, True):
        for lb in (0, 1, 2):
            s = tdevice.init_state(9, 1 << 12, None, p_times=p,
                                   telemetry=on, device="cpu")
            r = tdevice.run(tt, s, lb, 16)
            outs.append((r.tree, r.sol, r.best, r.evals, r.iters))
    assert outs[:3] == outs[3:]


def test_update_ops_match_jax():
    rng = np.random.default_rng(3)
    J = 13
    depth = rng.integers(0, J + 1, 500).astype(np.int32)
    mask = rng.random(500) < 0.6
    bounds = rng.integers(0, 3000, 500).astype(np.int32)
    jb = jtele.depth_bucket(jnp.asarray(depth), J)
    tb = ttele.depth_bucket(torch.as_tensor(depth), J)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(
        ttele.bucket_counts(tb, torch.as_tensor(mask)).numpy(),
        np.asarray(jtele.bucket_counts(jb, jnp.asarray(mask))))
    for best in (1000, 1, 0, 2**31 - 1):
        want = jtele.bound_hist(jnp.asarray(bounds), jnp.asarray(mask),
                                jnp.int32(best))
        for b in (best, torch.tensor(best, dtype=torch.int32)):
            got = ttele.bound_hist(torch.as_tensor(bounds),
                                   torch.as_tensor(mask), b)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_commit_ring_matches_jax():
    """Ten improvements wrap the ring of eight; high-water is a max."""
    t_vec = torch.zeros(ttele.WIDTH, dtype=torch.int64)
    j_vec = jnp.zeros(jtele.WIDTH, jnp.int64)
    rng = np.random.default_rng(0)
    best = 5000
    for it in range(30):
        new = best - int(rng.integers(1, 40)) if it % 3 == 0 else best
        size = int(rng.integers(0, 900))
        delta = rng.integers(0, 50, ttele.WIDTH).astype(np.int64)
        delta[ttele.O_POOL_HW:] = 0
        t_vec = ttele.commit(t_vec, torch.as_tensor(delta), size, new, best,
                             it)
        j_vec = jtele.commit(j_vec, jnp.asarray(delta), jnp.int32(size),
                             jnp.int32(new), jnp.int32(best), jnp.int64(it))
        best = new
        np.testing.assert_array_equal(t_vec.numpy(), np.asarray(j_vec))
    assert int(t_vec[ttele.O_IMPROVED]) == 10


def test_summarize_views():
    assert ttele.summarize(torch.zeros(0, dtype=torch.int64)) is None
    vec = np.arange(ttele.WIDTH, dtype=np.int64) * 3
    assert ttele.summarize(torch.as_tensor(vec)) == jtele.summarize(vec)
    assert ttele._ring_pairs(vec) == jtele._ring_pairs(vec)


def test_cli_search_telemetry_flag(monkeypatch, capsys):
    """--search-telemetry gives this run the vector and prints its summary
    after the results, without turning the flag on for the process; a run
    without it prints the results alone."""
    monkeypatch.setenv(ttele.ENV_FLAG, "0")
    argv = ["pfsp", "-i", "2", "-l", "1", "-u", "1", "--device", "cpu"]
    assert cli.main(argv + ["--search-telemetry"]) == 0
    assert not ttele.enabled()
    out = capsys.readouterr().out.splitlines()
    assert "Size of the explored tree: 30" in out
    head, _, body = out[-1].partition(": ")
    assert head == "Search telemetry"
    s = json.loads(body)
    assert sum(s["branched"]) == 30 and s["pool_highwater"] > 0
    assert cli.main(argv) == 0
    assert "Search telemetry" not in capsys.readouterr().out
