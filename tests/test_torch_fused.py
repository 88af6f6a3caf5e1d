"""The port's fused route against the JAX fused kernel and step.

The JAX fused kernel's cursor store calls `pl.store`, which the pinned
jax no longer has. The `jax_fused` fixture sets it, for the length of one
test, to the indexed store it stood for (`ref[idx] = val`), so that the
JAX kernel runs in interpret mode on the CPU and serves as the oracle;
nothing of the JAX package changes. Every comparison is exact (tolerance
0: integer math); inputs come from numpy seeds."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_tree_search.engine import device as jdevice
from tpu_tree_search.ops import batched as jbatched, pallas_expand as jpe
from tpu_tree_search.ops import pallas_fused as jfused
from tpu_tree_search.ops import reference as ref
from tpu_tree_search.problems import taillard
from tpu_tree_search.problems.pfsp import PFSPInstance
from tpu_tree_search_torch import convert
from tpu_tree_search_torch.engine import device as tdevice
from tpu_tree_search_torch.ops import batched as tbatched, expand as tex
from tpu_tree_search_torch.ops import fused as tfused, kernels

import _torch_threads

_torch_threads.share_cores()

_FIELDS = ("prmu", "depth", "aux", "size", "best", "tree", "sol", "iters",
           "evals", "sent", "recv", "steals", "overflow", "telemetry")


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX fused kernel runnable in interpret mode for this test. The
    traces made under the stand-in are dropped afterwards, so that no
    later test in the process reuses them."""
    monkeypatch.setattr(pl, "store",
                        lambda r, idx, val: r.__setitem__(idx, val),
                        raising=False)
    yield
    jax.clear_caches()


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _parents(jobs, machines, B, seed):
    """Random instance and B random parents (permutation, depth, front);
    every depth occurs, leaves (depth J-1) included."""
    rng = np.random.default_rng(seed)
    p = rng.integers(1, 100, size=(machines, jobs)).astype(np.int32)
    prmu = np.stack([rng.permutation(jobs) for _ in range(B)]) \
        .astype(np.int16)
    depth = rng.integers(0, jobs, size=B).astype(np.int32)
    front = ref.prefix_front_remain(p, prmu, depth)[:, :machines]
    return p, prmu.T.copy(), depth[None, :].copy(), \
        front.T.astype(np.int32).copy()


def _median_bound(p, prmu_T, depth2, front_T, tile):
    """A pruning cap that prunes about half of the real children."""
    tt = tbatched.make_tables(p, device="cpu")
    lb = tex.expand_bounds_plain(tt, _t(prmu_T), _t(depth2), _t(front_T), 1,
                                 tile).reshape(-1).numpy()
    J = prmu_T.shape[0]
    real = (np.arange(J)[None, :, None]
            >= depth2.reshape(-1, 1, tile)).reshape(-1)
    return int(np.median(lb[real]))


KERNEL_CASES = [
    # jobs, machines, B, tile, cap_width, n_valid, with_sched, tele_bins,
    # with_bounds, aux_i16, cap (None: the median real bound)
    (8, 5, 64, 64, 8 * 64, 64, False, 8, True, False, None),
    (8, 5, 64, 64, 128, 64, True, 8, True, True, 10 ** 6),    # spills
    (8, 4, 128, 32, 8 * 128, 100, True, 0, False, False, None),
    (20, 5, 64, 32, 20 * 64 // 4, 64, True, 8, False, False, None),
    (20, 6, 96, 32, 20 * 96, 61, False, 8, True, True, None),
    (40, 4, 32, 16, 40 * 32 // 4, 32, True, 8, False, False, None),
    (40, 3, 32, 32, 40 * 32, 20, True, 0, True, True, None),
]


@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=lambda c: "J{}M{}B{}t{}W{}n{}s{}h{}b{}i{}".format(
                             *c[:10]))
def test_fused_expand_matches_jax_kernel(jax_fused, case):
    """The port's fused_expand (plain version on the CPU) against the
    JAX fused kernel in interpret mode, output by output over the
    survivors [0, min(n_surv, W))."""
    (J, M, B, tile, W, nv, sched, bins, bnd, i16, cap) = case
    p, prmu_T, depth2, front_T = _parents(J, M, B, J * 7 + tile + nv)
    if cap is None:
        cap = _median_bound(p, prmu_T, depth2, front_T, tile)
    kw = dict(lb_kind=1, tile=tile, cap_width=W, with_sched=sched,
              tele_bins=bins, with_bounds=bnd, aux_i16=i16)
    want = jfused.fused_expand(
        jbatched.make_tables(p), jnp.asarray(prmu_T), jnp.asarray(depth2),
        jnp.asarray(front_T), jnp.int32(nv), jnp.int32(cap),
        interpret=True, **kw)
    got = tfused.fused_expand(
        tbatched.make_tables(p, device="cpu"), _t(prmu_T), _t(depth2),
        _t(front_T), nv, torch.tensor(cap, dtype=torch.int32), **kw)
    n_surv = int(want[4])
    assert int(got[4]) == n_surv and got[4].dtype == torch.int32
    n = min(n_surv, W)
    assert n > 0
    for name, w, g in zip(("children", "caux", "bounds", "sched"), want[:4],
                          got[:4]):
        assert (w is None) == (g is None), name
        if w is None:
            continue
        w = np.asarray(w)
        assert g.shape == (w.shape[0], W), name
        assert str(g.dtype).endswith(str(w.dtype)), name
        np.testing.assert_array_equal(g.numpy()[:, :n], w[:, :n],
                                      err_msg=name)
    if bins:
        np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
        assert got[5].dtype == torch.int64
    else:
        assert got[5] is None and want[5] is None


def _zero_depth_chunk(J=8, M=5, B=64):
    p = PFSPInstance.synthetic(jobs=J, machines=M, seed=1).p_times
    prmu = torch.arange(J, dtype=torch.int16)[:, None].expand(J, B) \
        .contiguous()
    return (tbatched.make_tables(p, device="cpu"), prmu,
            torch.zeros((1, B), dtype=torch.int32),
            torch.zeros((M, B), dtype=torch.int32))


def test_fused_expand_spill_count_and_prefix():
    """test_fused.py's spill contract on the port: with no incumbent every
    child of depth-0 parents survives, far past a small cap; the count
    stays exact, the prefix below the cap equals the roomy call's, and
    the pruned histogram is empty."""
    tables, prmu, depth, front = _zero_depth_chunk()
    J, B = prmu.shape
    kw = dict(lb_kind=1, tile=64, tele_bins=8)
    big = tfused.fused_expand(tables, prmu, depth, front, B, 10 ** 6,
                              cap_width=J * B, **kw)
    small = tfused.fused_expand(tables, prmu, depth, front, B, 10 ** 6,
                                cap_width=128, **kw)
    assert int(big[4]) == J * B
    assert int(small[4]) == int(big[4])
    assert small[0].shape == (J, 128)
    assert torch.equal(big[0][:, :128], small[0])
    assert torch.equal(big[5], small[5])
    assert int(big[5].sum()) == 0


def test_fused_expand_invalid_columns_masked():
    """Parents past n_valid contribute no survivor."""
    tables, prmu, depth, front = _zero_depth_chunk()
    J, B = prmu.shape
    out = tfused.fused_expand(tables, prmu, depth, front, 5, 10 ** 6,
                              lb_kind=1, tile=64, cap_width=J * B)
    assert int(out[4]) == 5 * J


def test_fused_expand_rejects_lb_other_than_lb1():
    tables, prmu, depth, front = _zero_depth_chunk()
    with pytest.raises(ValueError, match="LB1"):
        tfused.fused_expand(tables, prmu, depth, front, 64, 10 ** 6,
                            lb_kind=2, tile=64, cap_width=128)


@pytest.mark.parametrize("width", [0, 8 * 64 + 1])
def test_fused_expand_rejects_a_frame_outside_the_grid(width):
    tables, prmu, depth, front = _zero_depth_chunk()
    with pytest.raises(ValueError, match="cap_width"):
        tfused.fused_expand(tables, prmu, depth, front, 64, 10 ** 6,
                            lb_kind=1, tile=64, cap_width=width)


def test_store_sub_geometry():
    for n in (64, 576, 1280, 20480, 40 * 1024):
        assert tfused.store_sub(n) == jfused.store_sub(n)


# ----------------------------------------------------------------- gates


def test_fused_ok_shares_the_expand_shape_rule():
    """"hw" sits behind the expand kernel's shape rule exactly (checked
    with a CUDA-typed device: the rule itself needs no card)."""
    cuda = torch.device("cuda")
    accepted, rejected = (20, 1024, 1, 20), (8, 64, 1, 3)
    assert tex.kernel_shape_ok(*accepted[:3], accepted[3])
    assert tfused.fused_ok("hw", *accepted, device=cuda)
    assert not tex.kernel_shape_ok(*rejected[:3], rejected[3])
    assert not tfused.fused_ok("hw", *rejected, device=cuda)
    assert not tfused.fused_ok("hw", 20, 1024, 2, 20, device=cuda)
    # the classes the card admits: ta021/ta051 LB2 prefilter, LB1 on the
    # 20- to 200-job classes; not ta071/ta091 LB2, not ta111
    for inst, lb, want in ((21, 2, True), (51, 2, True), (71, 2, False),
                           (91, 2, False), (111, 2, False), (1, 1, True),
                           (31, 1, True), (61, 1, True), (91, 1, True),
                           (111, 1, False)):
        M, J = taillard.processing_times(inst).shape
        if lb == 2:
            route, TB, _ = tdevice.lb2_route(J, M, M * (M - 1) // 2, 65536)
            ok = route == "prefilter" and tfused.fused_ok(
                "hw", J, TB, lb, M, device=cuda)
        else:
            TB = tex.effective_tile(J, 65536, 1024, lb, machines=M)
            ok = tfused.fused_ok("hw", J, TB, lb, M, device=cuda)
        assert ok == want, (inst, lb)


def test_fused_ok_gates():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not tfused.fused_ok("off", 20, 1024, 1, 20)
    assert not tfused.fused_ok("off", 20, 1024, 1, 20, device=cuda)
    assert not tfused.fused_ok("interpret", 20, 1024, 0, 20)
    assert not tfused.fused_ok("interpret", 20, 1024, 3, 20)
    assert tfused.fused_ok("interpret", 8, 64, 1, 3, device=cpu)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfused.fused_ok("hw", 20, 1024, 1, 20, device=cpu)
    with pytest.raises(ValueError, match="CPU tensors"):
        tfused.fused_ok("interpret", 8, 64, 1, 3, device=cuda)
    with pytest.raises(ValueError, match="not one of"):
        tfused.fused_ok("fast", 8, 64, 1, 3)


RESOLVE_CASES = [
    # mode, on_cuda, resolved (None is the default: what the run observes)
    (None, False, "off"), (None, True, "hw"),
    ("off", False, "off"), ("off", True, "off"),
    ("hw", True, "hw"), ("hw", False, "hw"),
    ("interpret", False, "interpret"), ("interpret", True, "interpret"),
]


@pytest.mark.parametrize("mode,on_cuda,want", RESOLVE_CASES)
def test_resolve_mode(mode, on_cuda, want):
    """The default follows the tensors' device; an explicit mode passes
    through (fused_ok then refuses one that does not fit the device)."""
    assert tfused.resolve_mode(mode, on_cuda=on_cuda) == want


@pytest.mark.parametrize("bad", ["on", True, 1])
def test_resolve_mode_rejects_anything_else(bad):
    with pytest.raises(ValueError, match="not one of"):
        tfused.resolve_mode(bad)


def test_no_environment_flag_picks_the_route(monkeypatch):
    """The old TTS_FUSED switches are gone: setting them changes nothing,
    and no module of the port names them."""
    monkeypatch.setenv("TTS_FUSED", "1")
    monkeypatch.setenv("TTS_FUSED_INTERPRET", "1")
    assert tfused.resolve_mode(None) == "off"
    assert tfused.resolve_mode(None, on_cuda=True) == "hw"
    assert not hasattr(tfused, "FUSED_FLAG")
    root = Path(tfused.__file__).resolve().parent.parent
    for path in root.rglob("*.py"):
        assert "TTS_FUSED" not in path.read_text(), path


@pytest.mark.parametrize("entry", ["run", "step", "search"])
def test_cpu_default_route_is_unfused(monkeypatch, entry):
    """With no `fused` argument a CPU run never enters the fused route, so
    the JAX parity tests keep comparing like with like."""
    seen = []
    real = tdevice._fused_step
    monkeypatch.setattr(tdevice, "_fused_step",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    p = PFSPInstance.synthetic(jobs=8, machines=4, seed=3).p_times
    tt = tbatched.make_tables(p, device="cpu")
    s = tdevice.init_state(8, 1 << 12, None, p_times=p, device="cpu")
    if entry == "run":
        out = tdevice.run(tt, s, 1, 8, max_iters=5)
    elif entry == "step":
        out = tdevice.step(tt, 2, 8, s)
    else:
        out = tdevice.search(p, lb_kind=2, chunk=8, capacity=1 << 12,
                             device="cpu")
    assert out.iters > 0 and not seen


def test_hw_mode_on_cpu_tensors_raises():
    """A CPU run asked for the kernel raises instead of running the plain
    version; the kernel wrapper refuses CPU tensors and counts nothing."""
    p = PFSPInstance.synthetic(jobs=8, machines=3, seed=0).p_times
    tt = tbatched.make_tables(p, device="cpu")
    s = tdevice.init_state(8, 1 << 12, None, p_times=p, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tdevice.run(tt, s, 1, 8, fused="hw")
    before = dict(kernels.LAUNCHES)
    tables, prmu, depth, front = _zero_depth_chunk()
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.fused_expand(tables, prmu, depth, front, 64, 10 ** 6, 64,
                             128, False, 0, True, False)
    assert kernels.LAUNCHES == before


# ------------------------------------------------------------ step parity


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


_jstep_fused = jax.jit(jdevice.step, static_argnums=(1, 2),
                       static_argnames=("tile", "fused"))


def _fused_step_parity(p, lb_kind, chunk, tile, steps, init_ub=None):
    jobs = p.shape[1]
    jt = jbatched.make_tables(p)
    tt = tbatched.make_tables(p, device="cpu")
    js = jdevice.init_state(jobs, 1 << 14, init_ub, p_times=p,
                            telemetry=True)
    ts = convert.state_from_numpy(_jnp_state(js), device="cpu")
    for k in range(steps):
        js = _jstep_fused(jt, lb_kind, chunk, js, tile=tile,
                          fused="interpret")
        ts = tdevice.step(tt, lb_kind, chunk, ts, tile=tile,
                          fused="interpret")
        _assert_same(_jnp_state(js), convert.state_to_numpy(ts),
                     f"step {k + 1}")
    return ts


@pytest.mark.parametrize("lb_kind", [1, 2])
def test_fused_step_matches_jax_fused_step(jax_fused, lb_kind):
    """Counters, live pool and telemetry after every one of 12 multi-tile
    steps from the same state (chunk 64 in tiles of 32; 8 machines give
    LB2 28 pairs, so its tail splits into head and tail sweeps)."""
    p = PFSPInstance.synthetic(jobs=9, machines=8, seed=4).p_times
    out = _fused_step_parity(p, lb_kind, chunk=64, tile=32, steps=12)
    assert out.size > 64 and out.telemetry.shape == (60,)


def test_fused_lb2_spill_matches_jax(jax_fused, monkeypatch):
    """ub=inf from the root: the early LB2 steps keep every child, past the
    N/4 frame of JAX's fused step, which hands them to its spill branch
    (`spill_tail`). The port's fused step runs the kernel at frame N, so
    it keeps them all itself and never needs the unfused route; the state
    still equals JAX's after every step."""
    widths, survivors = [], []
    real = tfused.fused_expand

    def spy(*args, **kw):
        out = real(*args, **kw)
        widths.append(kw["cap_width"])
        survivors.append(int(out[4]))
        return out

    monkeypatch.setattr(tfused, "fused_expand", spy)
    p = PFSPInstance.synthetic(jobs=10, machines=8, seed=2).p_times
    _fused_step_parity(p, 2, chunk=64, tile=32, steps=6)
    N = 64 * 10
    # every step ran the fused kernel at frame N; some kept more than N/4
    # survivors (a JAX spill), some fewer
    assert widths == [N] * 6
    assert any(n > N // 4 for n in survivors)
    assert any(n <= N // 4 for n in survivors)


# ---------------------------------------------------- fused equals unfused


@pytest.mark.parametrize("jobs,machines,seed", [(7, 4, 0), (8, 5, 1),
                                                (9, 3, 2)])
@pytest.mark.parametrize("lb_kind", [1, 2])
def test_run_fused_equals_unfused(jobs, machines, seed, lb_kind):
    p = PFSPInstance.synthetic(jobs=jobs, machines=machines,
                               seed=seed).p_times
    tt = tbatched.make_tables(p, device="cpu")
    out = []
    for mode in ("off", "interpret"):
        s = tdevice.init_state(jobs, 1 << 12, None, p_times=p,
                               telemetry=True, device="cpu")
        r = tdevice.run(tt, s, lb_kind, 8, fused=mode)
        out.append((r.tree, r.sol, r.best, r.evals, r.iters,
                    r.telemetry.tolist()))
    assert out[0] == out[1]


def test_search_fused_ta002_lb1_golden(monkeypatch):
    """fused="interpret" runs the CPU search through the fused route and
    keeps the ta002 LB1 golden."""
    seen = []
    real = tdevice._fused_step
    monkeypatch.setattr(tdevice, "_fused_step",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    out = tdevice.search(taillard.processing_times(2), lb_kind=1,
                         init_ub=1359, chunk=64, capacity=1 << 16,
                         device="cpu", fused="interpret")
    # tests/golden/pfsp_lb1_ub1.jsonl, ta002
    assert (out.explored_tree, out.explored_sol, out.best) == (30, 0, 1359)
    assert seen


def test_fused_kernel_tile_rule_is_the_expand_rule():
    """The fused route's tile is the expand kernels' (it fixes the column
    order both routes push in)."""
    for J, M, B in ((20, 20, 65536), (50, 20, 16384), (20, 5, 4096)):
        for lb in (1, 2):
            assert tex.effective_tile(J, B, 1024, lb, machines=M) == \
                jpe.effective_tile(J, B, 1024, lb, machines=M)
