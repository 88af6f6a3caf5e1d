"""The port's plain bound paths against the JAX package's references.

`expand_plain`/`expand_bounds_plain`/`lb2_plain` (the plain versions of
the Hopper kernels) against `expand_xla`/`expand_bounds_xla`/`lb2_cols`
(the plain references of the Pallas kernels) and against the streaming
big-J Pallas kernel in interpret mode; the row-major
`lb1_children`/`lb1d_children`/`lb2_children` (with `parent_tables`,
`child_mask`, `bounds_from_parts`) against JAX's at the shapes of
`tests/test_bounds.py`. Inputs come from numpy seeds; every
comparison is exact (tolerance 0: integer math)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_tree_search.engine import device as jdevice
from tpu_tree_search.ops import batched as jbatched, pallas_expand as jpe
from tpu_tree_search.ops import reference as ref
from tpu_tree_search_torch.engine import device as tdevice
from tpu_tree_search_torch.ops import batched as tbatched, expand as tex
from tpu_tree_search_torch.ops import columns as tcolumns, kernels


import _torch_threads

_torch_threads.share_cores()


def _parents(jobs, machines, B, seed, deep=False):
    """Random instance and B random parents (permutation, depth, front)."""
    rng = np.random.default_rng(seed)
    p = rng.integers(1, 100, size=(machines, jobs)).astype(np.int32)
    prmu = np.stack([rng.permutation(jobs) for _ in range(B)]).astype(np.int16)
    lo = jobs // 2 if deep else 0
    depth = rng.integers(lo, jobs, size=B).astype(np.int32)
    front = ref.prefix_front_remain(p, prmu, depth)[:, :machines]
    return p, prmu.T.copy(), depth[None, :].copy(), front.T.copy()


def _both(p):
    return jbatched.make_tables(p), tbatched.make_tables(p, device="cpu")


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


SHAPES = [  # jobs, machines, B, tile
    (8, 4, 16, 16),
    (8, 4, 32, 8),      # four tiles
    (20, 5, 24, 8),     # three tiles
    (20, 20, 16, 8),
    (40, 8, 8, 4),      # two scheduled-set words
    (50, 10, 8, 8),
    (100, 5, 4, 2),     # four words, two tiles
]


@pytest.mark.parametrize("lb_kind", [0, 1, 2])
@pytest.mark.parametrize("jobs,machines,B,tile", SHAPES)
def test_expand_plain_matches_expand_xla(jobs, machines, B, tile, lb_kind):
    p, prmu_T, depth2, front_T = _parents(jobs, machines, B, jobs + tile)
    jt, tt = _both(p)
    want = jpe.expand_xla(jt, jnp.asarray(prmu_T), jnp.asarray(depth2),
                          jnp.asarray(front_T), lb_kind=lb_kind, tile=tile)
    got = tex.expand_plain(tt, _t(prmu_T), _t(depth2), _t(front_T),
                           lb_kind=lb_kind, tile=tile)
    for name, w, g in zip(("children", "aux", "bounds"), want, got):
        assert g.dtype == {"children": torch.int16}.get(name, torch.int32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("lb_kind", [0, 1, 2])
@pytest.mark.parametrize("jobs,machines,B,tile", SHAPES)
def test_expand_bounds_plain_matches_xla(jobs, machines, B, tile, lb_kind):
    p, prmu_T, depth2, front_T = _parents(jobs, machines, B, 3 * jobs + B)
    jt, tt = _both(p)
    want = jpe.expand_bounds_xla(jt, jnp.asarray(prmu_T),
                                 jnp.asarray(depth2), jnp.asarray(front_T),
                                 lb_kind=lb_kind, tile=tile)
    # the dispatcher on CPU tensors, with the pool's narrow aux dtype
    got = tex.expand_bounds(tt, _t(prmu_T), _t(depth2),
                            _t(front_T.astype(np.int16)), lb_kind=lb_kind,
                            tile=tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("jobs,machines,B,tile", SHAPES + [
    (50, 20, 16, 4),    # two scheduled-set words, four tiles
    (100, 10, 8, 2)])   # four words, four tiles
def test_expand_fronts_plain_matches_xla(jobs, machines, B, tile):
    """The dense route's fronts-only launch, plain: the child fronts of
    `expand_xla` and JAX's `sched_mask_cols`, exactly, in one column
    order."""
    p, prmu_T, depth2, front_T = _parents(jobs, machines, B, 5 * jobs + tile)
    jt, tt = _both(p)
    aux = jpe.expand_xla(jt, jnp.asarray(prmu_T), jnp.asarray(depth2),
                         jnp.asarray(front_T), lb_kind=1, tile=tile)[1]
    words = jpe.sched_mask_cols(jnp.asarray(prmu_T), jnp.asarray(depth2),
                                tile)
    fronts, sched = tex.expand_fronts_plain(tt, _t(prmu_T), _t(depth2),
                                            _t(front_T), tile)
    assert fronts.dtype == sched.dtype == torch.int32
    assert sched.shape == (jpe.sched_words(jobs), B * jobs)
    np.testing.assert_array_equal(fronts.numpy(),
                                  np.asarray(aux)[:machines])
    np.testing.assert_array_equal(sched.numpy(), np.asarray(words))


@pytest.mark.parametrize("jobs,machines,B,tile", [(10, 5, 16, 4),
                                                  (20, 10, 16, 8),
                                                  (40, 5, 8, 2)])
def test_expand_bounds_lb2_matches_jax_expand(jobs, machines, B, tile):
    """The dense route's bounds (`expand_bounds(lb_kind=2)`, which the
    port's dense step calls) equal JAX's `expand(lb_kind=2)[2]`."""
    p, prmu_T, depth2, front_T = _parents(jobs, machines, B, 7 * jobs + B,
                                          deep=True)
    jt, tt = _both(p)
    want = jpe.expand(jt, jnp.asarray(prmu_T), jnp.asarray(depth2),
                      jnp.asarray(front_T), lb_kind=2, tile=tile)[2]
    got = tex.expand_bounds(tt, _t(prmu_T), _t(depth2),
                            _t(front_T.astype(np.int16)), lb_kind=2,
                            tile=tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("jobs,B,tile", [(8, 16, 8), (20, 12, 4), (40, 8, 8),
                                         (70, 6, 2), (100, 4, 4)])
def test_sched_mask_cols_matches(jobs, B, tile):
    _, prmu_T, depth2, _ = _parents(jobs, 3, B, jobs, deep=True)
    want = jpe.sched_mask_cols(jnp.asarray(prmu_T), jnp.asarray(depth2), tile)
    got = tex.sched_mask_cols(_t(prmu_T), _t(depth2), tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _random_cols(jobs, machines, N, seed):
    rng = np.random.default_rng(seed)
    p = rng.integers(1, 100, size=(machines, jobs)).astype(np.int32)
    cf = rng.integers(0, 3000, size=(machines, N)).astype(np.int32)
    unsched = rng.random((jobs, N)) < 0.5
    W = jpe.sched_words(jobs)
    words = np.zeros((W, N), np.uint32)
    for v in range(jobs):
        words[v // 32] |= np.where(unsched[v], np.uint32(0),
                                   np.uint32(1 << (v % 32)))
    return p, cf, unsched, words.view(np.int32)


@pytest.mark.parametrize("jobs,machines", [(20, 20), (32, 6), (50, 20),
                                           (80, 5), (100, 10)])
def test_lb2_plain_matches_lb2_cols(jobs, machines):
    p, cf, _, sched = _random_cols(jobs, machines, 512, jobs * machines)
    jt, tt = _both(p)
    want = jpe.lb2_cols(jt, jnp.asarray(sched), jnp.asarray(cf))
    got = tex.lb2_bounds(tt, _t(cf), _t(sched))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("jobs,machines", [(80, 5), (100, 10)])
def test_lb2_plain_matches_bigj_interpret(jobs, machines):
    p, cf, unsched, sched = _random_cols(jobs, machines, 1024, 7 + jobs)
    jt, tt = _both(p)
    nt = jpe.lb2_bigj_tile(jobs, machines, 1024)
    want = jpe.lb2_bounds_bigj_tpu(
        jt, jnp.asarray(cf), jnp.asarray(unsched.astype(np.float32)),
        tile=nt, interpret=True)
    got = tex.lb2_plain(tt, _t(sched), _t(cf))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lb2_bounds_takes_a_column_prefix():
    p, cf, _, sched = _random_cols(50, 10, 256, 3)
    _, tt = _both(p)
    full = tex.lb2_bounds(tt, _t(cf), _t(sched))
    part = tex.lb2_bounds(tt, _t(cf)[:, :100], _t(sched)[:, :100])
    np.testing.assert_array_equal(part.numpy(), full.numpy()[:, :100])


@pytest.mark.parametrize("jobs,machines,with_sched", [(20, 5, False),
                                                      (50, 10, True)])
def test_regather_matches(jobs, machines, with_sched):
    B, TB = 16, 8
    p, prmu_T, depth2, front_T = _parents(jobs, machines, B, jobs, deep=True)
    jt, tt = _both(p)
    rng = np.random.default_rng(1)
    idx = rng.choice(B * jobs, size=40, replace=False).astype(np.int32)
    want = jdevice._regather(jt, jnp.asarray(prmu_T), jnp.asarray(depth2),
                             jnp.asarray(front_T.astype(np.int16)),
                             jnp.asarray(idx), TB, with_sched)
    got = tcolumns.regather(tt, _t(prmu_T), _t(depth2),
                            _t(front_T.astype(np.int16)),
                            torch.as_tensor(idx).long(), TB, with_sched)
    for w, g in zip(want, got):
        assert g.dtype == getattr(torch, str(np.asarray(w).dtype))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("jobs,machines,chunk", [(20, 5, 256), (20, 10, 256),
                                                 (20, 20, 65536),
                                                 (50, 20, 256), (100, 10, 64)])
def test_lb2_route_rule(jobs, machines, chunk):
    """On CUDA the port takes the route the JAX package takes on a TPU
    (its shape rule); on the CPU it takes JAX's CPU route, 'prefilter'."""
    P = machines * (machines - 1) // 2
    tb = tex.effective_tile(jobs, chunk, 1024, 2, machines=machines)
    tpu_pair_ok = (tex.kernel_shape_ok(jobs, tb, 2, machines=machines)
                   and jpe.lb2_kernel_fits(jobs, P))
    want = "dense" if tpu_pair_ok and P <= 48 else "prefilter"
    assert tdevice.lb2_route(jobs, machines, P, chunk)[0] == want
    assert tdevice.lb2_route(jobs, machines, P, chunk, on_cuda=False) == \
        jdevice.lb2_route(jobs, machines, P, chunk)
    if (jobs, machines) in ((20, 5), (20, 10)):
        assert want == "dense"
    if machines == 20:
        assert want == "prefilter"


def test_kernel_paths_never_fall_back_to_plain():
    """A kernel wrapper launches on CUDA tensors or raises; a dispatcher
    runs the plain version only for tensors on the CPU."""
    before = dict(kernels.LAUNCHES)
    p, prmu_T, depth2, front_T = _parents(8, 4, 16, 0)
    _, tt = _both(p)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.expand_bound(tt, _t(prmu_T), _t(depth2), _t(front_T), 1, 16,
                             False)
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        tex.expand_bounds(tt, _t(prmu_T).to("meta"), _t(depth2),
                          _t(front_T), lb_kind=1, tile=16)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.expand_fronts(tt, _t(prmu_T), _t(depth2), _t(front_T), 16)
    p, cf, _, sched = _random_cols(20, 5, 64, 0)
    _, tt = _both(p)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.lb2_sweep(tt, _t(cf), _t(sched))
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("outputs,match", [
    (frozenset(), "non-empty subset"),
    (frozenset(("fronts", "aux")), "non-empty subset"),
    (frozenset(("children",)), "CUDA device"),
    (frozenset(("fronts", "sched")), "CUDA device"),
    (None, "CUDA device")])
def test_expand_launch_checks_outputs_before_any_launch(outputs, match):
    """`kernels.expand_launch` checks which outputs it is asked for before
    it allocates or launches anything: on meta tensors it raises, for a
    bad set on the set, for a good one on the device; nothing launches."""
    before = dict(kernels.LAUNCHES)
    p, prmu_T, depth2, front_T = _parents(40, 5, 16, 1)
    _, tt = _both(p)
    meta = [_t(x).to("meta") for x in (prmu_T, depth2, front_T)]
    with pytest.raises(ValueError, match=match):
        kernels.expand_launch(tt, *meta, 1, 8, outputs)
    assert kernels.LAUNCHES == before


def test_expand_scratch_words():
    """The scratch of one launch: remain (M rows) and, when the words are
    an output, the prefix words (ceil(J/32) rows), B words each; shapes the
    kernel does not take raise."""
    full = frozenset(("children", "fronts", "depth", "bounds"))
    assert kernels.expand_scratch_words(20, 10, 4096, 512, 1, None) == \
        10 * 4096
    assert kernels.expand_scratch_words(20, 10, 4096, 512, 0, full) == \
        10 * 4096
    assert kernels.expand_scratch_words(
        50, 10, 65536, 256, 1, frozenset(("fronts", "sched"))) == 12 * 65536
    assert kernels.expand_scratch_words(
        100, 5, 64, 32, 1, frozenset(("sched",))) == 9 * 64
    for args in ((20, 10, 4096, 500, 1, None),      # tile does not divide B
                 (20, 33, 4096, 512, 1, None),      # M > 32
                 (20, 10, 4096, 512, 2, None),      # LB2 is the sweep's
                 (500, 20, 1 << 23, 32, 1, full)):  # B*J >= 2^31
        with pytest.raises(ValueError):
            kernels.expand_scratch_words(*args)


@pytest.mark.parametrize("jobs,machines,pairs,batch", [
    (20, 5, 10, 256), (20, 20, 190, 65536), (50, 20, 190, 4096),
    (100, 10, 45, 8192), (200, 20, 190, 1024), (500, 20, 190, 512)])
def test_tile_rules_match(jobs, machines, pairs, batch):
    """The tile rules fix the column order and the LB2 route, so they must
    give the JAX package's values."""
    for lb_kind in (0, 1, 2):
        for tile in (64, 256, 1024):
            want = jpe.effective_tile(jobs, batch, tile, lb_kind,
                                      machines=machines)
            assert tex.effective_tile(jobs, batch, tile, lb_kind,
                                      machines=machines) == want
            assert tex.kernel_shape_ok(jobs, want, lb_kind, machines) == \
                jpe.kernel_shape_ok(jobs, want, lb_kind, machines)
    assert tex.min_tile(jobs) == jpe.min_tile(jobs)
    assert tex.lb2_kernel_fits(jobs, pairs) == jpe.lb2_kernel_fits(jobs, pairs)
    for width in (batch, 3 * batch // 8, batch * jobs // 4):
        assert tex.lb2_tile(jobs, pairs, width) == \
            jpe.lb2_tile(jobs, pairs, width)
        assert tex.lb2_bigj_tile(jobs, machines, width) == \
            jpe.lb2_bigj_tile(jobs, machines, width)
        assert tex.lb2_sweep_tile(jobs, pairs, machines, width) == \
            jpe.lb2_sweep_tile(jobs, pairs, machines, width)


# ------------------------------------------------- row-major *_children

def _random_parents(jobs, batch, rng):
    prmu = np.stack([rng.permutation(jobs)
                     for _ in range(batch)]).astype(np.int16)
    return prmu, rng.integers(0, jobs, size=batch).astype(np.int32)


@pytest.mark.parametrize("lb_kind", [0, 1, 2])
@pytest.mark.parametrize("jobs,machines,seed,B", [
    (8, 4, 0, 16), (12, 6, 1, 16), (20, 5, 2, 16), (20, 10, 14, 8),
    (40, 8, 48, 8), (50, 10, 60, 8), (50, 20, 70, 8)])
def test_children_bounds_match_jax(jobs, machines, seed, B, lb_kind):
    """`children_bounds(lb)` and `bounds_from_parts` equal JAX's, with
    some parents invalid (their slots I32_MAX)."""
    rng = np.random.default_rng(seed)
    p = rng.integers(1, 100, size=(machines, jobs)).astype(np.int32)
    jt, tt = _both(p)
    prmu, depth = _random_parents(jobs, B, rng)
    valid = rng.random(B) < 0.75
    want = np.asarray(jbatched.children_bounds(lb_kind)(jt, prmu, depth,
                                                        valid))
    got = tbatched.children_bounds(lb_kind)(tt, _t(prmu), _t(depth),
                                            _t(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[~valid] == tex.I32_MAX).all()

    front, remain = tbatched.parent_tables(tt, _t(prmu), _t(depth))
    jf, jr = jbatched.parent_tables(jt, prmu, depth)
    np.testing.assert_array_equal(front.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(remain.numpy(), np.asarray(jr))
    child_front, child_p = tbatched._child_fronts(tt, _t(prmu), front)
    mask = tbatched.child_mask(_t(prmu), _t(depth), _t(valid))
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jbatched.child_mask(prmu, depth, valid)))
    via_parts = tbatched.bounds_from_parts(
        lb_kind, tt, _t(prmu), _t(depth), _t(valid), front, remain,
        child_front, child_p, mask)
    np.testing.assert_array_equal(via_parts.numpy(), want)


@pytest.mark.parametrize("lb_kind", [0, 1, 2])
def test_children_bounds_match_scalar_oracle(lb_kind):
    """ta014's children against the port's own scalar oracle; a parent at
    depth J-1 has one child, a leaf, whose LB1 is its makespan."""
    from tpu_tree_search_torch.ops import reference as tref
    from tpu_tree_search_torch.problems.pfsp import PFSPInstance

    inst = PFSPInstance.from_taillard(14)
    rng = np.random.default_rng(14)
    prmu, depth = _random_parents(inst.jobs, 8, rng)
    depth[0] = inst.jobs - 1
    tt = tbatched.make_tables(inst.p_times, device="cpu")
    got = tbatched.children_bounds(lb_kind)(tt, _t(prmu), _t(depth),
                                            _t(np.ones(8, bool))).numpy()
    lb1 = tref.make_lb1_data(inst.p_times)
    lb2 = tref.make_lb2_data(lb1)
    J = inst.jobs
    for b in range(8):
        d = int(depth[b])
        if lb_kind == 0:
            begin = tref.lb1_children_bounds(lb1, prmu[b], d - 1, J)
        for i in range(d, J):
            child = prmu[b].copy()
            child[d], child[i] = child[i], child[d]
            want = (int(begin[int(prmu[b][i])]) if lb_kind == 0 else
                    tref.lb1_bound(lb1, child, d, J) if lb_kind == 1 else
                    tref.lb2_bound(lb1, lb2, child, d, J, 2**31 - 1))
            assert got[b, i] == want, (b, i)
    if lb_kind == 1:
        leaf = prmu[0].copy()
        assert got[0, J - 1] == inst.makespan(leaf)
