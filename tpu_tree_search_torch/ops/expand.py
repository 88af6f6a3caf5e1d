"""Expand/bound of a popped chunk and the Johnson LB2 pair sweep.

Reproduces the rules and plain paths of
`tpu_tree_search/ops/pallas_expand.py`:

- the tile rules that fix the child column order `c = (g*J + i)*TB + b`
  (`effective_tile`, `min_tile`, `kernel_shape_ok`, `MAX_TILE_LANES`,
  `EXPAND_TILE_UNITS`, `MIN_PALLAS_TILE`) and the LB2 rules
  (`lb2_kernel_fits`, `lb2_tile`, `lb2_bigj_tile`, `lb2_sweep_tile`);
  the port keeps them because the column order and the LB2 route are part
  of the per-step parity contract, although Hopper has no lane rule;
- `sched_words`, `sched_mask_cols`, `_to_cols`;
- the plain versions `expand_plain` (= `expand_xla`),
  `expand_bounds_plain` (= `expand_bounds_xla`), `expand_fronts_plain`
  (the child fronts and scheduled-set words that the dense LB2 route
  reads) and `lb2_plain` (= `lb2_cols`);
- the dispatchers `expand`, `expand_bounds` and `lb2_bounds` (whose
  optional device count of live columns, `mask_live`, lets a sweep over
  a fixed frame skip its dead columns without a host read).

A dispatcher runs the plain version only for tensors on the CPU. For
tensors on a CUDA device it launches the Hopper kernel of `ops/kernels.py`
(`expand_bound.cu` for the expand/bound kernels, `lb2_sweep.cu` for both
pair-sweep kernels) and raises on anything it cannot launch.

Layout: feature-major, the batch on the last axis. prmu_T (J, B) int16,
depth2 (1, B) int32, front_T (M, B) int32 (or the pool's int16 aux dtype,
widened at entry).
"""

from __future__ import annotations

import torch

from . import batched, kernels
from .batched import BoundTables

I32_MAX = 2**31 - 1
MIN_PALLAS_TILE = 256
MAX_TILE_LANES = 1 << 15
EXPAND_TILE_UNITS = 20 * 20 * 1024

LB2_ONEHOT_VMEM = 4 << 20
LB2_PB = 64
LB2_TILE = 4096
_LB2_SCOPED_BASE = 2048
_LB2_SCOPED_BUDGET = 15e6
LB2_BIGJ_MIN_TILE = 512


def min_tile(jobs: int) -> int:
    """Smallest tile of the JAX expand kernels' family (`min_tile`)."""
    if jobs >= 128:
        return 64
    return 128 if jobs >= 64 else 256


def effective_tile(jobs: int, batch: int, tile: int = 1024,
                   lb_kind: int = 1, machines: int | None = None) -> int:
    """The tile that fixes the output column order (`effective_tile`):
    shrink the requested tile while the lane or unit budget is exceeded,
    then fall back to one batch-wide tile if the batch is not a
    multiple."""
    cap = MAX_TILE_LANES // 2 if lb_kind == 2 else MAX_TILE_LANES
    floor = min_tile(jobs)

    def too_big(t):
        if jobs * t > cap:
            return True
        return machines is not None and jobs * machines * t > EXPAND_TILE_UNITS

    while tile >= floor and too_big(tile):
        tile //= 2
    return tile if batch % tile == 0 else batch


def kernel_shape_ok(jobs: int, eff_tile: int, lb_kind: int,
                    machines: int | None = None) -> bool:
    """The shape half of the JAX expand kernels' eligibility rule
    (`kernel_shape_ok`); `lb2_route` asks it where the JAX package asks
    it on a TPU."""
    lane_cap = MAX_TILE_LANES // 2 if lb_kind == 2 else MAX_TILE_LANES
    return (eff_tile >= min_tile(jobs)
            and (eff_tile % 128 == 0
                 or (jobs >= 128 and eff_tile == 64
                     and (jobs * eff_tile) % 128 == 0))
            and jobs * eff_tile <= lane_cap
            and (machines is None
                 or jobs * machines * eff_tile <= EXPAND_TILE_UNITS))


def sched_words(jobs: int) -> int:
    """Rows of the scheduled-set bitmask: one int32 word per 32 jobs."""
    return (jobs + 31) // 32


def lb2_tile(jobs: int, pairs: int, width: int) -> int:
    """The JAX register pair kernel's column tile at `width` (`lb2_tile`);
    0 when none exists."""
    rows = min(LB2_PB, pairs)
    nt = min(LB2_TILE, width & -width)
    while nt >= MIN_PALLAS_TILE and (
            (rows * jobs + _LB2_SCOPED_BASE) * nt > _LB2_SCOPED_BUDGET):
        nt //= 2
    return nt if nt >= MIN_PALLAS_TILE else 0


def lb2_kernel_fits(jobs: int, pairs: int) -> bool:
    """Whether the JAX register pair kernel serves this class
    (`lb2_kernel_fits`); part of the LB2 route rule."""
    return jobs <= 64 and jobs * pairs * jobs * 2 <= LB2_ONEHOT_VMEM


def lb2_bigj_tile(jobs: int, machines: int, width: int) -> int:
    """The JAX streaming big-J pair kernel's column tile (`lb2_bigj_tile`);
    0 when none exists."""
    nt = min(LB2_TILE, width & -width)
    per_col = 2 * jobs + 4 * machines + 8 * LB2_PB + 16
    while nt >= LB2_BIGJ_MIN_TILE and nt * per_col > 12e6:
        nt //= 2
    return nt if nt >= LB2_BIGJ_MIN_TILE else 0


def lb2_sweep_tile(jobs: int, pairs: int, machines: int,
                   width: int) -> int:
    """The column tile the JAX pair sweep at `width` runs with on a TPU
    (`lb2_sweep_tile`). The Hopper sweep takes any width; this is kept
    for the route rule and for readers comparing the two packages."""
    if lb2_kernel_fits(jobs, pairs):
        return lb2_tile(jobs, pairs, width)
    return lb2_bigj_tile(jobs, machines, width)


def _to_cols(x: torch.Tensor, G: int, TB: int, J: int) -> torch.Tensor:
    """Reorder (B, J, X) -> (X, tile-slot-major columns): within each tile
    of TB parents, column c = i*TB + b."""
    x = x.reshape(G, TB, J, x.shape[-1]).permute(3, 0, 2, 1)
    return x.reshape(x.shape[0], G * J * TB)


def _as_i32(bits: torch.Tensor) -> torch.Tensor:
    """int64 words holding 32-bit patterns -> int32 with the same bits
    (bit 31 becomes the sign, as the JAX package's int32 sums wrap)."""
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits) \
        .to(torch.int32)


def sched_bits(ppi: torch.Tensor, in_prefix: torch.Tensor,
               appended: torch.Tensor | None, W: int) -> torch.Tensor:
    """(W, t) scheduled-set words as int64 holding 32-bit patterns: the
    jobs of `ppi` (J, t) where `in_prefix`, plus the `appended` (1, t) job
    when given; bit (v % 32) of word (v // 32) stands for job v. Working
    in int64 keeps bit 31 free of the sign (`_as_i32` narrows)."""
    ppl = ppi.long()
    words = []
    for w in range(W):
        inw = in_prefix & (ppl >= 32 * w) & (ppl < 32 * (w + 1))
        word = torch.where(inw, 1 << (ppl - 32 * w).clamp(0, 31), 0) \
            .sum(dim=0, keepdim=True)
        if appended is not None:
            apl = appended.long()
            ainw = (apl >= 32 * w) & (apl < 32 * (w + 1))
            word = word | torch.where(ainw, 1 << (apl - 32 * w).clamp(0, 31),
                                      0)
        words.append(word)
    return torch.cat(words, dim=0)


def sched_mask_cols(prmu_T: torch.Tensor, depth2: torch.Tensor,
                    tile: int) -> torch.Tensor:
    """(W, N) int32 per-child scheduled-set bitmask in the expand column
    order (c = (g*J + i)*TB + b), W = ceil(J/32): the parent's prefix bits
    plus the appended job's bit."""
    J, B = prmu_T.shape
    G = B // tile
    W = sched_words(J)
    rows = torch.arange(J, device=prmu_T.device)[:, None]
    prefix = sched_bits(prmu_T, rows < depth2, None, W)        # (W, B)
    prefix = prefix.reshape(W, G, 1, tile).expand(W, G, J, tile) \
        .reshape(W, B * J)
    appended = prmu_T.reshape(J, G, tile).permute(1, 0, 2).reshape(1, B * J)
    none = torch.zeros_like(appended, dtype=torch.bool)
    return _as_i32(prefix | sched_bits(appended, none, appended, W))


def _parts(tables: BoundTables, prmu_T, depth2, front_T):
    """Row-major intermediates of the plain expand paths: parent views,
    per-machine remain (unscheduled work, from the permutation) and the
    child front chains."""
    J, B = prmu_T.shape
    prmu = prmu_T.T.long()                                   # (B, J)
    depth = depth2.reshape(B)
    front = front_T.T.to(torch.int32)                        # (B, M)
    unsched = torch.arange(J, device=prmu.device)[None, :] >= depth[:, None]
    remain = (tables.p_t[prmu] * unsched[..., None]).sum(
        dim=1, dtype=torch.int32)                            # (B, M)
    child_front, child_p = batched._child_fronts(tables, prmu, front)
    return prmu, depth, front, remain, child_front, child_p


def _bounds_rows(tables: BoundTables, lb_kind: int, front, remain,
                 child_front, child_p):
    """(B, J) LB1/LB1_d bounds from the row-major parts."""
    if lb_kind == 1:
        return batched.lb1_from_parts(
            tables, child_front, remain[:, None, :] - child_p)
    return batched.lb1d_from_parts(tables, front, remain, child_p)


def make_children(prmu: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Dense (B, J, J) child permutations: slot i swaps positions
    depth <-> i (the prefix-swap branching, PFSP_lib.c:13-16)."""
    B, J = prmu.shape
    ar = torch.arange(J, device=prmu.device)
    pos = ar[None, None, :]
    slot = ar[None, :, None]
    d = depth.long()[:, None, None]
    at_depth = prmu.gather(1, depth.long()[:, None].clamp(0, J - 1))
    child = torch.where(pos == d, prmu[:, :, None],
                        torch.where(pos == slot, at_depth[:, :, None],
                                    prmu[:, None, :]))
    return child.to(torch.int16)


def lb2_plain(tables: BoundTables, sched_mask: torch.Tensor,
              child_front_cols: torch.Tensor) -> torch.Tensor:
    """Plain LB2 (= `lb2_cols`): the Johnson all-pairs sweep on (P, N).

    sched_mask (W, N) int32, bit (v % 32) of word (v // 32) set iff job v
    is scheduled in the child; child_front_cols (M, N). Returns (1, N)
    int32 bounds."""
    t = tables
    J = t.js.shape[1]
    cf = child_front_cols.to(torch.int32)
    tmp0 = cf[t.ma0.long()]                                  # (P, N)
    tmp1 = cf[t.ma1.long()]
    word_of = (t.js // 32).long()
    bit_of = (t.js % 32)
    for j in range(J):
        word = sched_mask[word_of[:, j]]                     # (P, N)
        active = ((word >> bit_of[:, j:j + 1]) & 1) == 0
        new0 = tmp0 + t.ptm0_js[:, j:j + 1]
        new1 = torch.maximum(tmp1, new0 + t.lag_js[:, j:j + 1]) \
            + t.ptm1_js[:, j:j + 1]
        tmp0 = torch.where(active, new0, tmp0)
        tmp1 = torch.where(active, new1, tmp1)
    back0 = t.min_tails[t.ma0.long()][:, None]
    back1 = t.min_tails[t.ma1.long()][:, None]
    per_pair = torch.maximum(tmp1 + back1, tmp0 + back0)
    return per_pair.amax(dim=0, keepdim=True)


def _grid(B: int, tile: int | None) -> tuple[int, int]:
    """(TB, G): the tile (default: one batch-wide tile) and tile count."""
    TB = B if tile is None else tile
    if TB <= 0 or B % TB != 0:
        raise ValueError(f"tile {TB} does not divide the batch {B}")
    return TB, B // TB


def expand_plain(tables: BoundTables, prmu_T, depth2, front_T,
                 lb_kind: int = 1, tile: int | None = None):
    """Plain expand (= `expand_xla`): children_T (J, N) int16, aux_T
    (M+1, N) int32 = [child front | depth+1], bounds (1, N) int32, in the
    column order of `tile` (default: one batch-wide tile)."""
    J, B = prmu_T.shape
    TB, G = _grid(B, tile)
    prmu, depth, front, remain, child_front, child_p = _parts(
        tables, prmu_T, depth2, front_T)
    children = make_children(prmu, depth)                    # (B, J, J)
    child_aux = torch.cat(
        [child_front, (depth + 1).to(torch.int32)[:, None, None]
         .expand(B, J, 1)], dim=-1)                          # (B, J, M+1)
    children_T = _to_cols(children, G, TB, J)
    aux_T = _to_cols(child_aux, G, TB, J)
    if lb_kind == 2:
        M = tables.p.shape[0]
        bounds = lb2_plain(tables, sched_mask_cols(prmu_T, depth2, TB),
                           aux_T[:M])
    else:
        bounds = _to_cols(_bounds_rows(tables, lb_kind, front, remain,
                                       child_front, child_p)[..., None],
                          G, TB, J)
    return children_T, aux_T, bounds


def expand_fronts_plain(tables: BoundTables, prmu_T, depth2, front_T,
                        tile: int | None = None):
    """Plain version of the expand kernel's fronts-only launch (the dense
    LB2 route's): the child fronts (M, N) int32 (= `expand_plain(...)[1]
    [:M]`) and the child's scheduled-set words (W, N) int32
    (= `sched_mask_cols`), in the column order of `tile`."""
    J, B = prmu_T.shape
    TB, G = _grid(B, tile)
    child_front = batched._child_fronts(tables, prmu_T.T.long(),
                                        front_T.T.to(torch.int32))[0]
    return (_to_cols(child_front, G, TB, J),
            sched_mask_cols(prmu_T, depth2, TB))


def expand_bounds_plain(tables: BoundTables, prmu_T, depth2, front_T,
                        lb_kind: int = 1, tile: int | None = None):
    """Plain bounds-only expand (= `expand_bounds_xla`): (1, N) int32,
    the same column order and math as `expand_plain`."""
    J, B = prmu_T.shape
    TB, G = _grid(B, tile)
    if lb_kind == 2:
        cf, sched = expand_fronts_plain(tables, prmu_T, depth2, front_T, TB)
        return lb2_plain(tables, sched, cf)
    prmu, depth, front, remain, child_front, child_p = _parts(
        tables, prmu_T, depth2, front_T)
    return _to_cols(_bounds_rows(tables, lb_kind, front, remain,
                                 child_front, child_p)[..., None], G, TB, J)


def _on_cpu(*xs: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device; raises on any other placement."""
    devs = {x.device for x in xs}
    if devs == {torch.device("cpu")}:
        return True
    if len(devs) == 1 and next(iter(devs)).type == "cuda":
        return False
    raise ValueError(f"tensors must all lie on the CPU or on one CUDA "
                     f"device, got {sorted(map(str, devs))}")


def _tile_for(J: int, B: int, tile: int, lb_kind: int, M: int) -> int:
    # a tile that divides the batch is trusted as-is (step() derives it
    # through effective_tile and builds its masks in that order)
    return (tile if B % tile == 0
            else effective_tile(J, B, tile, lb_kind, machines=M))


def expand(tables: BoundTables, prmu_T, depth2, front_T,
           lb_kind: int = 1, tile: int = 1024):
    """Children, [child front | depth+1] and bounds of every child slot.
    CPU: `expand_plain`. CUDA: the expand kernel in emit mode (for LB2
    with LB1 as its bound, then the pair-sweep kernel over its fronts)."""
    front_T = front_T.to(torch.int32)
    J, B = prmu_T.shape
    M = front_T.shape[0]
    TB = _tile_for(J, B, tile, lb_kind, M)
    if _on_cpu(prmu_T, depth2, front_T, tables.p):
        return expand_plain(tables, prmu_T, depth2, front_T, lb_kind, TB)
    if lb_kind == 2:
        children, aux, _ = kernels.expand_bound(
            tables, prmu_T, depth2, front_T, 1, TB, emit=True)
        bounds = lb2_bounds(tables, aux[:M],
                            sched_mask_cols(prmu_T, depth2, TB))
        return children, aux, bounds
    return kernels.expand_bound(tables, prmu_T, depth2, front_T, lb_kind,
                                TB, emit=True)


def expand_bounds(tables: BoundTables, prmu_T, depth2, front_T,
                  lb_kind: int = 1, tile: int = 1024):
    """Bounds of every child slot, (1, N) int32, in `expand`'s column
    order. CPU: `expand_bounds_plain`. CUDA: the bounds-only expand
    kernel; for LB2 (the dense route) the expand kernel's fronts-only
    launch, then the pair-sweep kernel over its fronts and words. Slots
    below the parent's depth are never real children; the bounds-only
    kernel writes I32_MAX there."""
    front_T = front_T.to(torch.int32)
    J, B = prmu_T.shape
    TB = _tile_for(J, B, tile, lb_kind, front_T.shape[0])
    if _on_cpu(prmu_T, depth2, front_T, tables.p):
        return expand_bounds_plain(tables, prmu_T, depth2, front_T,
                                   lb_kind, TB)
    if lb_kind == 2:
        fronts, sched = kernels.expand_fronts(tables, prmu_T, depth2,
                                              front_T, TB)
        return lb2_bounds(tables, fronts, sched)
    return kernels.expand_bound(tables, prmu_T, depth2, front_T, lb_kind,
                                TB, emit=False)[2]


def mask_live(bounds: torch.Tensor, live) -> torch.Tensor:
    """(1, n) bounds with every column at or past `live` (a count, int or
    scalar tensor; None: none) set to I32_MAX."""
    if live is None:
        return bounds
    cols = torch.arange(bounds.shape[-1], device=bounds.device)
    return torch.where(cols < live, bounds, I32_MAX)


def lb2_bounds(tables: BoundTables, child_front_cols: torch.Tensor,
               sched_mask: torch.Tensor, live=None) -> torch.Tensor:
    """LB2 over child columns: child_front_cols (M, N) (int32, or the
    pool's int16), sched_mask (W, N) int32 -> (1, N) int32. Either may be
    a column prefix of a wider frame. `live`, an int32 scalar tensor on
    the tensors' device (None: every column), counts the live leading
    columns: the rest read I32_MAX and cost the kernel no sweep, so a
    frame wider than its survivors needs no host-side count. CPU:
    `lb2_plain`, then `mask_live`. CUDA: the pair-sweep kernel, for any
    job count."""
    if _on_cpu(child_front_cols, sched_mask, tables.js):
        return mask_live(lb2_plain(tables, sched_mask, child_front_cols),
                         live)
    return kernels.lb2_sweep(tables, child_front_cols, sched_mask, live)
