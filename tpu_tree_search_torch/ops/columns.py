"""Child columns of a popped chunk: their order, masks, the stable
partition, the regather of the children at chosen columns, and the
gap-binned bound histogram.

The engine's routes (`engine/device.py`) and the fused kernel's plain
version (`ops/fused.py`) share these, so both number, select and rebuild
children the same way; none of them reads a value back to the host.
Columns run in the expand order `c = (g*J + i)*TB + b`: tiles, then
slots, then parents. The JAX package keeps the first four in
`tpu_tree_search/engine/device.py` (`_col_major`, `_child_masks`,
`_partition`, `_regather`) and the histogram in its
`engine/telemetry.py` (`bound_hist`).
"""

from __future__ import annotations

import torch

from . import expand as ex
from .batched import BoundTables

BOUND_BINS = 8         # relative-gap bins of the bound histogram


def col_major(x: torch.Tensor, G: int, J: int, TB: int) -> torch.Tensor:
    """(1, B) per-parent row -> (1, N) per-child-slot row in the expand
    column order."""
    return x.reshape(G, 1, TB).expand(G, J, TB).reshape(1, -1)


def child_masks(p_depth, valid, G: int, J: int, TB: int):
    """(depth_c, mask): each child column's parent depth and whether it is
    a real child (slot >= depth of a valid parent), in column order."""
    depth_c = col_major(p_depth, G, J, TB)
    valid_c = col_major(valid[None, :], G, J, TB)
    slot_c = torch.arange(J, device=p_depth.device)[None, :, None] \
        .expand(G, J, TB).reshape(1, G * J * TB)
    return depth_c, (slot_c >= depth_c) & valid_c


def partition(push: torch.Tensor) -> torch.Tensor:
    """Stable-partition permutation (int64): indices of the True columns
    first, in order, then the False ones (the same permutation as the JAX
    packed-key sort). One exclusive scan ranks the True columns; a False
    column's rank among the False ones is its index less the True columns
    before it; each index is scattered to its rank. O(N), and it reads
    nothing back, so a CUDA graph can hold it."""
    n = push.shape[0]
    idx = torch.arange(n, device=push.device)
    p = push.long()
    true_before = torch.cumsum(p, 0) - p
    dest = torch.where(push, true_before, p.sum() + idx - true_before)
    return torch.empty_like(idx).scatter_(0, dest, idx)


def regather(tables: BoundTables, p_prmu, p_depth2, p_aux, idx, TB: int,
             with_sched: bool = False):
    """Rebuild the children at child columns `idx` (t,) from the popped
    parents: (child (J, t) int16, caux (M+1, t) = [child front | depth+1]
    in the pool's aux dtype[, sched (W, t) int32 scheduled-set words])."""
    J, B = p_prmu.shape
    M = p_aux.shape[0]
    adt = p_aux.dtype
    t = idx.shape[0]
    JTB = J * TB
    g = idx // JTB
    r = idx - g * JTB
    slot = r // TB
    b = r - slot * TB
    pcol = g * TB + b
    pp = p_prmu[:, pcol]                                      # (J, t)
    pf = p_aux[:, pcol].to(torch.int32)                       # (M, t)
    pd = p_depth2.reshape(-1)[pcol][None, :].to(torch.int32)  # (1, t)

    ppi = pp.long()
    rows = torch.arange(J, device=pp.device)[:, None]
    ar = torch.arange(t, device=pp.device)
    appended = ppi[slot, ar][None, :]                         # prmu[slot]
    at_depth = ppi[pd.reshape(-1).clamp(0, J - 1).long(), ar][None, :]
    child = torch.where(rows == pd, appended,
                        torch.where(rows == slot[None, :], at_depth, ppi)) \
        .to(torch.int16)

    cp = tables.p[:, appended.reshape(-1)]                    # (M, t)
    cf = pf[0:1] + cp[0:1]
    cf_rows = [cf]
    for k in range(1, M):
        cf = torch.maximum(cf, pf[k:k + 1]) + cp[k:k + 1]
        cf_rows.append(cf)
    caux = torch.cat(cf_rows + [pd + 1], dim=0).to(adt)       # (M+1, t)
    if not with_sched:
        return child, caux
    sched = ex._as_i32(ex.sched_bits(ppi, rows < pd, appended,
                                     ex.sched_words(J)))
    return child, caux, sched


def index_counts(idx: torch.Tensor, weight: torch.Tensor,
                 n: int) -> torch.Tensor:
    """(n,) int64 sums of `weight` by index (integer adds: exact in any
    order)."""
    out = torch.zeros(n, dtype=torch.int64, device=idx.device)
    return out.index_add_(0, idx.reshape(-1), weight.reshape(-1).long())


def bound_hist(bounds: torch.Tensor, mask: torch.Tensor, best,
               bins: int = BOUND_BINS) -> torch.Tensor:
    """(bins,) int64 histogram of the masked bounds by gap bin
    min(|bound - ref| * bins // ref, bins - 1), in int64 with
    ref = max(best, 1); `best` is an int or a device scalar."""
    b = bounds.reshape(-1).long()
    ref = (best.long().clamp(min=1) if isinstance(best, torch.Tensor)
           else max(int(best), 1))
    gap_bin = torch.clamp((b - ref).abs() * bins // ref, max=bins - 1)
    return index_counts(gap_bin, mask.reshape(-1), bins)
