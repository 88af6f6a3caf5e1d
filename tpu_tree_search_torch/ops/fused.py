"""Fused bound + prune + compact of one popped chunk.

Reproduces `tpu_tree_search/ops/pallas_fused.py`: `store_sub`, the mode
names, `resolve_mode`, `fused_ok`, the plain version `fused_expand_plain`
and the dispatcher `fused_expand` (the same signature and return tuple as
the JAX `fused_expand`). One call expands the chunk, bounds every child
with LB1, prunes against `bound_cap`, and returns only the survivors,
compacted in the global child column order `c = (g*J + i)*TB + b` that
`columns.partition` gives; the dense child grid, its bound row and the
prune mask never reach device memory. The engine's fused route
(`device._fused_step`) drives it.

Modes (the JAX names):

- ``hw``: the Hopper kernel (`csrc/fused_expand.cu` via
  `kernels.fused_expand`), for CUDA tensors only and behind the expand
  kernel's shape rule (`expand.kernel_shape_ok`), as the JAX gate admits
  TPU shapes.
- ``off``: the unfused routes run.
- ``interpret``: the plain version, for CPU tensors only, at any shape.

The route is chosen from what the run observes, not from the
environment: `resolve_mode(None)` gives ``hw`` for a run on CUDA, where
the fused route gave the same state as the unfused one in less device
time on every admitted shape measured (PERF.md), and ``off`` on the CPU,
as the JAX package's default. An explicit mode passes through, so the
parity tests and `chip_smoke.py`'s unfused phases name ``off`` or
``interpret``. A CUDA tensor with ``interpret`` or a CPU tensor with
``hw`` raises; no mode quietly takes another path.

The kernel's survivor frame is exactly `cap_width` columns wide: the JAX
kernel's store slack (`store_sub`) and the narrowing copy it forces are
TPU artefacts. `store_sub` stays for its geometry test.
"""

from __future__ import annotations

import torch

from . import columns as cols, expand as ex, kernels
from .batched import BoundTables

MODES = ("off", "hw", "interpret")


def store_sub(n_cols: int) -> int:
    """The JAX kernel's cursor-store sub-block width for a tile of
    `n_cols` children (its frame slack); the port's frame has none."""
    if n_cols <= 128:
        return n_cols
    eighth = (n_cols + 7) // 8
    return max(128, (eighth + 127) // 128 * 128)


def resolve_mode(mode: str | None = None, on_cuda: bool = False) -> str:
    """The fused mode of a run, resolved on the host: a mode string passes
    through; None gives "hw" for a run on CUDA and "off" on the CPU."""
    if mode is None:
        return "hw" if on_cuda else "off"
    if mode not in MODES:
        raise ValueError(f"fused mode {mode!r} is not one of {MODES}")
    return mode


def fused_ok(mode: str, jobs: int, eff_tile: int, lb_kind: int,
             machines: int | None = None,
             device: torch.device = torch.device("cpu")) -> bool:
    """The fused route's admission rule (`device.step`'s gate): "off" and
    bounds other than LB1/LB2 admit nothing; "hw" admits the shapes the
    expand kernel takes; "interpret" admits any shape. A mode that does
    not belong to `device` raises."""
    if mode not in MODES:
        raise ValueError(f"fused mode {mode!r} is not one of {MODES}")
    on_cuda = torch.device(device).type == "cuda"
    if mode == "hw" and not on_cuda:
        raise ValueError("fused mode 'hw' runs the Hopper kernel and needs "
                         f"CUDA tensors, got {device}")
    if mode == "interpret" and on_cuda:
        raise ValueError("fused mode 'interpret' runs the plain version on "
                         f"CPU tensors, got {device}")
    if mode == "off" or lb_kind not in (1, 2):
        return False
    if mode == "hw":
        return ex.kernel_shape_ok(jobs, eff_tile, lb_kind, machines)
    return True


def fused_expand_plain(tables: BoundTables, prmu_T, depth2, front_T,
                       n_valid, bound_cap, lb_kind: int = 1,
                       tile: int = 1024, cap_width: int = 0,
                       with_sched: bool = False, tele_bins: int = 0,
                       with_bounds: bool = True, aux_i16: bool = False):
    """Plain version of the fused kernel: the LB1 bound row
    (`expand_bounds_plain`), the child masks, the stable partition, the
    regather of the first `cap_width` columns, and the histogram of the
    pruned bounds. Same arguments and return tuple as `fused_expand`."""
    J, B = prmu_T.shape
    TB, G = ex._grid(B, tile)
    lb = ex.expand_bounds_plain(tables, prmu_T, depth2, front_T, 1,
                                TB).reshape(-1)
    valid = torch.arange(B, device=prmu_T.device) < n_valid
    depth_c, mask = cols.child_masks(depth2, valid, G, J, TB)
    nonleaf = (mask & ((depth_c + 1) != J)).reshape(-1)
    push = nonleaf & (lb < bound_cap)
    perm = cols.partition(push)[:cap_width]
    out = cols.regather(tables, prmu_T, depth2, front_T.to(torch.int32),
                        perm, TB, with_sched)
    children, caux = out[0], out[1].to(torch.int16 if aux_i16
                                       else torch.int32)
    bounds = lb[perm][None, :] if with_bounds else None
    sched = out[2] if with_sched else None
    hist = (cols.bound_hist(lb, nonleaf & ~push, bound_cap, tele_bins)
            if tele_bins else None)
    return (children, caux, bounds, sched, push.sum().to(torch.int32),
            hist)


def fused_expand(tables: BoundTables, prmu_T, depth2, front_T, n_valid,
                 bound_cap, lb_kind: int = 1, tile: int = 1024,
                 cap_width: int = 0, with_sched: bool = False,
                 tele_bins: int = 0, with_bounds: bool = True,
                 aux_i16: bool = False):
    """Fused expand + LB1 + prune + compact over one chunk. prmu_T (J, B)
    int16, depth2 (1, B) int32, front_T (M, B) int32, `n_valid` the popped
    count and `bound_cap` the pruning incumbent (each an int or an int32
    scalar tensor on the tensors' device; the kernel reads both from
    device memory, so the engine passes tensors and reads nothing back).
    Returns

        (children (J, W) int16,
         caux (M+1, W) int32 = [child front | depth+1], int16 under
             `aux_i16`,
         bounds (1, W) int32 | None (`with_bounds`),
         sched (SW, W) int32 | None (`with_sched`),
         n_surv () int32,
         hist (tele_bins,) int64 | None)

    with W = `cap_width`, 1 <= W <= J*B. Columns [0, min(n_surv, W)) are
    the survivors (lb < bound_cap, not leaves, of the first `n_valid`
    parents) in column order; the rest are never read. `n_surv` stays exact when it
    exceeds W (the caller's spill signal). `hist` counts the pruned
    non-leaf children by `columns.bound_hist`'s gap bins against
    `bound_cap`. CPU tensors: `fused_expand_plain`; CUDA tensors: the
    Hopper kernel. `lb_kind` must be 1 (the LB2 route uses this as its LB1
    prefilter)."""
    if lb_kind != 1:
        raise ValueError(f"the fused kernel bounds with LB1, not {lb_kind}")
    if not 1 <= cap_width <= prmu_T.numel():
        raise ValueError(f"cap_width {cap_width} is not in [1, J*B = "
                         f"{prmu_T.numel()}]")
    front_T = front_T.to(torch.int32)
    if ex._on_cpu(prmu_T, depth2, front_T, tables.p):
        return fused_expand_plain(tables, prmu_T, depth2, front_T, n_valid,
                                  bound_cap, lb_kind, tile, cap_width,
                                  with_sched, tele_bins, with_bounds,
                                  aux_i16)
    return kernels.fused_expand(tables, prmu_T, depth2, front_T, n_valid,
                                bound_cap, tile, cap_width, with_sched,
                                tele_bins, with_bounds, aux_i16)
