"""Water-filling load balancing across workers.

Reproduces `tpu_tree_search/parallel/balance.py`: `waterfill_counts`, the
host-side split that `engine/checkpoint.reshard_state` stripes rows by,
and `exchange_plan`, the steal-half flow matrix every balance round of
`engine/distributed.py` computes from the workers' pool sizes. The plan is
int32 torch operations on a device tensor of sizes, so a round reads
nothing back and a CUDA graph can hold it.
"""

from __future__ import annotations

import numpy as np
import torch


def waterfill_counts(total: int, m: int) -> np.ndarray:
    """(m,) per-worker pool sizes for an m-way water-filled split of
    `total` nodes: max-min difference <= 1, lower worker ids carry the
    remainder (the counts a round-robin stripe `d::m` produces)."""
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    if total < 0:
        raise ValueError(f"total must be >= 0, got {total}")
    return (total // m
            + (np.arange(m) < total % m).astype(np.int64))


def exchange_plan(sizes: torch.Tensor, cap: int,
                  min_transfer: int) -> torch.Tensor:
    """(D, D) int32 flow matrix: plan[d, e] nodes move d -> e this round.

    Workers above the mean donate half their surplus when it reaches
    `min_transfer` (steal-half), workers below the mean fill their deficit.
    Donor surpluses and receiver deficits lie as consecutive intervals on
    one flow axis, and plan[d, e] is the overlap of donor d's and receiver
    e's intervals, so one donor can feed many receivers in one round. Each
    pair's flow is capped at `cap`, the width of a transfer block."""
    D = sizes.shape[0]
    sizes = sizes.to(torch.int32)
    mean = torch.div(sizes.sum(dtype=torch.int32), D, rounding_mode="floor")
    gap = sizes - mean
    surplus = torch.where(gap >= min_transfer,
                          torch.div(gap, 2, rounding_mode="floor"), 0)
    deficit = (-gap).clamp(min=0)
    d_lo = (torch.cumsum(surplus, 0, dtype=torch.int32) - surplus)[:, None]
    d_hi = d_lo + surplus[:, None]
    r_lo = (torch.cumsum(deficit, 0, dtype=torch.int32) - deficit)[None, :]
    r_hi = r_lo + deficit[None, :]
    overlap = torch.minimum(d_hi, r_hi) - torch.maximum(d_lo, r_lo)
    return overlap.clamp(0, cap).to(torch.int32)
