"""Water-filling split of a node count across workers.

Reproduces `waterfill_counts` of `tpu_tree_search/parallel/balance.py`,
the host-side half of its water-filling machinery that
`engine/checkpoint.reshard_state` stripes rows by. The device-side
exchange plan belongs to the multi-GPU slice.
"""

from __future__ import annotations

import numpy as np


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
