"""Lossless re-homing of a search state into a larger pool.

Reproduces `grow` of `tpu_tree_search/engine/checkpoint.py` for one
device: the recovery path after an overflowing step (whose no-commit
contract left the live region and every counter as before the step).
Segmented runs and checkpoint files are later work.
"""

from __future__ import annotations

import torch

from .device import SearchState


def grow(state: SearchState, new_capacity: int) -> SearchState:
    """Re-home the pool into `new_capacity` rows and clear the overflow
    flag. Rows above the cursor are garbage by the pool invariant, so
    growth is zero-padding the row axis. The new pool tensors are new
    storage: `device.run` captures a new graph for them."""
    capacity = state.prmu.shape[-1]
    if new_capacity < capacity:
        raise ValueError(f"new_capacity {new_capacity} < current {capacity}")

    def pad_rows(x: torch.Tensor) -> torch.Tensor:
        out = x.new_zeros(x.shape[:-1] + (new_capacity,))
        out[..., :capacity] = x
        return out

    return state._replace(prmu=pad_rows(state.prmu),
                          depth=pad_rows(state.depth),
                          aux=pad_rows(state.aux),
                          overflow=torch.zeros_like(state.overflow))
