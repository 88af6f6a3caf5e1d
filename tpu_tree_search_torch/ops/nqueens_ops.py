"""Batched N-Queens safety test of a popped block.

Reproduces `tpu_tree_search/ops/nqueens_ops.py`: the dense (B, N) child
grid of a popped block is tested with one broadcast comparison over the
placed prefix, the work of the reference's safety kernel, one thread per
(parent, candidate) pair (nqueens_gpu_cuda.cu:143-171). Torch operations,
so a CUDA graph of the step holds them; nothing is read back.

`g` repeats the test to scale the work, as the reference's `-g` does
(nqueens_c.c:80-96): the (B, N, N) comparison runs `g` times, each one
computed, and the result does not depend on `g`.
"""

from __future__ import annotations

import torch


def safe_children(board: torch.Tensor, depth: torch.Tensor,
                  valid: torch.Tensor, g: int = 1) -> torch.Tensor:
    """(B, N) mask: slot j is a real, diagonal-safe child.

    board (B, N) integer permutations, depth (B,) integer, valid (B,)
    bool. Child j places row `board[b, j]` in column `depth`; it conflicts
    with the queen in column i < depth iff their rows differ by exactly
    depth - i. Rows cannot conflict: boards are permutations."""
    depth = depth.to(torch.int32)
    B, N = board.shape
    b32 = board.to(torch.int32)
    cols = torch.arange(N, dtype=torch.int32, device=board.device)
    placed = cols[None, :] < depth[:, None]              # (B, i): i placed
    dist = depth[:, None] - cols[None, :]                # (B, i) = depth - i
    safe = torch.ones((B, N), dtype=torch.bool, device=board.device)
    for _ in range(max(int(g), 1)):
        diff = b32[:, :, None] - b32[:, None, :]         # (B, i, j)
        conflict = (diff.abs() == dist[:, :, None]) & placed[:, :, None]
        safe = safe & ~conflict.any(dim=1)               # (B, j)
    real = (cols[None, :] >= depth[:, None]) & valid[:, None]
    return safe & real
