"""N-Queens as a plugin of the generic engine (permutation backtracking).

Reproduces `tpu_tree_search/problems/nqueens.py`: `SOLUTION_COUNTS`,
`root_node`, `is_safe`, `table`, `NQueensProblem`, `search` and
`search_distributed`. A node is
a permutation `board` of column -> row plus a `depth`: queens
`0..depth-1` are placed (reference: NQueens_node.h:11-17). Its children
swap `board[depth] <-> board[j]` for each `j in depth..N-1` whose row is
diagonal-safe against the placed prefix (nqueens_c.c:80-117); rows cannot
conflict by construction. A node at depth N is a solution.

`g` repeats the safety test to scale the work (nqueens_c.c:80-96); it
does not change the result. Solution counts (OEIS A000170) are the
oracle. `search_distributed` runs the multi-worker search
(`engine/distributed.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import base

# Total solutions of N-Queens for N = 0..17 (OEIS A000170).
SOLUTION_COUNTS = (
    1, 1, 0, 0, 2, 10, 4, 40, 92, 352, 724, 2680, 14200, 73712,
    365596, 2279184, 14772512, 95815104,
)


def root_node(n: int) -> tuple[np.ndarray, int]:
    """Root = identity board at depth 0 (NQueens_node.c:7-13)."""
    return np.arange(n, dtype=np.int16), 0


def is_safe(board: np.ndarray, depth: int, row: int) -> bool:
    """Diagonal safety of placing `row` in column `depth` against the
    prefix (nqueens_c.c:80-96)."""
    placed = np.asarray(board[:depth], dtype=np.int64)
    dist = depth - np.arange(depth, dtype=np.int64)
    return bool(np.all((placed != row - dist) & (placed != row + dist)))


def table(n: int, g: int = 1) -> np.ndarray:
    """The N-Queens instance table: shape (g, n), both knobs in the
    shape; the values are unused."""
    return np.zeros((max(int(g), 1), int(n)), np.int32)


class NQueensProblem(base.Problem):
    """N-Queens through the generic step: the safety test is `bound`
    (0 safe, I32_MAX unsafe), and every safe child is pushed."""

    name = "nqueens"
    leaf_in_evals = False      # a popped complete board is a solution;
    #                            safe complete children are pushed
    supports_host_tier = False
    lb_kinds = (0,)            # no bound function
    default_lb = 0
    telemetry_labels = {"objective": "none"}

    def validate(self, table: np.ndarray) -> str | None:
        t = np.asarray(table)
        if t.ndim != 2 or t.shape[0] < 1 or not 4 <= t.shape[1] <= 32:
            return (f"nqueens table must be (g>=1, 4<=n<=32), got "
                    f"shape {t.shape}")
        return None

    def slots(self, table: np.ndarray) -> int:
        return int(np.asarray(table).shape[1])

    def make_tables(self, table: np.ndarray, device="cuda") -> torch.Tensor:
        from ..engine.device import resolve_device
        return torch.as_tensor(np.asarray(table, np.int32),
                               device=resolve_device(device))

    def root(self, table: np.ndarray):
        n = self.slots(table)
        return (np.arange(n, dtype=np.int16)[None, :],
                np.zeros(1, np.int16))

    def host_children(self, table: np.ndarray, node: np.ndarray,
                      depth: int, best: int, *, lb_kind: int = 1):
        n = self.slots(table)
        for j in range(depth, n):
            ok = is_safe(node, depth, int(node[j]))
            child = node.copy()
            child[depth], child[j] = child[j], child[depth]
            yield child, depth + 1, (0 if ok else base.I32_MAX), \
                depth + 1 == n

    # ------------------------------------------------ device callables

    def branch(self, tables, p_prmu, p_depth, p_aux, valid):
        from ..engine.device import make_children
        from ..ops import nqueens_ops
        g, n = tables.shape                 # the knobs are the shape
        board = p_prmu.T                    # (B, n)
        B = board.shape[0]
        safe = nqueens_ops.safe_children(board, p_depth, valid, g=g)
        children = make_children(board, p_depth).reshape(B * n, n).T
        child_depth = (p_depth + 1)[:, None].expand(B, n).reshape(-1) \
            .to(torch.int16)
        cols = torch.arange(n, device=board.device)
        evaluated = ((cols[None, :] >= p_depth[:, None])
                     & valid[:, None]).reshape(-1)
        return base.BranchOut(
            children=children, child_depth=child_depth,
            child_aux=torch.zeros((0, B * n), dtype=torch.int32,
                                  device=board.device),
            evaluated=evaluated, extras=safe.reshape(-1))

    def bound(self, tables, lb_kind: int, br, best):
        # no bound function: 0 = safe (survives the I32_MAX incumbent),
        # I32_MAX = unsafe (never does)
        return torch.where(br.extras, 0, base.I32_MAX).to(torch.int32)


PROBLEM = base.register(NQueensProblem())


def search(n: int, g: int = 1, chunk: int = 64, capacity: int = 1 << 18,
           max_iters: int | None = None, device="cuda"):
    """Single-device N-Queens through the generic engine."""
    from ..engine import device as dev_mod
    return dev_mod.solve(PROBLEM, table(n, g), lb_kind=0, chunk=chunk,
                         capacity=capacity, max_iters=max_iters,
                         device=device)


def search_distributed(n: int, g: int = 1, n_devices: int | None = None,
                       chunk: int = 64, capacity: int = 1 << 17,
                       balance_period: int = 4, min_seed: int = 32,
                       transfer_cap: int | None = None,
                       min_transfer: int | None = None,
                       devices: list | None = None):
    """Multi-worker N-Queens through the generic engine, with the transfer
    defaults 4*chunk / 2*chunk (not the byte-budgeted
    `default_transfer_cap`, whose 256-column floor would resize
    small-chunk runs). `devices`: see `parallel.mesh.worker_devices`."""
    from ..engine import distributed
    return distributed.search(
        table(n, g), problem="nqueens", lb_kind=0, n_devices=n_devices,
        devices=devices, chunk=chunk, capacity=capacity,
        balance_period=balance_period, min_seed=min_seed,
        transfer_cap=transfer_cap or 4 * chunk,
        min_transfer=min_transfer or 2 * chunk)
