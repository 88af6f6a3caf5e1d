"""Problem-plugin protocol and registry: one generic branch-and-bound
engine, many workloads.

Reproduces `tpu_tree_search/problems/base.py` (`I32_MAX`,
`HostTierUnsupported`, `BranchOut`, `Problem`, `register`, `get`,
`names`) on torch tensors. A :class:`Problem` is a stateless singleton
that tells the problem-blind pipeline (`engine/device.generic_step`,
`run_problem`, `solve`) everything problem-specific:

- the static spec, from one 2-D instance table: `slots` (the pool's node
  width), `aux_rows`/`aux_dtype` (the per-node side rows and their torch
  dtype), `branching`, `usable_rows` (the pool rows left above the
  scratch margin) and `default_capacity`;
- the device callables: `branch` (the dense child grid and its evaluated
  mask), `bound` (each child's bound; at a leaf child of a
  `leaf_in_evals` problem the bound is the exact objective),
  `is_leaf_cols`, and `make_step`, the fast-path hook (PFSP returns
  `engine/device.step`, with its kernels; the default is
  `engine/device.generic_step` over `branch` and `bound`);
- the host-side seed (`root`, `seed_aux`) and oracle (`host_children`);
- the accounting rule: `leaf_in_evals` True (PFSP style: every evaluated
  leaf child counts in `sol` and is never pushed) or False (N-Queens
  style: every surviving child is pushed, and a popped complete node
  counts in `sol`).

The instance is one 2-D integer table: PFSP (machines, jobs) processing
times; N-Queens (g, n), both knobs in the shape; TSP the (n, n) distance
matrix; knapsack (3, n) rows weights, values and [capacity, 0, ...].

`warmup` is the host BFS frontier (`engine/distributed.Frontier`) that
seeds the multi-worker search; by default a pop-front BFS over
`host_children`.

`problems/__init__.py` registers the four built-in plugins at import;
`get(name)` is the one place a name resolves.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch

I32_MAX = 2**31 - 1


class HostTierUnsupported(ValueError):
    """Refusal of the `-C` host tier (`host_fraction > 0`) for a plugin
    that has not opted in (`Problem.supports_host_tier` False). A
    ValueError, so callers that catch the untyped refusal still do."""

    def __init__(self, problem: str):
        self.problem = problem
        super().__init__(
            f"the -C host tier is not supported for problem "
            f"{problem!r} (no host_children/host-session support; "
            f"set supports_host_tier on the plugin to enable it)")


class BranchOut(NamedTuple):
    """One step's dense child grid, feature-major like the pool. Columns
    run parent-major: `b * branching + i`. `extras` is whatever `branch`
    hands on to `bound`, computed once."""

    children: Any        # (J, C) int16, C = chunk * branching
    child_depth: Any     # (C,) int16
    child_aux: Any       # (A, C) int32 (cast to the pool dtype at write)
    evaluated: Any       # (C,) bool: real children of valid parents
    extras: Any = ()


class Problem:
    """Base plugin. Every per-instance quantity derives from the
    instance table: its values become device tensors, its shape fixes the
    static sizes."""

    name: str = ""
    # PFSP-style accounting (True) or N-Queens-style (False); see the
    # module docstring
    leaf_in_evals: bool = True
    # whether the plugin runs the JAX package's -C host tier
    # (engine/hybrid, not yet ported)
    supports_host_tier: bool = False
    # whether make_step uses the fused route's mode (ops/fused.py, PFSP
    # only); other plugins run under mode "off" whatever the caller asks
    supports_fused: bool = False
    lb_kinds: tuple = (1,)
    default_lb: int = 1
    # children per popped parent; None = slots (a permutation problem's
    # (chunk, J) grid). The pool's scratch margin is chunk * this.
    branch_factor: int | None = None
    telemetry_labels: dict = {"objective": "bound"}

    # ------------------------------------------------------ static spec

    def validate(self, table: np.ndarray) -> str | None:
        """Why the table is refused, or None."""
        raise NotImplementedError

    def slots(self, table: np.ndarray) -> int:
        """Pool node width J (the prmu row length)."""
        raise NotImplementedError

    def aux_rows(self, table: np.ndarray) -> int:
        return 0

    def aux_dtype(self, table: np.ndarray) -> torch.dtype:
        return torch.int32

    def branching(self, table: np.ndarray) -> int:
        """Children per parent (the child-grid width per popped node)."""
        return self.branch_factor or self.slots(table)

    def usable_rows(self, capacity: int, chunk: int, slots: int) -> int:
        """Pool rows above which a step overflows: capacity less the
        chunk * branching scratch margin an overflowing step writes its
        block into (`engine/device.row_limit` for any branching)."""
        return max(capacity - chunk * (self.branch_factor or slots), 0)

    def default_capacity(self, table: np.ndarray) -> int:
        return 1 << 18

    def make_tables(self, table: np.ndarray, device="cuda"):
        """The plugin's tables as tensors on `device`."""
        raise NotImplementedError

    # -------------------------------------------------- host-side seed

    def root(self, table: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Seed rows: ((n0, J) int16 nodes, (n0,) int16 depths)."""
        raise NotImplementedError

    def seed_aux(self, table: np.ndarray, prmu: np.ndarray,
                 depth: np.ndarray) -> np.ndarray | None:
        """(n, A) aux rows of host-built nodes (None when A == 0); equal
        to what `branch` keeps."""
        return None

    def warmup(self, table: np.ndarray, lb_kind: int,
               init_ub: int | None, target: int):
        """Host BFS frontier of >= `target` nodes (or the exhausted tree)
        with its warm-up counters (`engine/distributed.Frontier`), the
        multi-worker search's seed. Default: pop-front BFS over
        `host_children`, with the plugin's accounting rule."""
        from collections import deque

        from ..engine.distributed import Frontier

        best = I32_MAX if init_ub is None else int(init_ub)
        tree = sol = 0
        prmu0, depth0 = self.root(table)
        frontier: deque = deque(
            (np.asarray(p, np.int16), int(d))
            for p, d in zip(prmu0, depth0))
        while frontier and len(frontier) < target:
            node, depth = frontier.popleft()
            if not self.leaf_in_evals and depth == self.slots(table):
                sol += 1
                continue
            for child, cdepth, bound, is_leaf in self.host_children(
                    table, node, depth, best, lb_kind=lb_kind):
                if self.leaf_in_evals and is_leaf:
                    sol += 1
                    if bound < best:
                        best = bound
                elif bound < best:
                    frontier.append((child, cdepth))
                    tree += 1
        J = self.slots(table)
        if frontier:
            prmu = np.stack([f[0] for f in frontier]).astype(np.int16)
            depth = np.array([f[1] for f in frontier], np.int16)
        else:
            prmu = np.zeros((0, J), np.int16)
            depth = np.zeros(0, np.int16)
        return Frontier(prmu=prmu, depth=depth, tree=tree, sol=sol,
                        best=best)

    def host_children(self, table: np.ndarray, node: np.ndarray,
                      depth: int, best: int, *, lb_kind: int = 1):
        """Host oracle: yield (child, child_depth, bound, is_leaf) for
        every evaluated child of one node; the same values as `branch`
        and `bound` for the same `lb_kind`."""
        raise NotImplementedError

    # ------------------------------------------------- device callables

    def branch(self, tables, p_prmu, p_depth, p_aux, valid) -> BranchOut:
        """Dense child grid of a popped block: p_prmu (J, B) int16,
        p_depth (B,) int32 (0 in invalid columns), p_aux (A, B) int32,
        valid (B,) bool."""
        raise NotImplementedError

    def bound(self, tables, lb_kind: int, br: BranchOut, best):
        """(C,) int32 child bounds; see the class docstring for leaves.
        Unbounded problems return 0 (survive) or I32_MAX (infeasible)."""
        raise NotImplementedError

    def is_leaf_cols(self, tables, br: BranchOut) -> torch.Tensor:
        """(C,) bool: which child columns are complete solutions."""
        J = br.children.shape[0]
        return br.child_depth.to(torch.int32) == J

    def make_step(self, tables, lb_kind: int, chunk: int, tile: int,
                  limit: int | None, fused: str = "off"):
        """The step callable `step_fn(state, active=None)`: by default
        `engine/device.generic_step` over `branch`/`bound`. `fused` is the
        resolved fused mode; the generic step has no fused kernel and
        ignores it."""
        from ..engine.device import generic_step
        del fused
        return functools.partial(generic_step, self, tables, lb_kind, chunk,
                                 tile=tile, limit=limit)

    # ------------------------------------------------------- reporting

    def display_objective(self, best: int) -> int:
        """The user's objective from the engine's minimized `best`."""
        return int(best)

    def engine_objective(self, value: int) -> int:
        """The inverse of `display_objective`: a user's objective value
        (a CLI `-u`) in the engine's minimized domain."""
        return int(value)

    def __repr__(self) -> str:
        return f"<Problem {self.name!r}>"


# --------------------------------------------------------------- registry

_REGISTRY: dict[str, Problem] = {}


def register(problem: Problem) -> Problem:
    """Register a plugin singleton under `problem.name`: idempotent for
    the same object; another object under a taken name raises."""
    if not problem.name:
        raise ValueError("problem plugins must set a non-empty .name")
    prior = _REGISTRY.get(problem.name)
    if prior is not None and prior is not problem:
        raise ValueError(f"problem {problem.name!r} is already "
                         f"registered by {prior!r}")
    _REGISTRY[problem.name] = problem
    return problem


def get(name: str) -> Problem:
    """The plugin registered under `name`."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown problem {name!r} (registered: {sorted(_REGISTRY)})"
        ) from None


def names() -> list[str]:
    return sorted(_REGISTRY)
