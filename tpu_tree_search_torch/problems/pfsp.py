"""PFSP as a plugin of the generic engine: the instance, the root node and
the fast-path hook onto the PFSP step.

Reproduces `tpu_tree_search/problems/pfsp.py`: `PFSPInstance`
(`from_taillard`, `synthetic`, `optimum`, `makespan`,
`brute_force_optimum`), `root_node`, `ROOT_DEPTH` and `PFSPProblem`. A
node is a partial permutation: the jobs at positions `0..depth-1` of
`prmu` are the scheduled prefix (reference: PFSP_node.h:15-20, with
`limit1 == depth - 1`); its children swap `prmu[depth] <-> prmu[i]` for
each `i in depth..jobs-1` (PFSP_lib.c:7-42).

`PFSPProblem.make_step` returns `engine/device.step`, so a search through
the plugin (`device.solve`, the `solve` command) takes the same route and
kernels as `device.search`: the fused kernel, the pair sweeps and the
expand kernel on the card. `warmup` is `engine/distributed.bfs_warmup`
(the native runtime's breadth-first frontier).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import base, taillard


@dataclasses.dataclass(frozen=True)
class PFSPInstance:
    """A PFSP instance and its shape."""

    inst_id: int            # Taillard instance id (1..120), 0 for synthetic
    jobs: int
    machines: int
    p_times: np.ndarray     # (machines, jobs) int32

    @staticmethod
    def from_taillard(inst: int) -> "PFSPInstance":
        p, n, m = taillard.instance(inst)
        return PFSPInstance(inst_id=inst, jobs=n, machines=m, p_times=p)

    @staticmethod
    def synthetic(jobs: int, machines: int, seed: int = 0,
                  low: int = 1, high: int = 99) -> "PFSPInstance":
        """Random instance for tests (brute-forceable at small `jobs`)."""
        rng = np.random.default_rng(seed)
        p = rng.integers(low, high + 1, size=(machines, jobs),
                         dtype=np.int32)
        return PFSPInstance(inst_id=0, jobs=jobs, machines=machines,
                            p_times=p)

    @property
    def optimum(self) -> int | None:
        return (taillard.optimal_makespan(self.inst_id) if self.inst_id
                else None)

    def makespan(self, permutation: np.ndarray) -> int:
        """Cmax of a complete permutation (c_bound_simple.c:92-106)."""
        completion = np.zeros(self.machines, dtype=np.int64)
        for job in np.asarray(permutation):
            completion[0] += self.p_times[0, job]
            for mach in range(1, self.machines):
                completion[mach] = max(completion[mach - 1],
                                       completion[mach]) \
                    + self.p_times[mach, job]
        return int(completion[-1])

    def brute_force_optimum(self) -> int:
        """Exhaustive optimum for tiny instances (test oracle only)."""
        import itertools

        if self.jobs > 9:
            raise ValueError("brute force only for tiny instances")
        return min(self.makespan(np.array(perm))
                   for perm in itertools.permutations(range(self.jobs)))


def root_node(jobs: int) -> tuple[np.ndarray, int]:
    """Root = identity permutation at depth 0 (PFSP_node.c:7-14)."""
    return np.arange(jobs, dtype=np.int16), 0


ROOT_DEPTH = 0


class PFSPProblem(base.Problem):
    """PFSP through the plugin API; `make_step` is the fast-path hook onto
    `engine/device.step` (the `branch`/`bound` decomposition is not used
    on the device)."""

    name = "pfsp"
    leaf_in_evals = True
    supports_host_tier = True
    supports_fused = True
    lb_kinds = (0, 1, 2)
    default_lb = 1
    telemetry_labels = {"objective": "makespan"}

    def validate(self, table: np.ndarray) -> str | None:
        p = np.asarray(table)
        if p.ndim != 2 or p.shape[0] < 1 or p.shape[1] < 2:
            return (f"p_times must be a (machines, jobs>=2) table, "
                    f"got shape {p.shape}")
        return None

    def slots(self, table: np.ndarray) -> int:
        return int(np.asarray(table).shape[1])

    def aux_rows(self, table: np.ndarray) -> int:
        return int(np.asarray(table).shape[0])

    def aux_dtype(self, table: np.ndarray) -> torch.dtype:
        from ..engine.device import aux_dtype
        return aux_dtype(np.asarray(table))

    def default_capacity(self, table: np.ndarray) -> int:
        from ..engine.device import default_capacity
        t = np.asarray(table)
        return default_capacity(t.shape[1], t.shape[0])

    def make_tables(self, table: np.ndarray, device="cuda"):
        from ..ops import batched
        return batched.make_tables(np.asarray(table), device=device)

    def root(self, table: np.ndarray):
        n = self.slots(table)
        return (np.arange(n, dtype=np.int16)[None, :],
                np.zeros(1, np.int16))

    def seed_aux(self, table: np.ndarray, prmu: np.ndarray,
                 depth: np.ndarray) -> np.ndarray:
        from ..convert import np_dtype
        from ..ops import reference as ref
        t = np.asarray(table)
        m = t.shape[0]
        adt = np_dtype(self.aux_dtype(t))
        if len(depth) == 0:
            return np.zeros((0, m), adt)
        return ref.prefix_front_remain(t, prmu, depth)[:, :m].astype(adt)

    def warmup(self, table: np.ndarray, lb_kind: int,
               init_ub: int | None, target: int):
        from ..engine import distributed
        return distributed.bfs_warmup(np.asarray(table), lb_kind, init_ub,
                                      target)

    def host_children(self, table: np.ndarray, node: np.ndarray,
                      depth: int, best: int, *, lb_kind: int = 1):
        # LB1 whatever `lb_kind`, as in the JAX package (its native -C
        # tier hosts LB2)
        from ..ops import reference as ref
        p = np.asarray(table)
        jobs = p.shape[1]
        lb1 = ref.make_lb1_data(p)
        for i in range(depth, jobs):
            child = node.copy()
            child[depth], child[i] = child[i], child[depth]
            bound = ref.lb1_bound(lb1, child, depth, jobs)
            yield child, depth + 1, int(bound), depth + 1 == jobs

    def make_step(self, tables, lb_kind: int, chunk: int, tile: int,
                  limit: int | None, fused: str = "off"):
        from ..engine.device import step
        return functools.partial(step, tables, lb_kind, chunk,
                                 tile=tile, limit=limit, fused=fused)


PROBLEM = base.register(PFSPProblem())
