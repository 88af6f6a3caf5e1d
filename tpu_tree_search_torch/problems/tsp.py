"""TSP as a plugin of the generic engine: depth-first search over partial
tours, with a nearest-neighbour-sum bound (LB1) or a spanning-tree bound
(LB2).

Reproduces `tpu_tree_search/problems/tsp.py`: `TSPTables`, `_minout`,
`_wsym`, `_host_mst`, `TSPInstance` (with `GOLDEN_D` and
`GOLDEN_OPTIMUM`) and `TSPProblem`. A node is a partial tour: the cities at
positions `0..depth-1` of `prmu` are the path so far, city 0 pinned at
position 0 (the root sits at depth 1); the children append each unvisited
city by the prefix swap `prmu[d] <-> prmu[i]`. A child at depth n is a
complete tour whose objective closes the cycle back to city 0. `aux`
carries one row, the prefix path cost.

LB1: prefix cost + D[endpoint, appended] + the sum over the appended and
unvisited cities of their cheapest outgoing edge (`minout`), taken on the
parent's suffix, so the whole child grid bounds in O(n) per parent.

LB2 (Held-Karp's spanning-tree relaxation): the rest of any child's tour
is a Hamiltonian path over S = {suffix cities} and {start}, the same set
for every child of one parent, so one minimum spanning tree per popped
parent bounds every child: prefix cost + D[endpoint, appended] + MST(S),
on the symmetrized weights `min(D, D.T)` (admissible for asymmetric
instances too). The device MST is Prim's algorithm: n - 1 masked argmins
over a (B, n) int64 candidate matrix, one Prim per popped parent, in
Python-unrolled torch operations (a captured step holds 8 or so per
round). `torch.argmin` takes the first index on ties, like `jnp.argmin`;
the total weight is the same for any tie-break, so the host oracle needs
no coordination.

The instance table is the (n, n) int32 distance matrix (asymmetric
allowed; the diagonal is ignored).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import base

I32_MAX = base.I32_MAX
_INF = 2**62                 # Prim's "not reachable" distance, int64


class TSPTables(NamedTuple):
    d: torch.Tensor       # (n, n) int32 distance matrix
    dt: torch.Tensor      # (n, n) int32 transpose (leaf return edges)
    minout: torch.Tensor  # (n,) int32 cheapest outgoing edge per city
    wsym: torch.Tensor    # (n, n) int32 min(D, D.T): LB2's weights


def _minout(d: np.ndarray) -> np.ndarray:
    n = d.shape[0]
    masked = d.astype(np.int64) + np.where(np.eye(n, dtype=bool),
                                           np.int64(2**31), 0)
    return masked.min(axis=1).astype(np.int32)


def _wsym(d: np.ndarray) -> np.ndarray:
    d = np.asarray(d, np.int32)
    return np.minimum(d, d.T)


def _host_mst(wsym: np.ndarray, members: np.ndarray, start: int) -> int:
    """Prim over the member vertices: LB2's host oracle, the same loop
    as `TSPProblem.bound`'s."""
    INF = np.int64(_INF)
    w = wsym.astype(np.int64)
    in_tree = np.zeros(len(members), bool)
    in_tree[start] = True
    dist = np.where(members & ~in_tree, w[start], INF)
    total = 0
    for _ in range(int(members.sum())):
        j = int(dist.argmin())
        if dist[j] >= INF:
            break
        total += int(dist[j])
        in_tree[j] = True
        dist = np.where(members & ~in_tree, np.minimum(dist, w[j]), INF)
    return total


@dataclasses.dataclass(frozen=True)
class TSPInstance:
    """A TSP instance (distance matrix) and test helpers."""

    n: int
    d: np.ndarray            # (n, n) int32

    @staticmethod
    def synthetic(n: int, seed: int = 0, coord_range: int = 100
                  ) -> "TSPInstance":
        """Random Euclidean instance, distances rounded to integers."""
        rng = np.random.default_rng(seed)
        pts = rng.integers(0, coord_range, size=(n, 2))
        diff = pts[:, None, :] - pts[None, :, :]
        d = np.sqrt((diff ** 2).sum(-1)).round().astype(np.int32)
        np.fill_diagonal(d, 0)
        return TSPInstance(n=n, d=d)

    def tour_length(self, tour: np.ndarray) -> int:
        t = np.asarray(tour, np.int64)
        return int(self.d[t, np.roll(t, -1)].sum())

    def brute_force_optimum(self) -> int:
        import itertools

        if self.n > 10:
            raise ValueError("brute force only for tiny instances")
        return min(self.tour_length(np.array((0,) + perm))
                   for perm in itertools.permutations(range(1, self.n)))


# A pinned golden instance: 6 cities, optimum by exhaustive enumeration
# (the tests derive it again by brute force and assert this constant).
GOLDEN_D = np.array([
    [0, 10, 15, 20, 8, 25],
    [10, 0, 35, 25, 12, 18],
    [15, 35, 0, 30, 16, 28],
    [20, 25, 30, 0, 14, 22],
    [8, 12, 16, 14, 0, 9],
    [25, 18, 28, 22, 9, 0],
], np.int32)
GOLDEN_OPTIMUM = 95


class TSPProblem(base.Problem):
    name = "tsp"
    leaf_in_evals = True
    supports_host_tier = True
    lb_kinds = (1, 2)        # 1 = nearest-neighbour sum, 2 = MST
    default_lb = 1
    telemetry_labels = {"objective": "tour_length"}

    def validate(self, table: np.ndarray) -> str | None:
        t = np.asarray(table)
        if t.ndim != 2 or t.shape[0] != t.shape[1] or t.shape[0] < 3:
            return (f"tsp table must be a square (n>=3, n) distance "
                    f"matrix, got shape {t.shape}")
        if t.shape[0] > 512:
            return f"tsp supports n <= 512 cities, got {t.shape[0]}"
        if (t < 0).any() or int(t.max(initial=0)) > 10**6:
            return "tsp distances must be in [0, 1e6]"
        return None

    def slots(self, table: np.ndarray) -> int:
        return int(np.asarray(table).shape[0])

    def aux_rows(self, table: np.ndarray) -> int:
        return 1             # prefix path cost

    def make_tables(self, table: np.ndarray, device="cuda") -> TSPTables:
        from ..engine.device import resolve_device
        dev = resolve_device(device)
        d = np.asarray(table, np.int32)
        return TSPTables(*(torch.as_tensor(np.ascontiguousarray(a),
                                           device=dev)
                           for a in (d, d.T, _minout(d), _wsym(d))))

    def root(self, table: np.ndarray):
        n = self.slots(table)
        # city 0 pinned at position 0: the identity at depth 1
        return (np.arange(n, dtype=np.int16)[None, :],
                np.ones(1, np.int16))

    def seed_aux(self, table: np.ndarray, prmu: np.ndarray,
                 depth: np.ndarray) -> np.ndarray:
        d = np.asarray(table, np.int64)
        out = np.zeros((len(depth), 1), np.int32)
        for k, (p, dep) in enumerate(zip(np.asarray(prmu, np.int64),
                                         np.asarray(depth))):
            out[k, 0] = int(d[p[:dep - 1], p[1:dep]].sum()) \
                if dep > 1 else 0
        return out

    def host_children(self, table: np.ndarray, node: np.ndarray,
                      depth: int, best: int, *, lb_kind: int = 1):
        d = np.asarray(table, np.int64)
        mo = _minout(np.asarray(table)).astype(np.int64)
        n = len(node)
        prefix = node[:depth].astype(np.int64)
        cost = int(d[prefix[:-1], prefix[1:]].sum())
        suffix_mo = int(mo[node[depth:].astype(np.int64)].sum())
        end = int(node[depth - 1])
        if lb_kind == 2 and depth + 1 < n:
            # one MST per parent: S = suffix and start, for every child
            members = np.zeros(n, bool)
            members[node[depth:].astype(np.int64)] = True
            members[int(node[0])] = True
            mst = _host_mst(_wsym(table), members, int(node[0]))
        else:
            mst = 0
        for i in range(depth, n):
            child = node.copy()
            child[depth], child[i] = child[i], child[depth]
            appended = int(node[i])
            new_cost = cost + int(d[end, appended])
            if depth + 1 == n:
                bound = new_cost + int(d[appended, int(node[0])])
            elif lb_kind == 2:
                bound = new_cost + mst
            else:
                bound = new_cost + suffix_mo
            yield child, depth + 1, bound, depth + 1 == n

    # ------------------------------------------------ device callables

    def branch(self, tables: TSPTables, p_prmu, p_depth, p_aux, valid):
        from ..engine.device import make_children
        n = tables.d.shape[0]
        board = p_prmu.T.to(torch.int32)                # (B, n)
        bl = board.long()
        B = board.shape[0]
        dev = board.device
        pos = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
        # endpoint city prmu[depth-1] by a masked sum (depth >= 1 for a
        # valid parent; invalid columns are masked off later)
        endpoint = torch.where(pos == (p_depth - 1)[:, None], board, 0) \
            .sum(dim=1, dtype=torch.int32)
        edge = tables.d[endpoint.long()].gather(1, bl)   # D[end, city]
        ret = tables.dt[bl[:, 0]].gather(1, bl)          # D[city, start]
        suffix = pos >= p_depth[:, None]
        suffix_mo = torch.where(suffix, tables.minout[bl], 0) \
            .sum(dim=1, dtype=torch.int32)
        new_cost = p_aux[0][:, None] + edge              # (B, n)

        evaluated = (suffix & valid[:, None]).reshape(-1)
        children = make_children(board.to(torch.int16),
                                 p_depth).reshape(B * n, n).T
        child_depth = (p_depth + 1)[:, None].expand(B, n).reshape(-1) \
            .to(torch.int16)
        # LB2's per-parent vertex set S = suffix and start, in city space
        # (a scatter along a permutation: no index repeats in a valid row)
        members = torch.zeros((B, n), dtype=torch.bool, device=dev) \
            .scatter_(1, bl, suffix)
        members.scatter_(1, bl[:, :1], True)
        return base.BranchOut(
            children=children, child_depth=child_depth,
            child_aux=new_cost.reshape(1, -1),
            evaluated=evaluated,
            extras=(ret.reshape(-1),
                    suffix_mo[:, None].expand(B, n).reshape(-1),
                    members, bl[:, 0]))

    def bound(self, tables: TSPTables, lb_kind: int, br, best):
        n = tables.d.shape[0]
        ret, suffix_mo, members, start = br.extras
        new_cost = br.child_aux[0]
        leaf = br.child_depth.to(torch.int32) == n
        if lb_kind == 2:
            # Prim's algorithm, one run per popped parent
            B = members.shape[0]
            w = tables.wsym.long()
            in_tree = torch.zeros((B, n), dtype=torch.bool,
                                  device=members.device) \
                .scatter_(1, start[:, None], True)
            dist = torch.where(members & ~in_tree, w[start], _INF)
            total = torch.zeros(B, dtype=torch.int64, device=members.device)
            for _ in range(n - 1):
                j = dist.argmin(dim=1, keepdim=True)     # first-index ties
                dmin = dist.gather(1, j)[:, 0]
                add = dmin < _INF
                total = total + torch.where(add, dmin, 0)
                in_tree = in_tree.scatter(1, j, in_tree.gather(1, j)
                                          | add[:, None])
                dist = torch.where(members & ~in_tree,
                                   torch.minimum(dist, w[j[:, 0]]), _INF)
            lb = total[:, None].to(torch.int32).expand(B, n).reshape(-1)
        else:
            lb = suffix_mo
        # a complete tour's bound is its exact length (the closing edge)
        return torch.where(leaf, new_cost + ret,
                           new_cost + lb).to(torch.int32)


PROBLEM = base.register(TSPProblem())
