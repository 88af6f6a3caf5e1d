"""0/1 knapsack as a plugin of the generic engine, with the Dantzig
(fractional) bound (LB1) or the Martello-Toth bound (LB2).

Reproduces `tpu_tree_search/problems/knapsack.py`: `KnapsackTables`,
`make_table`, `_sorted_items`, `_fractional_ub`, `_mt_ub`,
`KnapsackInstance` (with `GOLDEN`) and `KnapsackProblem`. A node is a
decision prefix over the items in density order (`_sorted_items`, one
deterministic order shared by the device and the host): `prmu[i]` in
{0, 1} is the choice for item i < depth. Two children per parent (skip,
take), in columns `b * 2 + s`. `aux` carries two rows: the accumulated
weight and value.

The engine minimizes, so the objective is the negated value:
`bound = -(value + ub(remaining))`. LB1 fills the residual capacity
greedily in density order and takes the floor of a fraction of the first
item that does not fit. LB2 is Martello-Toth's U2 = max(U0, U1) around the
break item k: U0 skips k (the next item's density fills the residual), U1
takes k and displaces weight of the density of k - 1, valid only when the
greedy prefix is not empty (k - 1 >= the first undecided item). Every
product and division is in int64, and `//` on integer tensors floors in
torch as in JAX. An over-capacity child bounds to I32_MAX; a child at
depth n is a leaf whose bound is -value.

The bound's (C, n) `rel`/`can` matrices hold C * n elements (C = 2 *
chunk): size the chunk for them.

Instance table (3, n) int32: weights (>= 1), values (>= 0), and
[capacity, 0, ...].
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import base

I32_MAX = base.I32_MAX


class KnapsackTables(NamedTuple):
    w: torch.Tensor      # (n,) int32 weights, density-descending
    v: torch.Tensor      # (n,) int32 values, same order
    cap: torch.Tensor    # () int32 capacity
    cumw: torch.Tensor   # (n+1,) int32 prefix sums of w


def make_table(weights, values, capacity: int) -> np.ndarray:
    """The (3, n) instance table."""
    w = np.asarray(weights, np.int32)
    v = np.asarray(values, np.int32)
    if w.shape != v.shape or w.ndim != 1:
        raise ValueError(f"weights {w.shape} and values {v.shape} must be "
                         "one row each, of one length")
    cap_row = np.zeros_like(w)
    cap_row[0] = int(capacity)
    return np.stack([w, v, cap_row])


def _sorted_items(table: np.ndarray):
    """(weights, values, capacity, order) in density-descending order,
    ties by item index: the order the device and host helpers share."""
    t = np.asarray(table)
    w = t[0].astype(np.int64)
    v = t[1].astype(np.int64)
    cap = int(t[2, 0])
    order = np.lexsort((np.arange(len(w)), -(v / np.maximum(w, 1))))
    return w[order].astype(np.int32), v[order].astype(np.int32), cap, \
        order


def _fractional_ub(w: np.ndarray, v: np.ndarray, start: int,
                   rem_cap: int) -> int:
    """Host Dantzig bound over sorted items[start:] at `rem_cap` residual
    capacity (LB1's oracle)."""
    total = 0
    r = int(rem_cap)
    for i in range(start, len(w)):
        if int(w[i]) <= r:
            r -= int(w[i])
            total += int(v[i])
        else:
            total += (r * int(v[i])) // max(int(w[i]), 1)
            break
    return total


def _mt_ub(w: np.ndarray, v: np.ndarray, start: int,
           rem_cap: int) -> int:
    """Host Martello-Toth bound over sorted items[start:] (LB2's
    oracle); see the module docstring."""
    n = len(w)
    r = int(rem_cap)
    z = 0
    k = start
    while k < n and int(w[k]) <= r:
        r -= int(w[k])
        z += int(v[k])
        k += 1
    if k >= n:
        return z
    u0 = z + ((r * int(v[k + 1])) // int(w[k + 1]) if k + 1 < n else 0)
    if k - 1 >= start:
        need = int(w[k]) - r
        lost = -((-need * int(v[k - 1])) // int(w[k - 1]))  # ceil div
        return max(u0, z + int(v[k]) - lost)
    return u0


@dataclasses.dataclass(frozen=True)
class KnapsackInstance:
    """A knapsack instance and test helpers."""

    weights: np.ndarray
    values: np.ndarray
    capacity: int

    @property
    def table(self) -> np.ndarray:
        return make_table(self.weights, self.values, self.capacity)

    @staticmethod
    def synthetic(n: int, seed: int = 0) -> "KnapsackInstance":
        rng = np.random.default_rng(seed)
        w = rng.integers(1, 50, size=n, dtype=np.int32)
        v = rng.integers(1, 100, size=n, dtype=np.int32)
        return KnapsackInstance(weights=w, values=v,
                                capacity=int(w.sum()) // 2)

    def optimum(self) -> int:
        """Exact optimal value by dynamic programming (test oracle)."""
        dp = np.zeros(self.capacity + 1, np.int64)
        for w, v in zip(self.weights, self.values):
            w, v = int(w), int(v)
            if w <= self.capacity:
                dp[w:] = np.maximum(dp[w:], dp[:-w] + v)
        return int(dp.max())


# Pinned golden instances of known optimum (Kreher and Stinson's P01 and
# P02; the tests derive each optimum again by DP).
GOLDEN = {
    "p01": (KnapsackInstance(
        weights=np.array([23, 31, 29, 44, 53, 38, 63, 85, 89, 82]),
        values=np.array([92, 57, 49, 68, 60, 43, 67, 84, 87, 72]),
        capacity=165), 309),
    "p02": (KnapsackInstance(
        weights=np.array([12, 7, 11, 8, 9]),
        values=np.array([24, 13, 23, 15, 16]),
        capacity=26), 51),
}


class KnapsackProblem(base.Problem):
    name = "knapsack"
    leaf_in_evals = True
    supports_host_tier = True
    lb_kinds = (1, 2)        # 1 = Dantzig, 2 = Martello-Toth
    default_lb = 1
    telemetry_labels = {"objective": "neg_value"}
    branch_factor = 2        # skip / take: the scratch margin is 2 * chunk

    def validate(self, table: np.ndarray) -> str | None:
        t = np.asarray(table)
        if t.ndim != 2 or t.shape[0] != 3 or not 2 <= t.shape[1] <= 4096:
            return (f"knapsack table must be (3, 2<=n<=4096) "
                    f"[weights; values; capacity row], got shape "
                    f"{t.shape}")
        if (t[0] < 1).any():
            return "knapsack weights must be >= 1"
        if (t[1] < 0).any() or int(t[1].max()) > 2**20:
            return "knapsack values must be in [0, 2^20]"
        if int(t[2, 0]) < 0:
            return "knapsack capacity must be >= 0"
        # the device bound sums weights and values in int32
        if int(t[0].astype(np.int64).sum()) > 2**30:
            return "knapsack weights must sum to <= 2^30 (int32 bound)"
        if int(t[1].astype(np.int64).sum()) > 2**30:
            return "knapsack values must sum to <= 2^30 (int32 bound)"
        return None

    def slots(self, table: np.ndarray) -> int:
        return int(np.asarray(table).shape[1])

    def aux_rows(self, table: np.ndarray) -> int:
        return 2             # [accumulated weight, accumulated value]

    def make_tables(self, table: np.ndarray,
                    device="cuda") -> KnapsackTables:
        from ..engine.device import resolve_device
        dev = resolve_device(device)
        w, v, cap, _ = _sorted_items(table)
        cumw = np.zeros(len(w) + 1, np.int32)
        np.cumsum(w, out=cumw[1:])
        return KnapsackTables(*(torch.as_tensor(a, device=dev) for a in
                                (w, v, np.asarray(cap, np.int32), cumw)))

    def root(self, table: np.ndarray):
        n = self.slots(table)
        return (np.zeros((1, n), np.int16), np.zeros(1, np.int16))

    def seed_aux(self, table: np.ndarray, prmu: np.ndarray,
                 depth: np.ndarray) -> np.ndarray:
        w, v, _, _ = _sorted_items(table)
        out = np.zeros((len(depth), 2), np.int32)
        for k, (p, dep) in enumerate(zip(np.asarray(prmu, np.int64),
                                         np.asarray(depth))):
            taken = p[:dep] > 0
            out[k, 0] = int(w[:dep][taken].sum())
            out[k, 1] = int(v[:dep][taken].sum())
        return out

    def host_children(self, table: np.ndarray, node: np.ndarray,
                      depth: int, best: int, *, lb_kind: int = 1):
        w, v, cap, _ = _sorted_items(table)
        n = len(w)
        ub_fn = _mt_ub if lb_kind == 2 else _fractional_ub
        taken = node[:depth] > 0
        weight = int(w[:depth][taken].sum())
        value = int(v[:depth][taken].sum())
        is_leaf = depth + 1 == n
        for take in (0, 1):
            child = node.copy()
            child[depth] = take
            cw = weight + take * int(w[depth])
            cv = value + take * int(v[depth])
            if cw > cap:
                bound = I32_MAX
            else:
                bound = -(cv + ub_fn(w, v, depth + 1, cap - cw))
            yield child, depth + 1, bound, is_leaf

    # ------------------------------------------------ device callables

    def branch(self, tables: KnapsackTables, p_prmu, p_depth, p_aux,
               valid):
        n = tables.w.shape[0]
        B = p_prmu.shape[1]
        d = p_depth.clamp(0, n - 1).long()
        w_it = tables.w[d]
        v_it = tables.v[d]
        weight, value = p_aux[0], p_aux[1]
        pos = torch.arange(n, dtype=torch.int32,
                           device=p_prmu.device)[:, None]
        at_d = pos == p_depth[None, :]
        skip_b = torch.where(at_d, 0, p_prmu).to(torch.int16)
        take_b = torch.where(at_d, 1, p_prmu).to(torch.int16)
        # columns b*2 + s (s = 0 skip, 1 take): the stack top pops "take"
        # first, which finds greedy incumbents early
        children = torch.stack([skip_b, take_b], dim=2).reshape(n, 2 * B)
        child_depth = (p_depth + 1)[:, None].expand(B, 2).reshape(-1) \
            .to(torch.int16)
        new_w = torch.stack([weight, weight + w_it], dim=1).reshape(-1)
        new_v = torch.stack([value, value + v_it], dim=1).reshape(-1)
        evaluated = valid[:, None].expand(B, 2).reshape(-1)
        return base.BranchOut(
            children=children, child_depth=child_depth,
            child_aux=torch.stack([new_w, new_v], dim=0),
            evaluated=evaluated, extras=new_w <= tables.cap)

    def bound(self, tables: KnapsackTables, lb_kind: int, br, best):
        n = tables.w.shape[0]
        feasible = br.extras
        s = br.child_depth.to(torch.int32)            # first undecided
        W, V = br.child_aux[0], br.child_aux[1]
        r = tables.cap - W                            # (C,) residual
        base_w = tables.cumw[torch.clamp(s, max=n).long()]
        rel = tables.cumw[None, 1:] - base_w[:, None]  # (C, n) incl. i
        idx = torch.arange(n, dtype=torch.int32, device=s.device)[None, :]
        # weights >= 1 make `rel` strictly increasing over the suffix, so
        # the fit mask is a prefix of items s..n-1 (the greedy fill)
        can = (idx >= s[:, None]) & (rel <= r[:, None])
        int_val = torch.where(can, tables.v[None, :], 0) \
            .sum(dim=1, dtype=torch.int32)
        taken_w = torch.where(can, tables.w[None, :], 0) \
            .sum(dim=1, dtype=torch.int32)
        k = s + can.sum(dim=1, dtype=torch.int32)     # first overflow
        has_frac = k < n

        def item(i):
            ic = i.clamp(0, n - 1).long()
            return tables.w[ic].long(), tables.v[ic].long()

        wk, vk = item(k)
        rbar = (r - taken_w).long()                   # residual at k
        if lb_kind == 2:
            wk1, vk1 = item(k + 1)
            u0 = torch.where(k + 1 < n, (rbar * vk1) // wk1, 0)
            wm, vm = item(k - 1)
            lost = ((wk - rbar) * vm + wm - 1) // wm   # ceil division
            u1 = vk - lost
            # U1 needs a greedy prefix to displace from (k - 1 >= s)
            frac = torch.where(
                has_frac, torch.where(k - 1 >= s, torch.maximum(u0, u1), u0),
                0).to(torch.int32)
        else:
            frac = torch.where(has_frac, (rbar * vk) // wk.clamp(min=1),
                               0).to(torch.int32)
        ub = V + int_val + frac
        return torch.where(feasible, -ub, I32_MAX).to(torch.int32)

    def display_objective(self, best: int) -> int:
        """The engine minimizes -value; report the value."""
        return -int(best)

    def engine_objective(self, value: int) -> int:
        """A user's value bound seeds the incumbent as -value."""
        return -int(value)


PROBLEM = base.register(KnapsackProblem())
