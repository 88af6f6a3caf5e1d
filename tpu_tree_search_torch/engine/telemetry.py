"""On-device search telemetry of the step.

Reproduces the layout and update ops of `tpu_tree_search/engine/telemetry.py`:
one flat int64 vector of `WIDTH` slots on the pool's device, updated by
every route of `device.step` and folded in by `device._commit` under the
same no-commit guard as the counters:

- popped / branched / pruned counts by relative-depth bucket (bucket k
  covers depths [k*J/DB, (k+1)*J/DB));
- histograms of the pruned and of the surviving children's bounds, binned
  by the relative gap |bound - incumbent| / incumbent (the last bin holds
  gaps of 100 % and more, and every child bounded before an incumbent
  exists);
- the pool's high-water mark;
- the work-steal flow slots (zero on one device);
- a ring of the last RING (iteration, value) incumbent improvements and
  their total count.

`device.init_state(telemetry=True)` (CLI `--search-telemetry`), or
`TTS_SEARCH_TELEMETRY=1` where the caller leaves it None, allocates the
`WIDTH` slots; off, the vector has width
0 and no route runs a telemetry op. Telemetry only observes: tree, sol,
best and evals are the same on or off.

The update ops are torch ops on the device vector and read nothing back
(a CUDA graph of the step holds them);
`bound_hist` is `ops/columns.py`'s, which the fused kernel's plain version
bins with too. `summarize` and `_ring_pairs` are numpy views on the host. `merge`,
`publish` and `delta_counts` belong to the multi-device and observability
layers, which are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.columns import BOUND_BINS, bound_hist, index_counts
from ..utils.config import env_flag

# ---------------------------------------------------------------- layout

DEPTH_BUCKETS = 8      # relative-depth buckets for popped/branched/pruned
RING = 8              # incumbent-improvement (iteration, value) pairs

O_POPPED = 0
O_BRANCHED = O_POPPED + DEPTH_BUCKETS
O_PRUNED = O_BRANCHED + DEPTH_BUCKETS
O_HIST_PRUNED = O_PRUNED + DEPTH_BUCKETS
O_HIST_SURV = O_HIST_PRUNED + BOUND_BINS
O_POOL_HW = O_HIST_SURV + BOUND_BINS     # max, not add
O_STEAL_SENT = O_POOL_HW + 1
O_STEAL_RECV = O_STEAL_SENT + 1
O_IMPROVED = O_STEAL_RECV + 1            # ring write cursor / total count
O_RING = O_IMPROVED + 1                  # RING x (iteration, value)
WIDTH = O_RING + 2 * RING

ENV_FLAG = "TTS_SEARCH_TELEMETRY"


def enabled() -> bool:
    """The flag `init_state` reads when it is not told: a state keeps the
    width it was made with."""
    return env_flag(ENV_FLAG)


# ------------------------------------------------------------ update ops

def depth_bucket(depth: torch.Tensor, jobs: int) -> torch.Tensor:
    """Relative-depth bucket of integer depths in [0, jobs] (a depth of
    `jobs` clips into the last bucket)."""
    b = depth.long() * DEPTH_BUCKETS // max(jobs, 1)
    return b.clamp(0, DEPTH_BUCKETS - 1)


def bucket_counts(bucket_idx: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor | None = None) -> torch.Tensor:
    """(DEPTH_BUCKETS,) int64 masked counts (or masked sums of `weight`)
    by bucket."""
    w = mask.long() if weight is None else torch.where(mask, weight.long(), 0)
    return index_counts(bucket_idx, w, DEPTH_BUCKETS)


def step_delta(popped_b, branched_b, pruned_b, hist_pruned=None,
               hist_surv=None) -> torch.Tensor:
    """One step's (WIDTH,) additive delta; the tail (high-water, steal
    flow, ring) stays zero: `commit` owns it."""
    z = torch.zeros(BOUND_BINS, dtype=torch.int64, device=popped_b.device)
    return torch.cat([
        popped_b, branched_b, pruned_b,
        z if hist_pruned is None else hist_pruned,
        z if hist_surv is None else hist_surv,
        torch.zeros(WIDTH - O_POOL_HW, dtype=torch.int64,
                    device=popped_b.device)])


def commit(tele: torch.Tensor, delta: torch.Tensor, new_size, best,
           prev_best, iters) -> torch.Tensor:
    """Fold one step's delta in: add the counts, max the high-water mark,
    and record (iters + 1, best) in the ring when `best` beat `prev_best`.
    The scalars are device scalars (or ints); the ring write is masked by
    `best < prev_best` (`torch.where` on the slot values, as the JAX
    package's `jnp.where`), so nothing is read back. The caller applies
    the result only when the step commits."""
    new_size, best, prev_best, iters = (
        torch.as_tensor(x, device=tele.device).long()
        for x in (new_size, best, prev_best, iters))
    t = tele + delta
    slot = torch.arange(t.shape[0], device=t.device)
    improved = best < prev_best
    count = t[O_IMPROVED]
    at = count % RING * 2 + O_RING
    t = torch.where(slot == O_POOL_HW, torch.maximum(t, new_size), t)
    t = torch.where(improved & (slot == at), iters + 1, t)
    t = torch.where(improved & (slot == at + 1), best, t)
    return torch.where(improved & (slot == O_IMPROVED), count + 1, t)


# -------------------------------------------------------- host-side views

def _ring_pairs(vec: np.ndarray) -> list[list[int]]:
    """The written (iteration, value) ring pairs in iteration order (value
    0 marks an unwritten slot: makespans are positive)."""
    pairs = [(int(vec[O_RING + 2 * k]), int(vec[O_RING + 2 * k + 1]))
             for k in range(RING)]
    pairs = [p for p in pairs if p[1] > 0]
    pairs.sort(key=lambda p: p[0])
    return [list(p) for p in pairs]


def _improving(pairs: list[list[int]]) -> list[list[int]]:
    """The strictly improving run of iteration-ordered pairs, as the JAX
    package's `merge` replays the ring before `summarize` reads it (on one
    device every recorded pair improves, so it keeps them all)."""
    out: list[list[int]] = []
    for it, val in pairs:
        if not out or val < out[-1][1]:
            out.append([it, val])
    return out[-RING:]


def _frontier_depth(popped) -> float:
    """Mean relative depth of the popped nodes in [0, 1]: the weighted
    mean bucket midpoint."""
    popped = np.asarray(popped, np.float64)
    n = popped.sum()
    if n <= 0:
        return 0.0
    mids = (np.arange(DEPTH_BUCKETS) + 0.5) / DEPTH_BUCKETS
    return round(float((popped * mids).sum() / n), 6)


def summarize(arr) -> dict | None:
    """JSON-safe summary of one device's (WIDTH,) block (a tensor or an
    array); None for a zero-width block. The JAX package's `summarize`
    schema for a single block."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    m = np.asarray(arr, np.int64).reshape(-1)
    if m.shape[0] == 0:
        return None
    popped = m[O_POPPED:O_POPPED + DEPTH_BUCKETS]
    branched = m[O_BRANCHED:O_BRANCHED + DEPTH_BUCKETS]
    pruned = m[O_PRUNED:O_PRUNED + DEPTH_BUCKETS]
    evaluated = int(branched.sum() + pruned.sum())
    return {
        "popped": popped.tolist(),
        "branched": branched.tolist(),
        "pruned": pruned.tolist(),
        "bound_hist_pruned":
            m[O_HIST_PRUNED:O_HIST_PRUNED + BOUND_BINS].tolist(),
        "bound_hist_surviving":
            m[O_HIST_SURV:O_HIST_SURV + BOUND_BINS].tolist(),
        "pool_highwater": int(m[O_POOL_HW]),
        "steal_sent": int(m[O_STEAL_SENT]),
        "steal_recv": int(m[O_STEAL_RECV]),
        "improvements": int(m[O_IMPROVED]),
        "incumbent_ring": _improving(_ring_pairs(m)),
        "pruning_rate": round(float(pruned.sum()) / max(evaluated, 1), 6),
        "frontier_depth": _frontier_depth(popped),
    }
