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
- the work-steal flow slots (zero on one device; a multi-worker search's
  balance round adds each committed round's sent and received rows,
  `engine/distributed._balance_round`);
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
bins with too. `summarize`, `merge` (the checkpoint, reshard and
multi-worker folding rule), `delta_counts` and `frontier_depth` are numpy
views on the host; `publish` writes a summary into an `obs/metrics`
registry as labelled gauges.
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


def enabled_width() -> int:
    """The vector's width for a state made now: WIDTH when the flag is
    on, else 0."""
    return WIDTH if enabled() else 0


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


def merge(stacked: np.ndarray) -> np.ndarray:
    """Fold a (D, WIDTH) per-worker block into one (WIDTH,) vector: counts
    sum, the pool high-water is the max, and the incumbent ring is rebuilt
    by replaying every worker's improvements in iteration order and
    keeping the strictly improving tail, laid out to end at slot
    (total - 1) % RING, where `commit`'s write cursor expects it."""
    stacked = np.atleast_2d(np.asarray(stacked, np.int64))
    if stacked.shape[-1] == 0:
        return np.zeros(0, np.int64)
    out = stacked.sum(axis=0)
    out[O_POOL_HW] = stacked[:, O_POOL_HW].max()
    pairs: list[tuple[int, int]] = []
    for d in range(stacked.shape[0]):
        pairs.extend((p[0], p[1]) for p in _ring_pairs(stacked[d]))
    pairs.sort(key=lambda p: p[0])
    replay: list[tuple[int, int]] = []
    for it, val in pairs:
        if not replay or val < replay[-1][1]:
            replay.append((it, val))
    replay = replay[-RING:]
    out[O_RING:] = 0
    start = (int(out[O_IMPROVED]) - len(replay)) % RING
    for k, (it, val) in enumerate(replay):
        slot = (start + k) % RING
        out[O_RING + 2 * slot] = it
        out[O_RING + 2 * slot + 1] = val
    return out


def delta_counts(now_vec, prev_vec) -> dict:
    """Window-scoped counts between two merged (WIDTH,) snapshots (the
    per-segment `search.telemetry` event of `checkpoint.run_segmented`);
    only the additive slots are read."""
    d = (np.asarray(now_vec, np.int64)
         - np.asarray(prev_vec, np.int64))
    popped = d[O_POPPED:O_POPPED + DEPTH_BUCKETS]
    branched = int(d[O_BRANCHED:O_BRANCHED + DEPTH_BUCKETS].sum())
    pruned = int(d[O_PRUNED:O_PRUNED + DEPTH_BUCKETS].sum())
    return {
        "popped": int(popped.sum()),
        "branched": branched,
        "pruned": pruned,
        "pruning_rate": round(pruned / max(branched + pruned, 1), 6),
        "frontier_depth": frontier_depth(popped),
        "steal_sent": int(d[O_STEAL_SENT]),
        "steal_recv": int(d[O_STEAL_RECV]),
    }


def frontier_depth(popped) -> float:
    """Mean relative depth of the popped nodes in [0, 1]: the weighted
    mean bucket midpoint."""
    popped = np.asarray(popped, np.float64)
    n = popped.sum()
    if n <= 0:
        return 0.0
    mids = (np.arange(DEPTH_BUCKETS) + 0.5) / DEPTH_BUCKETS
    return round(float((popped * mids).sum() / n), 6)


def summarize(arr) -> dict | None:
    """JSON-safe summary of a (WIDTH,) or (D, WIDTH) block (a tensor or an
    array); None for a zero-width block. The JAX package's `summarize`
    schema."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    arr = np.asarray(arr, np.int64)
    if arr.shape[-1] == 0:
        return None
    m = merge(arr)
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
        "incumbent_ring": _ring_pairs(m),
        "pruning_rate": round(float(pruned.sum()) / max(evaluated, 1), 6),
        "frontier_depth": frontier_depth(popped),
    }


# --------------------------------------------------- metrics registry view

# every labelled series `publish` writes
SERIES = (
    "tts_search_popped", "tts_search_branched", "tts_search_pruned",
    "tts_search_bound_gap", "tts_search_pruning_rate",
    "tts_search_frontier_depth", "tts_search_pool_highwater",
    "tts_search_steal_sent", "tts_search_steal_recv",
    "tts_search_improvements",
)


def publish(summary: dict | None, registry, **labels) -> None:
    """Write a `summarize` dict into an `obs/metrics` Registry as gauges
    labelled with `labels` (gauges: the values are set from cumulative
    snapshots, so a resumed checkpoint does not count twice)."""
    if not summary:
        return
    g = registry.gauge
    for name, key in (("tts_search_popped", "popped"),
                      ("tts_search_branched", "branched"),
                      ("tts_search_pruned", "pruned")):
        m = g(name, f"{key} nodes by relative-depth bucket (cumulative)")
        for k, v in enumerate(summary[key]):
            m.set(v, bucket=k, **labels)
    m = g("tts_search_bound_gap",
          "child bound-value histogram by relative gap to the incumbent")
    for k, v in enumerate(summary["bound_hist_pruned"]):
        m.set(v, outcome="pruned", bin=k, **labels)
    for k, v in enumerate(summary["bound_hist_surviving"]):
        m.set(v, outcome="surviving", bin=k, **labels)
    g("tts_search_pruning_rate",
      "pruned / evaluated non-leaf children (cumulative)").set(
        summary["pruning_rate"], **labels)
    g("tts_search_frontier_depth",
      "mean relative depth of popped nodes (0=root, 1=leaves)").set(
        summary["frontier_depth"], **labels)
    g("tts_search_pool_highwater",
      "pool-occupancy high-water mark (live rows)").set(
        summary["pool_highwater"], **labels)
    g("tts_search_steal_sent",
      "nodes donated via balance exchanges").set(
        summary["steal_sent"], **labels)
    g("tts_search_steal_recv",
      "nodes received via balance exchanges").set(
        summary["steal_recv"], **labels)
    g("tts_search_improvements",
      "incumbent improvements recorded on-device").set(
        summary["improvements"], **labels)
