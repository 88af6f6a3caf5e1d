"""Chunk-ladder execution: pool-aware rung selection for the segmented
multi-worker driver.

Reproduces `tpu_tree_search/engine/ladder.py`: the rung constants,
`min_rung_for`, `rungs_for`, `_profile_rows`, `rungs_from_profile`,
`fused_for`, `set_memory_pressure`/`memory_pressure` and
`RungController`, host code only.

A chunk is best in the filled middle of a search; ramp-up and drain pop
underfilled chunks, and every such step pays for chunk-wide bounds of
parents that are not there. The ladder keeps 2-3 chunk rungs, each its
own `_DistDriver` (on a card, its own captured CUDA graph of a
macro-iteration), and switches rung only at segment boundaries, from the
pool occupancy the per-segment counter read already carries.

- Every rung's driver is built under one usable-row limit, the minimum
  over the rungs (`engine/distributed._ladder_plan`), so a state committed
  by any rung is in bounds for every other and a switch in either
  direction never writes a block over live rows.
- A rung only picks which driver runs a segment: pools, counters and the
  incumbent ride the same states, so the node accounting is exact across
  switches; with a fixed incumbent (ub=opt) the explored tree is the
  fixed-chunk driver's.
- `TTS_LADDER` is static: off (the default) is the single-driver path.
- The live rung rides the checkpoint meta (`ladder_rung`); a resume
  starts on it.

Observability: `tts_ladder_switches_total{direction=up|down}` in the
process-wide registry and the `ladder.start` / `ladder.switch` events.
"""

from __future__ import annotations

import threading

from ..obs import metrics as obs_metrics
from ..obs import tracelog

__all__ = ["RungController", "rungs_for", "min_rung_for",
           "rungs_from_profile", "fused_for",
           "set_memory_pressure", "memory_pressure",
           "LADDER_FACTOR", "LADDER_RUNGS", "LADDER_MIN_CHUNK",
           "LADDER_MIN_CHUNK_LB2"]

# process-wide memory-pressure hint: under it the controller holds the
# smallest covering rung (no ramp-momentum bump), which pops exactly what
# the top rung would, so the counts do not change
_MEM_PRESSURE = threading.Event()


def set_memory_pressure(on: bool) -> None:
    """Raise or clear the demote-the-ladder hint."""
    if on:
        _MEM_PRESSURE.set()
    else:
        _MEM_PRESSURE.clear()


def memory_pressure() -> bool:
    return _MEM_PRESSURE.is_set()


# LADDER_RUNGS rungs, each LADDER_FACTOR x the previous, topped by the
# tuned chunk; rungs below the floor collapse into it, so chunk <= floor *
# FACTOR gives one rung and the plain driver. The floors are the JAX
# package's (LB2 256, the cheap bounds 64), not measured on the H100.
LADDER_FACTOR = 4
LADDER_RUNGS = 3
LADDER_MIN_CHUNK = 64
LADDER_MIN_CHUNK_LB2 = 256


def min_rung_for(lb_kind: int) -> int:
    """The per-bound rung floor."""
    return LADDER_MIN_CHUNK_LB2 if lb_kind == 2 else LADDER_MIN_CHUNK


def rungs_for(chunk: int, n_rungs: int = LADDER_RUNGS,
              factor: int = LADDER_FACTOR,
              min_chunk: int = LADDER_MIN_CHUNK) -> tuple[int, ...]:
    """The ascending rung chunks under (and including) `chunk`."""
    chunk = int(chunk)
    rungs = {max(min_chunk, chunk // factor ** k)
             for k in range(n_rungs)}
    return tuple(sorted(min(r, chunk) for r in rungs))


def _profile_rows(profile) -> dict:
    """A per-rung profile (`Params.rung_modes`) as a chunk-keyed dict;
    malformed rows are dropped (a stale entry degrades to the static
    floors, never raises)."""
    rows = {}
    for r in (profile or ()):
        try:
            rows[int(r["chunk"])] = r
        except (TypeError, KeyError, ValueError):
            continue
    return rows


def _selected_ms(chunk: int, row: dict, profile, fused_mode: str):
    """The probed ms per iteration of the route this run would take on the
    rung (`fused_for`'s choice), not the winner's. A present but None
    fused field means the rung's fused probe failed: None, and the caller
    refuses the rung (or, for the top row, falls back to the floors)."""
    if fused_for(chunk, profile, fused_mode) == "off":
        return row.get("ms_per_iter_unfused") or row.get("ms_per_iter")
    if "ms_per_iter_fused" in row:
        return row["ms_per_iter_fused"]
    return row.get("ms_per_iter")          # rows without per-route fields


def rungs_from_profile(chunk: int, profile,
                       n_rungs: int = LADDER_RUNGS,
                       factor: int = LADDER_FACTOR,
                       fused_mode: str = "off"
                       ) -> tuple[int, ...] | None:
    """Measured rung admission: a candidate rung joins iff its probed ms
    per iteration on the route this run takes beats the top rung's. None
    (the caller falls back to the static floors) when the profile does not
    cover the top rung."""
    rows = _profile_rows(profile)
    chunk = int(chunk)
    top = rows.get(chunk)
    if top is None:
        return None
    top_ms = _selected_ms(chunk, top, profile, fused_mode)
    if not top_ms:
        return None
    rungs = {chunk}
    for k in range(1, n_rungs):
        c = max(1, chunk // factor ** k)
        row = rows.get(c)
        if row is None:
            continue
        ms = _selected_ms(c, row, profile, fused_mode)
        if ms and ms < top_ms:
            rungs.add(c)
    return tuple(sorted(rungs))


def fused_for(chunk: int, profile, fused_mode: str) -> str:
    """A rung's fused mode: `fused_mode` (the run's, `ops/fused.
    resolve_mode`), sent back to "off" only where the profile covers the
    rung, its winner is "unfused" and its fused route was measured
    (`evals_per_s_fused` recorded). A profile never turns the fused route
    on; either way the counts are the same."""
    if fused_mode == "off":
        return "off"
    row = _profile_rows(profile).get(int(chunk))
    if (row is not None and row.get("winner") == "unfused"
            and row.get("evals_per_s_fused") is not None):
        return "off"
    return fused_mode


class RungController:
    """Owns the live rung: the segmented driver's `run_fn` asks it for the
    current rung's driver, and the heartbeat feeds it each segment's pool
    size."""

    def __init__(self, drivers: dict[int, object], n_workers: int):
        self.chunks = tuple(sorted(drivers))
        self.drivers = drivers
        self.n_workers = max(int(n_workers), 1)
        self.idx = len(self.chunks) - 1          # start on the top rung
        self.switches = {"up": 0, "down": 0}
        self._last_pool: int | None = None
        self._switch_c = obs_metrics.default().counter(
            "tts_ladder_switches_total",
            "chunk-ladder rung switches at segment boundaries")

    @property
    def current_chunk(self) -> int:
        return self.chunks[self.idx]

    def driver(self):
        return self.drivers[self.current_chunk]

    def start(self, pool_total: int, meta_rung: int | None = None) -> None:
        """Pick the first rung: the checkpoint's recorded rung on a resume
        (`meta_rung`), else from the seeded pools' occupancy."""
        if meta_rung is not None and int(meta_rung) in self.chunks:
            self.idx = self.chunks.index(int(meta_rung))
            source = "meta"
        else:
            self.idx = self._target(pool_total)
            source = "occupancy"
        self._last_pool = int(pool_total)
        tracelog.event("ladder.start", rung=self.current_chunk,
                       rungs=list(self.chunks), pool=int(pool_total),
                       source=source)

    def observe(self, pool_total: int, segment: int | None = None) -> None:
        """Feed one segment boundary's pool size; may switch the rung of
        the next dispatch."""
        target = self._target(pool_total)
        if (self._last_pool is not None
                and pool_total > 2 * max(self._last_pool, 1)
                and not memory_pressure()):
            # ramp momentum: the pool more than doubled in the segment, so
            # the boundary's size is already stale: one rung above covering
            target = min(target + 1, len(self.chunks) - 1)
        self._last_pool = int(pool_total)
        if target == self.idx:
            return
        direction = "up" if target > self.idx else "down"
        self.switches[direction] += 1
        tracelog.event("ladder.switch",
                       frm=self.current_chunk,
                       to=self.chunks[target],
                       direction=direction, segment=segment,
                       pool=int(pool_total))
        self._switch_c.inc(direction=direction)
        self.idx = target

    def _target(self, pool_total: int) -> int:
        """The smallest rung that covers the per-worker pool (the top rung
        when none does). A covering rung pops what the top rung would, so
        the iteration count never grows against the fixed-chunk driver."""
        per_worker = pool_total / self.n_workers
        for i, c in enumerate(self.chunks):
            if c >= per_worker:
                return i
        return len(self.chunks) - 1

    def snapshot(self) -> dict:
        return {"rungs": list(self.chunks),
                "current": self.current_chunk,
                "switches": dict(self.switches)}
