"""Bounded priority queue with admission control.

Reproduces `tpu_tree_search/service/queueing.py` (`AdmissionError`,
`AdmissionPaused`, `RequestQueue`): the same pop order, bound and
counters.

The wait line in front of the scheduler: higher `priority` pops first,
FIFO within a priority level (submission sequence breaks ties, and a
preempted request keeps its original sequence number so preemption does
not send it to the back of its class). Depth is bounded — a full queue
REJECTS new work with a reason (`AdmissionError`) instead of buffering
unboundedly, which is what separates a server under load from a server
that falls over: the client learns immediately and can back off,
re-prioritize, or go elsewhere.

Requeued (preempted) entries do not count against the admission bound —
they were already admitted; bouncing them on re-entry would turn
preemption into silent request loss.
"""

from __future__ import annotations

import heapq
import threading
import time

from .request import PREEMPTED, QUEUED, RequestRecord


class AdmissionError(RuntimeError):
    """Request rejected at the door; `.reason` says why."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class AdmissionPaused(AdmissionError):
    """Rejected because the remediation tier is holding admission
    paused (a TEMPORARY valve, e.g. a compile storm). Typed, not a
    string protocol: the spool front-end must HOLD its backlog on this
    and only this rejection — matching on the message wording would
    turn a future rewording into silent backlog loss."""


class RequestQueue:
    """Thread-safe bounded max-priority queue of RequestRecords.

    Entries whose state is no longer QUEUED/PREEMPTED (cancelled while
    waiting, deadline-expired in line) are dropped lazily at pop time —
    cancellation never has to hunt through the heap.
    """

    def __init__(self, max_depth: int):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        self._lock = threading.Lock()
        self._heap: list[tuple[int, int, RequestRecord]] = []
        # guarded-by: self._lock
        self.rejected = 0          # admission-control rejections (stats)
        self.peak_depth = 0        # high-water mark since construction —
                                   # the capacity-planning number a
                                   # point-in-time depth gauge misses

    def _prune(self) -> None:
        # drop stale heads (cancelled/expired while queued)
        while self._heap and self._heap[0][2].state not in (QUEUED,
                                                            PREEMPTED):
            heapq.heappop(self._heap)

    def _depth(self) -> int:
        """Waiting entries (caller holds the lock) — THE definition of
        queue depth, shared by __len__/admit/requeue so the admission
        bound and the peak-depth stat cannot diverge."""
        return sum(1 for _, _, r in self._heap
                   if r.state in (QUEUED, PREEMPTED))

    def __len__(self) -> int:
        with self._lock:
            self._prune()
            return self._depth()

    def admit(self, rec: RequestRecord) -> None:
        """Admit a NEW request; raises AdmissionError when full."""
        with self._lock:
            self._prune()
            depth = self._depth()
            if depth >= self.max_depth:
                self.rejected += 1
                raise AdmissionError(
                    f"queue full: depth {depth} at the admission bound "
                    f"{self.max_depth}; retry later or raise the bound")
            rec.queued_t = time.monotonic()
            heapq.heappush(self._heap,
                           (-rec.request.priority, rec.seq, rec))
            self.peak_depth = max(self.peak_depth, depth + 1)

    def requeue(self, rec: RequestRecord) -> None:
        """Put a preempted/re-dispatched request back in line.
        Bypasses the admission bound (the request was already admitted)."""
        with self._lock:
            rec.queued_t = time.monotonic()
            heapq.heappush(self._heap,
                           (-rec.request.priority, rec.seq, rec))
            self.peak_depth = max(self.peak_depth, self._depth())

    def observe_backlog(self, held: int) -> None:
        """Fold externally-held waiting work into the peak-depth
        high-water mark — the megabatch scheduler drains the heap into
        its batch-former every tick, so the heap alone would record a
        near-zero peak while the real wait line lives in the former."""
        with self._lock:
            self._prune()
            self.peak_depth = max(self.peak_depth,
                                  self._depth() + int(held))

    def pop_best(self, eligible=None) -> RequestRecord | None:
        """Highest-priority waiting request, or None if empty.

        `eligible` (optional predicate over the record) lets the
        scheduler pop per SLOT: the best request whose excluded-submesh
        set allows the slot in hand, with every skipped (higher-
        priority but ineligible) entry left in line at its original
        position. With no predicate — or all-empty exclusion sets, the
        TTS_REMEDIATE=0 default — this is exactly the old
        highest-priority pop."""
        with self._lock:
            self._prune()
            if eligible is None:
                if not self._heap:
                    return None
                return heapq.heappop(self._heap)[2]
            skipped = []
            found = None
            while self._heap:
                entry = heapq.heappop(self._heap)
                if entry[2].state not in (QUEUED, PREEMPTED):
                    continue        # stale (cancelled/expired in line)
                if eligible(entry[2]):
                    found = entry[2]
                    break
                skipped.append(entry)
            for entry in skipped:
                heapq.heappush(self._heap, entry)
            return found

    def best_priority(self) -> int | None:
        """Priority of the head of the line (None if empty) — the
        scheduler's preemption trigger."""
        with self._lock:
            self._prune()
            return (self._heap[0][2].request.priority
                    if self._heap else None)

    def peek_best(self) -> RequestRecord | None:
        """The head of the line WITHOUT popping it — the scheduler's
        preemption pass needs the record itself (its excluded-submesh
        set decides whether a free slot actually helps it)."""
        with self._lock:
            self._prune()
            return self._heap[0][2] if self._heap else None

    def count_priority_above(self, priority: int) -> int:
        """How many waiting requests outrank `priority` — the
        scheduler's bound on how many preemptions are justified."""
        with self._lock:
            self._prune()
            return sum(1 for _, _, r in self._heap
                       if r.state in (QUEUED, PREEMPTED)
                       and r.request.priority > priority)

    def waiting_ids(self) -> list[str]:
        """Queued request ids in pop order (status snapshots)."""
        with self._lock:
            self._prune()
            return [r.id for _, _, r in sorted(self._heap)
                    if r.state in (QUEUED, PREEMPTED)]
