"""The batch-former: the admission queue's megabatch front.

Reproduces `tpu_tree_search/service/batching.py` (`BatchFormer`): the same
groups, closing order and reasons.

Under ``TTS_MEGABATCH`` the scheduler stops popping one request per
free submesh and instead drains the wait line into this former, which
groups requests by their BATCH KEY — problem, instance-table shape,
lb_kind and every engine knob the compiled batched loop specializes on
(chunk, capacity, balance/segment geometry). A group CLOSES (becomes a
dispatchable batch) when it reaches ``TTS_BATCH_MAX`` members or its
oldest member has waited ``TTS_BATCH_AGE_S`` seconds — the classic
size-or-age continuous-batching rule, so a burst of same-class traffic
fills batches immediately while a lone request is delayed by at most
the age bound (and then runs the ordinary solo path as a batch of
one).

The former holds RequestRecords that are already admitted (the queue
popped them); cancellation/deadline while held is handled lazily at
close time, exactly like the queue's stale-head pruning. Priority
ordering is preserved within a group (members keep their heap order)
and across groups (the oldest-member clock breaks ties); the
strict-priority PREEMPTION pass stays a solo-mode feature — megabatch
is the throughput mode, and a batch is not preemptible member-by-member
mid-segment anyway (stops land at segment boundaries for every member
alike).
"""

from __future__ import annotations

import time

from .request import PREEMPTED, QUEUED, RequestRecord


class BatchFormer:
    """Groups admitted requests into closeable batches. NOT thread-safe
    on its own — the server drives it under its scheduler lock, the
    same discipline as every other scheduler structure."""

    def __init__(self, max_size: int, age_s: float):
        if max_size < 1:
            raise ValueError(f"max_size must be >= 1, got {max_size}")
        self.max_size = int(max_size)
        self.age_s = float(age_s)
        # key -> list of (enter_t, RequestRecord), oldest first
        self._groups: dict[tuple, list] = {}

    def __len__(self) -> int:
        # list() snapshot: the depth gauge reads this at scrape time
        # without the scheduler lock; an approximate count during a
        # concurrent offer/close is fine, a RuntimeError is not
        return sum(len(g) for g in list(self._groups.values()))

    def offer(self, key: tuple, rec: RequestRecord) -> None:
        """Hold one popped request under its batch key."""
        self._groups.setdefault(key, []).append((time.monotonic(), rec))

    def _prune(self, group: list) -> list:
        """Drop members that went stale while held (cancelled in line,
        deadline-expired handling is the server's at close time)."""
        return [(t, r) for t, r in group
                if r.state in (QUEUED, PREEMPTED)]

    def _take(self, key: tuple, reason: str
              ) -> tuple[list[RequestRecord], str]:
        """Close up to max_size members off a group (oldest first);
        the remainder stays in line with its entry times."""
        group = self._groups[key]
        batch, rest = group[:self.max_size], group[self.max_size:]
        if rest:
            self._groups[key] = rest
        else:
            del self._groups[key]
        return [r for _, r in batch], reason

    def pop_ready(self, now: float | None = None
                  ) -> tuple[list[RequestRecord], str] | None:
        """The next closeable batch as ``(members, reason)`` — reason
        ``"age"`` (the group's oldest member waited past age_s) or
        ``"size"`` (it hit max_size) — or None when nothing closes
        yet. AGE-ready groups outrank size-ready ones, oldest member
        first: the age bound is a latency promise, size-closure only a
        throughput optimization — sustained traffic in one shape class
        must not starve an aged group of another class indefinitely
        (a size-first rule would, and the starved member's queue-wait
        observation only lands at close, so the SLO could not even see
        it). Every closure trims to max_size (an age-closed group may
        have grown past it between calls)."""
        if now is None:
            now = time.monotonic()
        aged = aged_t = None
        sized = None
        for key in list(self._groups):
            group = self._prune(self._groups[key])
            if not group:
                del self._groups[key]
                continue
            self._groups[key] = group
            oldest = group[0][0]
            if now - oldest >= self.age_s and (
                    aged_t is None or oldest < aged_t):
                aged, aged_t = key, oldest
            elif sized is None and len(group) >= self.max_size:
                sized = key
        if aged is not None:
            return self._take(aged, "age")
        if sized is not None:
            return self._take(sized, "size")
        return None

    def waiting_ids(self) -> list[str]:
        """Held request ids (status snapshots)."""
        return [r.id for g in self._groups.values() for _, r in g]

    def drain(self) -> list[RequestRecord]:
        """Every held live request, surrendered (server shutdown: held
        members must be cancelled or re-queued, never forgotten)."""
        out = [r for g in self._groups.values()
               for _, r in self._prune(g)]
        self._groups.clear()
        return out
