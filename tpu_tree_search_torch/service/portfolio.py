"""Bound-portfolio racing: K sibling configs, one incumbent board,
first proof wins.

Reproduces `tpu_tree_search/service/portfolio.py` (`plan_members`,
`PortfolioCoordinator` and its ``tts_portfolio_*`` series) on the port's
server: the same fan-out order and configurations, the same resolution
rules, the same ledger linkage.

A request submitted with ``portfolio: K`` (K >= 2) does not dispatch
itself. It fans out as K sibling SUB-REQUESTS over DISTINCT
configurations: the problem's bound tiers (``lb_kinds``) first, then
per-tier tuned chunk and balance plans from the Autotuner's cache (never a
probe on the admission path), then chunk variants when tiers run out, all
naming ONE ``share_group``, so on a server with the incumbent board every
sibling's improvements tighten every other sibling's pruning
(`engine/incumbent.py`). The race ends at the FIRST sibling that ends DONE
with a complete proof: the parent finalizes DONE with the winner's result,
and every losing sibling is cancelled through the ordinary member-level
stop path (queued losers finalize CANCELLED at once under the scheduler
lock, so no dispatch follows the proof; running losers get
``stop_reason="cancel"`` and stop at their next segment boundary, like a
user ``cancel()``).

Members flow through the ordinary scheduler. Under megabatching,
same-config siblings stack into one batch through the batch key and the
others close as batches of one onto the solo path; with megabatch off
every member dispatches solo. The parent record is never queued or
dispatched: it finalizes from its members' terminals.

Durability: the parent's admit record carries ``portfolio: K`` in its
payload, and a ``portfolio`` ledger record links parent and member rids
(with the raced configs). Replay rebuilds the race: the parent is admitted
again UNQUEUED, members requeue like any interrupted request, and
``reconcile()`` re-arms the coordinator, resolving at once when a member's
replayed terminal already decides the race.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..obs import tracelog
from . import request as request_mod
from .request import (CANCELLED, DEADLINE, DONE, FAILED,
                      TERMINAL_STATES, SearchRequest)

__all__ = ["plan_members", "PortfolioCoordinator"]


def plan_members(request: SearchRequest, prob, k: int, *,
                 parent_tag: str, tuner=None, n_workers: int = 1
                 ) -> list[tuple[SearchRequest, dict]]:
    """The K raced configurations for one portfolio request.

    Deterministic fan-out order (the fan-out journal and the status
    snapshots rely on it):

    - member 0 is the request's OWN configuration verbatim (its
      ``lb_kind``/``chunk``/``balance_period`` untouched) — the race
      always contains the run the client would have gotten solo, so
      racing can only add information, never lose the baseline;
    - members 1.. cycle the problem's remaining bound tiers
      (``prob.lb_kinds``, plugin order, the request's own tier last in
      the cycle), each resolved through the Autotuner's PER-TIER cache
      entry when one is warm (``allow_probe=False`` — admission never
      probes);
    - when K exceeds the tier count, repeats race chunk variants
      (halved per lap) so no two members share an exact
      ``(lb_kind, chunk, balance_period)`` config.

    Returns ``[(member_request, config_dict), ...]`` where the config
    dict is the JSON-safe description journaled with the race and shown
    in the status snapshots.
    """
    p = np.asarray(request.p_times)
    tiers = [request.lb_kind] + [lb for lb in prob.lb_kinds
                                 if lb != request.lb_kind]
    share = request.share_group or f"pf:{parent_tag}"
    out: list[tuple[SearchRequest, dict]] = []
    seen: set = set()
    for i in range(k):
        lb = tiers[i % len(tiers)]
        if i == 0:
            chunk, period, source = request.chunk, \
                request.balance_period, "request"
        else:
            chunk, period, source = request.chunk, \
                request.balance_period, "request"
            if tuner is not None:
                try:
                    params = tuner.resolve(
                        int(p.shape[1]), int(p.shape[0]), lb,
                        n_workers=n_workers, allow_probe=False,
                        problem=request.problem)
                    chunk, period = params.chunk, params.balance_period
                    source = params.source
                except Exception as e:  # noqa: BLE001 — tuning is an
                    # optimization; the member races the request knobs
                    tracelog.event("portfolio.tune_failed",
                                   lb_kind=lb, error=repr(e))
        # distinct-config guarantee: a duplicate (lb, chunk, period)
        # would race itself — vary the chunk (halved) until unique
        key, bump = (lb, chunk, period), 0
        while key in seen and bump < 16:
            bump += 1
            base = chunk if chunk else 1 << 15
            chunk = max(1, base // 2)
            key = (lb, chunk, period)
        seen.add(key)
        mreq = dataclasses.replace(
            request, lb_kind=lb, chunk=chunk, balance_period=period,
            portfolio=None, share_group=share,
            tag=f"{parent_tag}.pf{i}")
        out.append((mreq, {"lb_kind": int(lb),
                           "chunk": None if chunk is None else int(chunk),
                           "balance_period": None if period is None
                           else int(period),
                           "source": source,
                           "tag": mreq.tag}))
    return out


class _Race:
    __slots__ = ("parent_rid", "member_rids")

    def __init__(self, parent_rid: str, member_rids: list):
        self.parent_rid = parent_rid
        self.member_rids = list(member_rids)


class PortfolioCoordinator:
    """Parent/member race bookkeeping for one SearchServer.

    Every method is called WITH the server's scheduler lock held (it is
    an RLock, so the reentrant ``_finalize`` -> hook -> ``_finalize``
    chains a race resolution produces are safe). The coordinator never
    touches slots or the queue directly — losers cancel through the
    server's own terminal/stop machinery, so the member lifecycle stays
    byte-for-byte the ordinary request lifecycle.
    """

    def __init__(self, server):
        self.server = server
        self.races: dict[str, _Race] = {}   # parent rid -> race
        self._m_races = server.metrics.counter(
            "tts_portfolio_races_total",
            "portfolio races by outcome (won/deadline/cancelled/failed)")
        self._m_members = server.metrics.counter(
            "tts_portfolio_members_total",
            "portfolio members by terminal role")
        server.metrics.gauge(
            "tts_portfolio_active",
            "portfolio races currently unresolved"
            ).set_fn(lambda: sum(
                1 for rid in self.races
                if (r := server.records.get(rid)) is not None
                and r.state not in TERMINAL_STATES))

    # ----------------------------------------------------------- fan-out

    def register(self, parent_rec, members: list) -> None:
        """Arm the race after fan-out (``members`` =
        ``[(rid, config), ...]`` in fan-out order), then resolve
        immediately if it is already decided — an idempotently
        re-served DONE member (a resubmitted tag family) wins on the
        spot."""
        parent_rec.portfolio_members = [rid for rid, _ in members]
        self.races[parent_rec.id] = _Race(parent_rec.id,
                                          parent_rec.portfolio_members)
        tracelog.event("portfolio.fanout", request_id=parent_rec.id,
                       k=len(members),
                       members=[{"rid": rid, **cfg}
                                for rid, cfg in members])
        self._try_resolve(parent_rec)

    # ------------------------------------------------------ terminal hooks
    # (called from SearchServer._finalize, lock held)

    def on_member_terminal(self, rec) -> None:
        parent = self.server.records.get(rec.portfolio_parent or "")
        if parent is None or parent.portfolio_members is None:
            return
        if rec.state == CANCELLED:
            parent.portfolio_cancelled += 1
        self._m_members.inc(role=self._role(parent, rec))
        self._try_resolve(parent)

    def on_parent_terminal(self, parent_rec) -> None:
        """The parent just finalized (a won race, a user ``cancel()``,
        a no-ledger ``close()`` sweep, an all-members-terminal
        resolution): any still-live member is a loser — cancel it
        through the ordinary member-level stop path."""
        cancelled = self._cancel_live_members(
            parent_rec, but=parent_rec.portfolio_winner)
        if parent_rec.state == DONE:
            tracelog.event(
                "portfolio.win", request_id=parent_rec.id,
                winner=parent_rec.portfolio_winner,
                config=parent_rec.portfolio_config,
                cancelled=cancelled,
                best=(int(parent_rec.result.best)
                      if parent_rec.result is not None else None))
        self._m_races.inc(outcome={
            DONE: "won", DEADLINE: "deadline",
            CANCELLED: "cancelled"}.get(parent_rec.state, "failed"))

    # ---------------------------------------------------------- recovery

    def reconcile(self) -> None:
        """Post-replay sweep (ledger boot): re-arm every replayed race
        and resolve the ones the crash interrupted mid-decision — a
        winner whose DONE landed before the kill decides now; members
        of an already-terminal parent (their cancel never landed)
        cancel now instead of re-running a finished race."""
        for rec in list(self.server.records.values()):
            if rec.portfolio_members is None:
                continue
            self.races.setdefault(
                rec.id, _Race(rec.id, rec.portfolio_members))
            if rec.state in TERMINAL_STATES:
                n = self._cancel_live_members(
                    rec, but=rec.portfolio_winner)
                if n:
                    tracelog.event("portfolio.reconciled",
                                   request_id=rec.id, cancelled=n)
            else:
                self._try_resolve(rec)

    # ---------------------------------------------------------- internals

    def _members(self, parent_rec):
        return [self.server.records[rid]
                for rid in parent_rec.portfolio_members or []
                if rid in self.server.records]

    def _role(self, parent, rec) -> str:
        if rec.id == parent.portfolio_winner:
            return "winner"
        return {DONE: "lost_done", CANCELLED: "lost_cancelled",
                DEADLINE: "lost_deadline"}.get(rec.state, "lost_failed")

    def _cancel_live_members(self, parent_rec, but: str | None) -> int:
        n = 0
        for mrec in self._members(parent_rec):
            if mrec.id == but or mrec.state in TERMINAL_STATES:
                continue
            n += 1
            if mrec.state == request_mod.RUNNING:
                if mrec.stop_reason is None:
                    mrec.stop_reason = "cancel"
                self.server._stop_slot_of(mrec)
            else:
                # QUEUED/PREEMPTED: terminal right here, under the
                # scheduler lock — it can never dispatch post-proof
                self.server._finalize(
                    mrec, CANCELLED,
                    error=f"portfolio: lost race {parent_rec.id}")
        return n

    def _try_resolve(self, parent_rec) -> None:
        """Decide the race if it is decidable (lock held). First DONE
        member wins; with every member terminal and none DONE the
        parent inherits the least-bad outcome (DEADLINE beats
        CANCELLED beats FAILED) and the best partial result."""
        if parent_rec.state in TERMINAL_STATES:
            return
        members = self._members(parent_rec)
        winner = next((m for m in members if m.state == DONE), None)
        if winner is not None:
            parent_rec.portfolio_winner = winner.id
            parent_rec.portfolio_config = winner.portfolio_config
            parent_rec.result = winner.result
            # _finalize fires on_parent_terminal -> losers cancel
            self.server._finalize(parent_rec, DONE)
            return
        if any(m.state not in TERMINAL_STATES for m in members) \
                or not members:
            return
        with_result = [m for m in members if m.result is not None]
        if with_result:
            best = min(with_result, key=lambda m: int(m.result.best))
            parent_rec.result = best.result
            parent_rec.portfolio_config = best.portfolio_config
        if any(m.state == DEADLINE for m in members):
            state, err = DEADLINE, None
        elif all(m.state == CANCELLED for m in members):
            state, err = CANCELLED, None
        else:
            state = FAILED
            err = ("portfolio: no member completed ("
                   + ", ".join(f"{m.id}={m.state}" for m in members)
                   + ")")
        self.server._finalize(parent_rec, state, error=err)
