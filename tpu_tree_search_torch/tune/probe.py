"""Warmed probe runner: one harness for every dispatch-knob sweep.

Reproduces `tpu_tree_search/tune/probe.py` (`ProbeResult`, `ProbeError`,
`ProbeHarness`, `measure_balance_periods`) with its method: warm a real
pool past the ramp once, then time the multi-worker driver for each
candidate configuration on the identical warmed state over an identical
iteration window, best of N wall times. The score is bound evaluations
per wall second, which stays comparable across chunks.

Here the program timed is `distributed._problem_driver` on one worker: on
the card a macro-iteration is one captured CUDA graph (`_DistDriver`),
whose key holds the pools' addresses. So the harness keeps one working
state beside the warmed one and copies the warmed pools into it before
every call, outside the timed window: the first call captures the
candidate's graph and is not timed, and each repeat replays it from the
same state. Every call must give the same counts. A candidate's graph is
dropped once it has been measured.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..engine import device as dev_mod, distributed
from ..engine.device import COUNTER_DTYPES

__all__ = ["ProbeHarness", "ProbeResult", "ProbeError",
           "measure_balance_periods"]


class ProbeError(RuntimeError):
    """The harness could not produce a steady measurement state (the
    instance exhausted or overflowed inside the warm-up), or a candidate
    leaves no usable rows. Callers fall back to the defaults tier."""


@dataclasses.dataclass
class ProbeResult:
    """One candidate's measurement."""

    chunk: int
    balance_period: int
    transfer_cap: int
    evals_per_s: float
    ms_per_iter: float
    window_iters: int
    evals: int
    seconds: float          # best-of-repeats wall time of the window
    pool_start: int         # live rows when the window began
    underfilled: bool       # pool < chunk at the window's start: a ramp
    #                         rate, which the tuner ranks below the others
    fused: str = "off"      # the fused mode the candidate ran under
    #                         (ops/fused: "off", "hw", "interpret")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class ProbeHarness:
    """Warm once per (instance, bound), measure many candidates on the
    identical state, on one worker on `device` (the card unless the
    caller passes "cpu").

    `problem` (a registry name or a plugin, default "pfsp") gives the
    pool's root and aux rows, the warm-up's step and every candidate's
    (`Problem.make_step`). `p_times` is the problem's 2-D instance
    table."""

    def __init__(self, p_times: np.ndarray, lb_kind: int = 1,
                 init_ub: int | None = None, capacity: int = 1 << 18,
                 warm_chunk: int | None = None, warm_iters: int = 200,
                 window_iters: int = 24, repeats: int = 2,
                 problem="pfsp", device="cuda"):
        if isinstance(problem, str):
            from .. import problems as problems_pkg
            problem = problems_pkg.get(problem)
        self.problem = problem
        self.device = dev_mod.resolve_device(device)
        self.p_times = np.asarray(p_times)
        self.jobs = int(problem.slots(self.p_times))
        self.machines = int(problem.aux_rows(self.p_times))
        self.lb_kind = int(lb_kind)
        self.capacity = int(capacity)
        self.window_iters = int(window_iters)
        self.repeats = max(1, int(repeats))
        self._adt = problem.aux_dtype(self.p_times)

        warm_chunk = int(warm_chunk or 64)
        tables = problem.make_tables(self.p_times, device=self.device)
        prmu0, depth0 = problem.root(self.p_times)
        state = dev_mod.init_state(
            self.jobs, self.capacity, init_ub, prmu0=prmu0, depth0=depth0,
            aux0=problem.seed_aux(self.p_times, prmu0, depth0),
            aux_dtype=self._adt, device=self.device)
        state = dev_mod.run_problem(problem, tables, state, self.lb_kind,
                                    warm_chunk, max_iters=warm_iters,
                                    fused="off")
        c = dev_mod.counters(state)
        if c.overflow or c.size == 0:
            raise ProbeError(
                f"warm-up left no steady state to measure "
                f"(pool={c.size}, overflow={c.overflow}) — instance "
                "exhausts or overflows within the warm-up window")
        self.pool = c.size
        self.iters0 = c.iters
        self._evals0 = c.evals
        # on the device, beside the working pools the timed calls run on:
        # a host copy would re-upload the pool inside every window
        self._warm = state
        self._work = state._replace(prmu=state.prmu.clone(),
                                    depth=state.depth.clone(),
                                    aux=state.aux.clone())

    def _reset(self):
        """The working state as the warm-up left it (pools copied in place,
        counters fresh), synchronized so no copy runs inside a window."""
        w, s = self._work, self._warm
        w.prmu.copy_(s.prmu)
        w.depth.copy_(s.depth)
        w.aux.copy_(s.aux)
        state = w._replace(**{f: getattr(s, f).clone()
                              for f in COUNTER_DTYPES},
                           telemetry=s.telemetry.clone())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return state

    def measure(self, chunk: int, balance_period: int,
                transfer_cap: int | None = None,
                min_transfer: int | None = None,
                fused: str = "off") -> ProbeResult:
        """Time one candidate configuration on the warmed state. `fused`
        is the step's fused mode (`ops/fused`), so one rung can be
        measured once per pipeline on the same state."""
        chunk = int(chunk)
        balance_period = int(balance_period)
        if transfer_cap is None:
            transfer_cap = distributed.default_transfer_cap(
                chunk, self.jobs, self.machines, 1,
                aux_itemsize=self._adt.itemsize)
        min_transfer = int(min_transfer or 2 * chunk)
        limit = min(self.problem.usable_rows(self.capacity, chunk,
                                             self.jobs),
                    self.capacity - transfer_cap)
        if limit < 1:
            raise ProbeError(
                f"chunk {chunk} leaves no usable rows at capacity "
                f"{self.capacity} (limit={limit}); raise the harness "
                "capacity or drop the candidate")
        drv = distributed._problem_driver(
            self.problem, [self.device], self.p_times, self.lb_kind, chunk,
            balance_period, transfer_cap, min_transfer, fused=fused)
        ceiling = self.iters0 + self.window_iters

        def call():
            states = [self._reset()]
            t0 = time.perf_counter()
            out, _ = drv._drive(states, ceiling, self.capacity)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            seconds = time.perf_counter() - t0
            c = dev_mod.counters(out[0])
            return (c.evals - self._evals0, c.iters - self.iters0), seconds

        try:
            counts, _ = call()           # captures the graph, warms
            best = float("inf")
            for _ in range(self.repeats):
                again, seconds = call()
                if again != counts:
                    raise RuntimeError(
                        f"probe chunk {chunk}: a repeat from the same "
                        f"state counted {again}, the first {counts}")
                best = min(best, seconds)
        finally:
            dev_mod._GRAPHS.pop(drv._graph_key([self._work], self.capacity),
                                None)
        evals, iters = counts
        return ProbeResult(
            chunk=chunk, balance_period=balance_period,
            transfer_cap=int(transfer_cap),
            evals_per_s=round(evals / best, 1) if best > 0 else 0.0,
            ms_per_iter=round(best / max(iters, 1) * 1e3, 4),
            window_iters=iters, evals=evals, seconds=round(best, 6),
            pool_start=self.pool, underfilled=self.pool < chunk,
            fused=fused)


def measure_balance_periods(p_times: np.ndarray, lb_kind: int,
                            chunk: int, periods, capacity: int = 1 << 22,
                            warm_iters: int = 500,
                            window_iters: int = 256,
                            repeats: int = 3,
                            init_ub: int | None = None,
                            device="cuda") -> list[dict]:
    """The balance-period sweep: one dict per period with `ms_per_iter`
    and the harness's evals/s, every period on the same warmed state."""
    h = ProbeHarness(p_times, lb_kind=lb_kind, init_ub=init_ub,
                     capacity=capacity, warm_chunk=chunk,
                     warm_iters=warm_iters, window_iters=window_iters,
                     repeats=repeats, device=device)
    rows = []
    for period in periods:
        r = h.measure(chunk, period)
        rows.append({"balance_period": int(period),
                     "ms_per_iter": r.ms_per_iter,
                     "evals_per_s": r.evals_per_s})
    return rows
