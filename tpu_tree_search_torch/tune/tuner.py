"""Offline autotuner: probe the dispatch ladder once, replay forever.

Reproduces `tpu_tree_search/tune/tuner.py`: `Autotuner` with the same
candidate ladders (`CHUNK_CANDIDATES_DEFAULT`, `PERIOD_CANDIDATES_DEFAULT`),
key (`key`), three-tier resolution (`resolve`: memo, then the cache, then a
probe where allowed, then `defaults.params_for`), sweep (`tune`: every
chunk candidate at the default period, on both pipelines where the fused
route is on; filled candidates outrank underfilled ones; a candidate is
judged by the better of its pipelines; the period sweep on the winning
pipeline; the winner's ladder rungs probed for `rung_modes` when there is
a pipeline choice or TTS_TUNE_RUNGS is set), payload, probe ledger,
`snapshot`, the metrics `tts_tuner_probes_total` and
`tts_tuner_probe_seconds` and the `tuner.*` span and events.

The fused mode is the port's own: `fused.resolve_mode(None, on_cuda=...)`
is "hw" on the card and "off" on the CPU. So the key's `("fused", mode)`
suffix and the sweep's second pipeline follow the device the tuner probes
on (`device`, the card unless the caller passes "cpu"), and a cache
entry probed on the card is never replayed on the CPU's key, nor the
other way round.

Consumed by `distributed.search(chunk=None, tuner=...)`.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from ..obs import tracelog
from ..ops import fused as fz
from . import defaults
from .cache import TuningCache
from .defaults import Params
from .probe import ProbeError, ProbeHarness

__all__ = ["Autotuner"]

# the chunk sweep's candidates (powers of two; TTS_TUNE_CHUNKS overrides,
# e.g. "64,256,1024")
CHUNK_CANDIDATES_DEFAULT = (256, 1024, 4096, 16384, 65536)
# balance periods swept at the winning chunk
PERIOD_CANDIDATES_DEFAULT = (1, 4, 16)


class Autotuner:
    """Cache -> probe -> defaults resolution of the dispatch knobs.

    `cache_dir` enables the persistent tier; without it the tuner still
    probes (results memoized in the process) and still falls back to the
    defaults table. The probe knobs have environment overrides
    (TTS_TUNE_CHUNKS, TTS_TUNE_PERIODS, TTS_TUNE_WINDOW, TTS_TUNE_WARM).
    `device` is where the probes run and whose fused mode keys the
    entries."""

    def __init__(self, cache_dir: str | os.PathLike | None = None,
                 registry=None, fingerprint_extra: dict | None = None,
                 chunks: tuple | None = None, periods: tuple | None = None,
                 window_iters: int | None = None,
                 warm_iters: int | None = None,
                 capacity: int | None = None, repeats: int = 2,
                 device="cuda"):
        from ..utils import config as _cfg
        self.device = torch.device(device)
        self.cache = (TuningCache(cache_dir, registry=registry,
                                  fingerprint_extra=fingerprint_extra,
                                  device=self.device)
                      if cache_dir else None)
        self.chunks = tuple(chunks) if chunks else _cfg.env_ints(
            "TTS_TUNE_CHUNKS", CHUNK_CANDIDATES_DEFAULT)
        self.periods = tuple(periods) if periods else _cfg.env_ints(
            "TTS_TUNE_PERIODS", PERIOD_CANDIDATES_DEFAULT)
        self.window_iters = int(window_iters
                                or _cfg.env_int("TTS_TUNE_WINDOW")
                                or _cfg.TUNE_WINDOW_ITERS_DEFAULT)
        self.warm_iters = int(warm_iters
                              or _cfg.env_int("TTS_TUNE_WARM")
                              or _cfg.TUNE_WARM_ITERS_DEFAULT)
        self.capacity = int(capacity or 1 << 18)
        self.repeats = int(repeats)
        self.probes_run = 0          # guarded-by: self._lock (probe
        #                              executions in this lifetime)
        self.ledger: list[dict] = []  # guarded-by: self._lock (one record
        #                               per probe execution)
        self._memo: dict[tuple, Params] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._probes_c = self._probe_h = None
        if registry is not None:
            self._probes_c = registry.counter(
                "tts_tuner_probes_total",
                "warmed probe executions (candidate measurements)")
            self._probe_h = registry.histogram(
                "tts_tuner_probe_seconds",
                "wall seconds per tuning sweep (all candidates of one "
                "shape)")

    @staticmethod
    def key(jobs: int, machines: int, lb_kind: int, n_workers: int,
            problem: str = "pfsp", batch: int | None = None,
            device="cuda") -> tuple:
        """The JAX package's key: the problem name leads; a batched
        dispatch (batch > 1) appends ("batch", B); a fused mode other than
        "off" on `device` appends ("fused", mode) for a problem with a
        fused pipeline (`supports_fused`) only, since one without measures
        the same rates either way."""
        base = (str(problem), int(jobs), int(machines), int(lb_kind),
                int(n_workers))
        if batch is not None and int(batch) > 1:
            base = base + ("batch", int(batch))
        mode = fz.resolve_mode(None,
                               on_cuda=torch.device(device).type == "cuda")
        if mode != "off":
            from ..problems import get as _get_problem
            try:
                fused_capable = getattr(_get_problem(str(problem)),
                                        "supports_fused", False)
            except KeyError:
                fused_capable = False
            if fused_capable:
                base = base + ("fused", mode)
        return base

    def resolve(self, jobs: int, machines: int, lb_kind: int = 1,
                n_workers: int = 1, allow_probe: bool = False,
                p_times: np.ndarray | None = None,
                context: str = "serving", problem: str = "pfsp",
                batch: int | None = None, device=None) -> Params:
        """The three-tier lookup. `allow_probe=False` is the hot path
        (cache, else defaults: it never probes); `allow_probe=True` is the
        boot path (cache, else probe and persist, else defaults). A probe
        without `p_times` is PFSP-only (the synthetic table is a PFSP
        generator). `batch` keys its own entries and defaults row, and
        never probes (the harness is solo-only). `device` is where the
        resolved knobs will run (default: where this tuner probes); a
        device of another type raises, since the entries are keyed by
        the probing device's fused mode and pinned to its hardware."""
        if device is not None and torch.device(device).type \
                != self.device.type:
            raise ValueError(
                f"this tuner probes on {self.device.type!r} and keys its "
                f"entries by that device; it cannot resolve the knobs of "
                f"a run on {torch.device(device).type!r} (make the tuner "
                f"with device={torch.device(device).type!r})")
        key = self.key(jobs, machines, lb_kind, n_workers, problem,
                       batch=batch, device=self.device)
        if batch is not None and batch > 1:
            allow_probe = False
        with self._lock:
            memo = self._memo.get(key)
        if memo is not None:
            return memo
        if self.cache is not None:
            entry = self.cache.load(key)
            if entry is not None:
                rm = entry.get("rung_modes")
                params = Params(chunk=int(entry["chunk"]),
                                balance_period=int(entry["balance_period"]),
                                transfer_cap=entry.get("transfer_cap"),
                                source="cache",
                                evals_per_s=entry.get("evals_per_s"),
                                rung_modes=tuple(rm) if rm else None)
                with self._lock:
                    self._memo[key] = params
                return params
        if allow_probe:
            try:
                return self.tune(jobs, machines, lb_kind=lb_kind,
                                 n_workers=n_workers, p_times=p_times,
                                 problem=problem)
            except ProbeError as e:
                tracelog.event("tuner.probe_failed", jobs=jobs,
                               machines=machines, lb_kind=lb_kind,
                               problem=problem, error=repr(e))
        return defaults.params_for(context, jobs, machines,
                                   problem=problem, batch=batch)

    def tune(self, jobs: int, machines: int, lb_kind: int = 1,
             n_workers: int = 1, p_times: np.ndarray | None = None,
             problem: str = "pfsp") -> Params:
        """Run the sweep for one shape family and persist the winner.

        Only the shape of `p_times` matters (None: a synthetic PFSP table
        of the shape; a real table is required for other problems).
        Raises ProbeError when no steady measurement state exists. After
        the chunk and period winner, the winner's ladder rungs are probed
        (below the static rung floor too, `min_chunk=1`) once per
        available pipeline, giving `Params.rung_modes`."""
        key = self.key(jobs, machines, lb_kind, n_workers, problem,
                       device=self.device)
        if p_times is None:
            if problem != "pfsp":
                raise ProbeError(
                    f"probing problem {problem!r} needs its instance "
                    "table (the synthetic fallback generates PFSP "
                    "tables only)")
            from ..problems.pfsp import PFSPInstance
            p_times = PFSPInstance.synthetic(jobs=jobs, machines=machines,
                                             seed=0).p_times
        t0 = time.perf_counter()
        # every candidate must be measurable: a chunk's scratch margin and
        # balance headroom must fit under the pool, so the capacity grows
        # past the configured floor as the candidates demand
        capacity = self.capacity
        while capacity < 2 * max(self.chunks) * max(int(jobs), 4):
            capacity *= 2
        harness = ProbeHarness(
            p_times, lb_kind=lb_kind, capacity=capacity,
            warm_chunk=min(self.chunks), warm_iters=self.warm_iters,
            window_iters=self.window_iters, repeats=self.repeats,
            problem=problem, device=self.device)
        # with the fused route on, every candidate is probed on both
        # pipelines and judged by the better rate: the winner is chosen on
        # rates the consuming run can take (ladder.fused_for routes it)
        from ..engine import ladder as _ladder
        from ..problems import get as _get_problem
        from ..utils import config as _cfg
        fused_mode = fz.resolve_mode(None,
                                     on_cuda=self.device.type == "cuda")
        probe_fused = (fused_mode != "off" and lb_kind in (1, 2)
                       and getattr(_get_problem(problem), "supports_fused",
                                   False))
        with tracelog.span("tuner.sweep", jobs=jobs, machines=machines,
                           lb_kind=lb_kind, n_workers=n_workers) as sp:
            results = []
            fused_results = {}
            for c in self.chunks:
                try:
                    results.append(self._probe(
                        harness, c, defaults.BALANCE_PERIOD_DEFAULT))
                except ProbeError as e:
                    # a dropped candidate is loud in the sweep record
                    tracelog.event("tuner.candidate_dropped", chunk=c,
                                   error=repr(e))
                    continue
                if probe_fused:
                    try:
                        fused_results[c] = self._probe(
                            harness, c, defaults.BALANCE_PERIOD_DEFAULT,
                            fused=fused_mode)
                    except ProbeError as e:
                        tracelog.event("tuner.candidate_dropped",
                                       chunk=c, fused=fused_mode,
                                       error=repr(e))
            if not results:
                raise ProbeError(
                    f"no chunk candidate of {self.chunks} is "
                    f"measurable at capacity {capacity}")

            def best_rate(r):
                f = fused_results.get(r.chunk)
                return max(r.evals_per_s,
                           f.evals_per_s if f is not None else 0.0)

            # steady rates outrank ramp rates: an underfilled candidate
            # wins only when every candidate is underfilled
            filled = [r for r in results if not r.underfilled]
            best_chunk = max(filled or results, key=best_rate)
            # the period sweep runs on the winner chunk's winning pipeline
            win_fm, base = "off", best_chunk
            fbest = fused_results.get(best_chunk.chunk)
            if fbest is not None \
                    and fbest.evals_per_s > best_chunk.evals_per_s:
                win_fm, base = fused_mode, fbest
            period_results = [base]
            for b in self.periods:
                if b == base.balance_period:
                    continue
                try:
                    period_results.append(self._probe(
                        harness, best_chunk.chunk, b, fused=win_fm))
                except ProbeError as e:
                    tracelog.event("tuner.candidate_dropped",
                                   balance_period=b, error=repr(e))
                    continue
            winner = max(period_results, key=lambda r: r.evals_per_s)
            sp.set(chunk=winner.chunk,
                   balance_period=winner.balance_period,
                   evals_per_s=winner.evals_per_s,
                   probes=len(results) + len(fused_results)
                   + len(period_results) - 1)

            # the per-rung fused-or-unfused mask: the winner's rungs, once
            # per available pipeline on the same warmed state; probed only
            # when there is a pipeline choice to record or TTS_TUNE_RUNGS
            # asks (each rung is another capture)
            rung_modes = []
            memo = {(r.chunk, r.balance_period, r.fused): r
                    for r in results + list(fused_results.values())
                    + period_results}
            rungs = (_ladder.rungs_for(winner.chunk, min_chunk=1)
                     if probe_fused or _cfg.env_flag("TTS_TUNE_RUNGS")
                     else ())
            for c in rungs:
                rows = {}
                for fm in ("off",) + ((fused_mode,) if probe_fused
                                      else ()):
                    k = (c, winner.balance_period, fm)
                    try:
                        rows[fm] = memo.get(k) or self._probe(
                            harness, c, winner.balance_period, fused=fm)
                    except ProbeError as e:
                        tracelog.event("tuner.candidate_dropped",
                                       chunk=c, fused=fm, error=repr(e))
                if "off" not in rows:
                    continue
                ru = rows["off"]
                rf = rows.get(fused_mode) if probe_fused else None
                win = ("fused" if rf is not None
                       and rf.evals_per_s > ru.evals_per_s else "unfused")
                best_r = rf if win == "fused" else ru
                rung_modes.append({
                    "chunk": int(c), "winner": win,
                    "ms_per_iter": best_r.ms_per_iter,
                    # both pipelines' rates: rung admission judges the
                    # pipeline the consuming run takes (ladder._selected_ms)
                    "ms_per_iter_unfused": ru.ms_per_iter,
                    "ms_per_iter_fused":
                        rf.ms_per_iter if rf is not None else None,
                    "evals_per_s_unfused": ru.evals_per_s,
                    "evals_per_s_fused":
                        rf.evals_per_s if rf is not None else None,
                })
        sweep_s = time.perf_counter() - t0
        if self._probe_h is not None:
            self._probe_h.observe(sweep_s)
        payload = {
            "chunk": winner.chunk,
            "balance_period": winner.balance_period,
            # derived from the chunk at run time: a probed one-worker cap
            # would mis-size a run on more workers
            "transfer_cap": None,
            "evals_per_s": winner.evals_per_s,
            "sweep_seconds": round(sweep_s, 3),
            "rung_modes": rung_modes,
            "probes": [r.to_json()
                       for r in results + list(fused_results.values())
                       + period_results[1:]],
        }
        if self.cache is not None:
            self.cache.store(key, payload,
                             key_repr="/".join(str(k) for k in key))
        params = Params(chunk=winner.chunk,
                        balance_period=winner.balance_period,
                        source="probe", evals_per_s=winner.evals_per_s,
                        rung_modes=(tuple(rung_modes) if rung_modes
                                    else None))
        with self._lock:
            self._memo[key] = params
        return params

    def _probe(self, harness: ProbeHarness, chunk: int,
               balance_period: int, fused: str = "off"):
        r = harness.measure(chunk, balance_period, fused=fused)
        with self._lock:
            self.probes_run += 1
            self.ledger.append(r.to_json())
        if self._probes_c is not None:
            self._probes_c.inc()
        return r

    def snapshot(self) -> dict:
        """JSON-safe stats."""
        with self._lock:
            return {
                "probes_run": self.probes_run,
                "tuned_shapes": len(self._memo),
                "chunk_candidates": list(self.chunks),
                "period_candidates": list(self.periods),
                "cache": (self.cache.snapshot()
                          if self.cache is not None else None),
            }
