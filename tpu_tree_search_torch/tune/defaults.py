"""Dispatch defaults of the port's entry points: one table for every
context.

Reproduces `tpu_tree_search/tune/defaults.py`: `BALANCE_PERIOD_DEFAULT`,
the three context chunks, `Params` (with `rung_modes`), `shape_class`,
`MEASURED`, `_FALLBACK`, `_FALLBACK_BATCHED` and `params_for`. The values
are the JAX package's, row for row. None of them was measured on the
H100: the measurements that chose them there were taken on another device
and are not carried over (the JAX module's docstring gives each row's
provenance). `PERF.md` holds the port's own measurements; a row changes
here only with one of those.

Contexts: "bench" (the single-card throughput runs), "serving" (a search
request's default, the one `distributed.search(chunk=None)` resolves) and
"cli" (the reference-parity command line).

This module stays import-light (stdlib only).
"""

from __future__ import annotations

import dataclasses

# the balance period every context shares
BALANCE_PERIOD_DEFAULT = 4

# per-context chunk defaults (the fallback rows of the table below)
CLI_CHUNK_DEFAULT = 256       # PFSP_lib.c:175-185's -M family
SERVING_CHUNK_DEFAULT = 64    # a request's stop-flag reaction granularity
BENCH_CHUNK_DEFAULT = 65536   # chip_smoke.py's ta021 phases


@dataclasses.dataclass(frozen=True)
class Params:
    """One resolved dispatch configuration. `transfer_cap` None means
    "derive from chunk" (`distributed.default_transfer_cap`); `source`
    names the tier that produced it: "default" (this table), "cache" (a
    persisted tuned entry) or "probe" (freshly measured)."""

    chunk: int
    balance_period: int = BALANCE_PERIOD_DEFAULT
    transfer_cap: int | None = None
    source: str = "default"
    evals_per_s: float | None = None   # the winning probe's rate, when
    #                                    source is cache/probe
    rung_modes: tuple | None = None    # per-rung fused-or-unfused rows of
    #   a probed ladder (source cache/probe only): a tuple of {"chunk",
    #   "winner": "fused"|"unfused", "ms_per_iter", "evals_per_s_fused",
    #   "evals_per_s_unfused"} dicts; engine/ladder.rungs_from_profile
    #   admits rungs from it and ladder.fused_for picks each rung's route


def shape_class(jobs: int, machines: int, problem: str = "pfsp",
                batch: int | None = None) -> str:
    """The shape-class label the table's rows key on: `JxM` for PFSP,
    `problem:JxM` for every other problem (two workloads never alias one
    row), and `@bB` appended for a batched dispatch of B > 1 instances
    (a batched optimum never aliases the solo row of the same shape)."""
    label = f"{int(jobs)}x{int(machines)}"
    if problem != "pfsp":
        label = f"{problem}:{label}"
    if batch is not None and int(batch) > 1:
        label = f"{label}@b{int(batch)}"
    return label


# (context, shape_class) -> Params: the JAX package's measured rows
MEASURED: dict[tuple[str, str], Params] = {
    ("bench", "20x5"): Params(chunk=BENCH_CHUNK_DEFAULT),
    ("bench", "20x10"): Params(chunk=BENCH_CHUNK_DEFAULT),
    ("bench", "20x20"): Params(chunk=BENCH_CHUNK_DEFAULT),
    ("serving", "8x5@b4"): Params(chunk=SERVING_CHUNK_DEFAULT),
    ("serving", "8x5@b8"): Params(chunk=SERVING_CHUNK_DEFAULT),
    ("serving", "8x5@b16"): Params(chunk=SERVING_CHUNK_DEFAULT),
}

# the per-member chunk of a batched serving dispatch
SERVING_BATCH_CHUNK_DEFAULT = 64

_FALLBACK: dict[str, Params] = {
    "bench": Params(chunk=BENCH_CHUNK_DEFAULT),
    "serving": Params(chunk=SERVING_CHUNK_DEFAULT),
    "cli": Params(chunk=CLI_CHUNK_DEFAULT),
}

# a batched dispatch with no row of its own lands here, never on the solo
# serving row: a solo retune must not change every batch's chunk
_FALLBACK_BATCHED = Params(chunk=SERVING_BATCH_CHUNK_DEFAULT)


def params_for(context: str, jobs: int | None = None,
               machines: int | None = None,
               problem: str = "pfsp",
               batch: int | None = None) -> Params:
    """The default dispatch params for a context, problem and shape: the
    shape's measured row, else the batched fallback (B > 1), else the
    context's fallback. An unknown context raises ValueError."""
    if context not in _FALLBACK:
        raise ValueError(f"unknown defaults context {context!r} "
                         f"(want one of {sorted(_FALLBACK)})")
    if jobs is not None and machines is not None:
        row = MEASURED.get((context, shape_class(jobs, machines,
                                                 problem, batch=batch)))
        if row is not None:
            return row
    if batch is not None and int(batch) > 1:
        return _FALLBACK_BATCHED
    return _FALLBACK[context]
