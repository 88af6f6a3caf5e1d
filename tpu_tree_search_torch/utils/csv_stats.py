"""Experiment CSV writers, schema-compatible with the reference.

The port's copy of `tpu_tree_search/utils/csv_stats.py` (stdlib only).
Column headers and array serialization ("[a,b,c]" in a quoted cell) match
the reference's appenders exactly (reference: pfsp/lib/PFSP_statistic.c:
36-58 singlegpu, 69-112 multigpu, 123-167 dist_multigpu), so pandas-based
analysis written for the reference's `pfsp/data/*.py` keeps working.

Semantic mapping of per-PU columns to this engine:
- a "processing unit" is a worker (`engine/distributed.py`; the
  reference's is an OpenMP thread that may manage a GPU);
- `steals` / `success_steals` are balance exchanges with nodes received
  (there are no failed lock acquisitions to count);
- timing columns carry MEASURED phase attributions (utils/phase_timing:
  the bound's and the full step's unit costs timed on the real shapes,
  scaled by each worker's counters; the per-worker remainder is idle) —
  `gpu_kernel_time` = pop + bound evaluation, `gen_child_time` = the
  rest of the step (prune, compaction, the pool write),
  `time_load_bal` = measured balance rounds, `gpu_idle_time` = the
  remainder, so the columns sum to the elapsed time;
- memcpy/malloc columns are structurally zero — the pool lives on the
  device and is allocated once; headers are retained so existing
  analysis parses rows unchanged.
"""

from __future__ import annotations

import os
from typing import Sequence


def _fmt_int_array(arr: Sequence[int]) -> str:
    return '"[' + ",".join(str(int(x)) for x in arr) + ']"'


def _fmt_float_array(arr: Sequence[float]) -> str:
    return '"[' + ",".join(f"{float(x):.4f}" for x in arr) + ']"'


def _append(path: str, header: str, row: str) -> None:
    new = not os.path.exists(path) or os.path.getsize(path) == 0
    with open(path, "a") as f:
        if new:
            f.write(header + "\n")
        f.write(row + "\n")


SINGLE_HEADER = ("instance_id,lower_bound,optimum,m,M,total_time,"
                 "gpu_memcpy_time,gpu_malloc_time,gpu_kernel_time,"
                 "gen_child_time,explored_tree,explored_sol")


def write_single(path: str, inst: int, lb: int, optimum: int, m: int, M: int,
                 total_time: float, kernel_time: float,
                 explored_tree: int, explored_sol: int,
                 gen_child_time: float = 0.0) -> None:
    """Single-device row (reference: print_results_file_single_gpu)."""
    row = (f"{inst},{lb},{optimum},{m},{M},{total_time:.4f},0.0000,0.0000,"
           f"{kernel_time:.4f},{gen_child_time:.4f},"
           f"{explored_tree},{explored_sol}")
    _append(path, SINGLE_HEADER, row)


MULTI_HEADER = (
    "instance_id,D,C,lower_bound,work_stealing,optimum,m,M,T,total_time,"
    "total_tree,total_sol,"
    "exp_tree_gpu,exp_sol_gpu,gen_child_gpu,steals_gpu,success_steals_gpu,"
    "termination_gpu,gpu_memcpy_time,gpu_malloc_time,gpu_kernel_time,"
    "gpu_gen_child_time,pool_ops_time,gpu_idle_time,termination_time")


def write_multi(path: str, inst: int, lb: int, D: int, C: int, ws: int,
                optimum: int, m: int, M: int, T: int, total_time: float,
                total_tree: int, total_sol: int, per_device: dict) -> None:
    """Multi-device row (reference: print_results_file_multi_gpu).

    `per_device` holds (D,)-arrays: tree, sol, evals, steals, recv,
    kernel_time (seconds).
    """
    n = len(per_device["tree"])
    zeros_i = [0] * n
    zeros_f = [0.0] * n
    cells = [
        f"{inst},{D},{C},{lb},{ws},{optimum},{m},{M},{T},"
        f"{total_time:.4f},{total_tree},{total_sol}",
        _fmt_int_array(per_device["tree"]),
        _fmt_int_array(per_device["sol"]),
        _fmt_int_array(per_device.get("evals", zeros_i)),
        _fmt_int_array(per_device.get("steals", zeros_i)),
        _fmt_int_array(per_device.get("steals", zeros_i)),
        _fmt_int_array(zeros_i),                       # termination retries: N/A
        _fmt_float_array(zeros_f),                     # memcpy: fused
        _fmt_float_array(zeros_f),                     # malloc: static pool
        _fmt_float_array(per_device.get("kernel_time", zeros_f)),
        _fmt_float_array(per_device.get("gen_child_time", zeros_f)),
        # pool_ops column: the balance exchange is this engine's only
        # out-of-step pool manipulation (the reference counts steal-lock
        # pool ops here)
        _fmt_float_array(per_device.get("balance_time", zeros_f)),
        _fmt_float_array(per_device.get("idle_time", zeros_f)),
        _fmt_float_array(zeros_f),                     # termination: in-loop
    ]
    _append(path, MULTI_HEADER, ",".join(cells).rstrip(","))


DIST_HEADER = (
    "instance_id,D,C,comm_size,lower_bound,load_balancing,optimum,m,M,T,"
    "total_time,total_tree,total_sol,"
    "all_exp_tree_gpu,all_exp_sol_gpu,all_gen_child_gpu,all_steals_gpu,"
    "all_success_steals_gpu,all_termination_gpu,all_dist_load_bal,"
    "all_gpu_memcpy_time,all_gpu_malloc_time,all_gpu_kernel_time,"
    "all_gpu_gen_child_time,all_pool_ops_time,all_gpu_idle_time,"
    "all_termination_time,all_time_load_bal")


def write_dist(path: str, inst: int, lb: int, D: int, C: int, LB: int,
               comm_size: int, optimum: int, m: int, M: int, T: int,
               total_time: float, total_tree: int, total_sol: int,
               per_device: dict) -> None:
    """Distributed row (reference: print_results_file_dist_multi_gpu)."""
    n = len(per_device["tree"])
    zeros_i = [0] * n
    zeros_f = [0.0] * n
    cells = [
        f"{inst},{D},{C},{comm_size},{lb},{LB},{optimum},{m},{M},{T},"
        f"{total_time:.4f},{total_tree},{total_sol}",
        _fmt_int_array(per_device["tree"]),
        _fmt_int_array(per_device["sol"]),
        _fmt_int_array(per_device.get("evals", zeros_i)),
        _fmt_int_array(per_device.get("steals", zeros_i)),
        _fmt_int_array(per_device.get("steals", zeros_i)),
        _fmt_int_array(zeros_i),
        _fmt_int_array(per_device.get("recv", zeros_i)),   # dist load-bal nodes
        _fmt_float_array(zeros_f),
        _fmt_float_array(zeros_f),
        _fmt_float_array(per_device.get("kernel_time", zeros_f)),
        _fmt_float_array(per_device.get("gen_child_time", zeros_f)),
        _fmt_float_array(zeros_f),                     # pool ops: fused
        _fmt_float_array(per_device.get("idle_time", zeros_f)),
        _fmt_float_array(zeros_f),
        _fmt_float_array(per_device.get("balance_time", zeros_f)),
    ]
    _append(path, DIST_HEADER, ",".join(cells).rstrip(","))
