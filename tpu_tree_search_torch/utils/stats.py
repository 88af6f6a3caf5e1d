"""The boxplot bundle of the server's request snapshot.

Reproduces `BoxplotStats` and `compute_boxplot_stats` of
`tpu_tree_search/utils/stats.py` (the reference's `compute_boxplot_stats`,
common/util.c:168-201): the same fields, Tukey hinges and fences.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BoxplotStats:
    minimum: float
    q1: float
    median: float
    q3: float
    maximum: float
    mean: float
    stddev: float
    iqr: float
    lower_fence: float
    upper_fence: float


def median_sorted(v: np.ndarray) -> float:
    n = len(v)
    mid = n // 2
    return float(v[mid]) if n % 2 else float((v[mid - 1] + v[mid]) / 2.0)


def quartiles_sorted(v: np.ndarray) -> tuple[float, float]:
    """Tukey hinges: the medians of the lower and upper halves, the middle
    element left out for odd n; one sample is its own hinge."""
    n = len(v)
    if n == 1:
        return float(v[0]), float(v[0])
    half = n // 2
    return median_sorted(v[:half]), median_sorted(v[half + (n % 2):])


def compute_boxplot_stats(values) -> BoxplotStats:
    v = np.sort(np.asarray(values, dtype=np.float64))
    q1, q3 = quartiles_sorted(v)
    iqr = q3 - q1
    return BoxplotStats(
        minimum=float(v[0]), q1=q1, median=median_sorted(v), q3=q3,
        maximum=float(v[-1]), mean=float(v.mean()),
        stddev=float(v.std(ddof=0)), iqr=iqr,
        lower_fence=q1 - 1.5 * iqr, upper_fence=q3 + 1.5 * iqr,
    )
