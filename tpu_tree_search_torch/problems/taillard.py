"""Taillard PFSP benchmark instances, regenerated from the published seeds.

The port's own copy of `tpu_tree_search/problems/taillard.py`
(`processing_times`, `optimal_makespan`, `nb_jobs`, `nb_machines`): numpy
only, identical bit for bit, kept here so the port never imports the JAX
package.

The 120 standard instances of the Permutation Flowshop Scheduling Problem
(Taillard, EJOR 1993) are defined by a Lehmer linear congruential generator
and a per-instance seed; no data files are needed. This module reproduces
the exact processing-time matrices the reference engine uses
(reference: pfsp/lib/c_taillard.c:76-105) including the quirk that the
uniform draw divides in *float32* before widening to float64 — bit-for-bit
matrix equality with the C code requires replicating that.

Also carries the proven optimal makespans of all 120 instances
(reference: pfsp/lib/c_taillard.c:32-44), which double as the correctness
oracle: a correct B&B run seeded with `ub=opt` must terminate and report
exactly this value.
"""

from __future__ import annotations

import numpy as np

# Per-instance seeds for the processing-time generator, ta001..ta120
# (reference: pfsp/lib/c_taillard.c:6-30; originally Taillard 1993).
TIME_SEEDS = (
    873654221, 379008056, 1866992158, 216771124, 495070989,
    402959317, 1369363414, 2021925980, 573109518, 88325120,
    587595453, 1401007982, 873136276, 268827376, 1634173168,
    691823909, 73807235, 1273398721, 2065119309, 1672900551,
    479340445, 268827376, 1958948863, 918272953, 555010963,
    2010851491, 1519833303, 1748670931, 1923497586, 1829909967,
    1328042058, 200382020, 496319842, 1203030903, 1730708564,
    450926852, 1303135678, 1273398721, 587288402, 248421594,
    1958948863, 575633267, 655816003, 1977864101, 93805469,
    1803345551, 49612559, 1899802599, 2013025619, 578962478,
    1539989115, 691823909, 655816003, 1315102446, 1949668355,
    1923497586, 1805594913, 1861070898, 715643788, 464843328,
    896678084, 1179439976, 1122278347, 416756875, 267829958,
    1835213917, 1328833962, 1418570761, 161033112, 304212574,
    1539989115, 655816003, 960914243, 1915696806, 2013025619,
    1168140026, 1923497586, 167698528, 1528387973, 993794175,
    450926852, 1462772409, 1021685265, 83696007, 508154254,
    1861070898, 26482542, 444956424, 2115448041, 118254244,
    471503978, 1215892992, 135346136, 1602504050, 160037322,
    551454346, 519485142, 383947510, 1968171878, 540872513,
    2013025619, 475051709, 914834335, 810642687, 1019331795,
    2056065863, 1342855162, 1325809384, 1988803007, 765656702,
    1368624604, 450181436, 1927888393, 1759567256, 606425239,
    19268348, 1298201670, 2041736264, 379756761, 28837162,
)

# Proven optimal makespans ta001..ta120 (reference: pfsp/lib/c_taillard.c:32-44).
OPTIMAL_MAKESPAN = (
    1278, 1359, 1081, 1293, 1235, 1195, 1234, 1206, 1230, 1108,      # 20x5
    1582, 1659, 1496, 1377, 1419, 1397, 1484, 1538, 1593, 1591,      # 20x10
    2297, 2099, 2326, 2223, 2291, 2226, 2273, 2200, 2237, 2178,      # 20x20
    2724, 2834, 2621, 2751, 2863, 2829, 2725, 2683, 2552, 2782,      # 50x5
    2991, 2867, 2839, 3063, 2976, 3006, 3093, 3037, 2897, 3065,      # 50x10
    3846, 3699, 3640, 3719, 3610, 3679, 3704, 3691, 3741, 3755,      # 50x20
    5493, 5268, 5175, 5014, 5250, 5135, 5246, 5094, 5448, 5322,      # 100x5
    5770, 5349, 5676, 5781, 5467, 5303, 5595, 5617, 5871, 5845,      # 100x10
    6173, 6183, 6252, 6254, 6285, 6331, 6223, 6372, 6247, 6404,      # 100x20
    10862, 10480, 10922, 10889, 10524, 10329, 10854, 10730, 10438, 10675,  # 200x10
    11158, 11160, 11281, 11275, 11259, 11176, 11337, 11301, 11146, 11284,  # 200x20
    26040, 26500, 26371, 26456, 26334, 26469, 26389, 26560, 26005, 26457,  # 500x20
)

# Instances never solved to optimality in the reference's campaigns
# (reference: pfsp/launch_scripts/mgpu_launch.sh:96) - useful to know when
# choosing benchmark workloads.
UNSOLVED_IN_REFERENCE_CAMPAIGNS = frozenset(
    {51, 54, 55, 59, 60, 81, 85, 86, 87, 88, 89, 102}
)


def nb_jobs(inst: int) -> int:
    """Number of jobs of instance ta{inst} (reference: c_taillard.c:46-53)."""
    if inst > 110:
        return 500
    if inst > 90:
        return 200
    if inst > 60:
        return 100
    if inst > 30:
        return 50
    return 20


def nb_machines(inst: int) -> int:
    """Number of machines of instance ta{inst} (reference: c_taillard.c:55-69)."""
    if inst > 110 or inst > 100:
        return 20
    if inst > 90:
        return 10
    if inst > 80:
        return 20
    if inst > 70:
        return 10
    if inst > 60:
        return 5
    if inst > 50:
        return 20
    if inst > 40:
        return 10
    if inst > 30:
        return 5
    if inst > 20:
        return 20
    if inst > 10:
        return 10
    return 5


def optimal_makespan(inst: int) -> int:
    """Proven optimal makespan of ta{inst} (reference: c_taillard.c:71-74)."""
    return OPTIMAL_MAKESPAN[inst - 1]


def _lehmer_next(seed: int) -> int:
    """One step of the Lehmer LCG used by Taillard's generator.

    x <- 16807 * x mod (2^31 - 1), computed with Schrage's decomposition
    exactly as the published generator does (reference: c_taillard.c:76-88).
    """
    m = 2147483647
    a = 16807
    b = 127773
    c = 2836
    k = seed // b
    seed = a * (seed % b) - k * c
    if seed < 0:
        seed += m
    return seed


def _unif_0_99(seed: int) -> tuple[int, int]:
    """Draw uniform in [1, 99] the way the reference does.

    The reference divides in single precision — `(float)seed / (float)m`
    (c_taillard.c:85) — before scaling in double; replicating that float32
    rounding is required for bit-identical matrices.
    """
    seed = _lehmer_next(seed)
    q = np.float32(seed) / np.float32(2147483647)
    value = 1 + int(float(q) * 99.0)
    return seed, value


def processing_times(inst: int, dtype=np.int32) -> np.ndarray:
    """Processing-time matrix of ta{inst}, shape (machines, jobs).

    Row-major machine-by-job layout, matching the reference's `ptm[i*N+j]`
    indexing (c_taillard.c:100-104): `p[m, j]` is the processing time of
    job `j` on machine `m`.
    """
    n = nb_jobs(inst)
    m = nb_machines(inst)
    seed = TIME_SEEDS[inst - 1]
    out = np.empty((m, n), dtype=dtype)
    for i in range(m):
        for j in range(n):
            seed, v = _unif_0_99(seed)
            out[i, j] = v
    return out


def instance(inst: int) -> tuple[np.ndarray, int, int]:
    """(processing_times, jobs, machines) of ta{inst} (c_taillard.c:107-113)."""
    p = processing_times(inst)
    return p, p.shape[1], p.shape[0]
