"""Chunk defaults of the port's entry points.

Reproduces `CLI_CHUNK_DEFAULT` and `BENCH_CHUNK_DEFAULT` of
`tpu_tree_search/tune/defaults.py`. The values are the JAX package's; the
speed measurements that chose them there were taken on another device and
are not carried over. `PERF.md` holds the port's own measurements.
"""

# the reference-parity command-line default (PFSP_lib.c:175-185's -M
# family), kept for command-line compatibility
CLI_CHUNK_DEFAULT = 256

# the wide chunk the throughput runs use (chip_smoke.py's ta021 phase)
BENCH_CHUNK_DEFAULT = 65536
