"""PyTorch/CUDA port of `tpu_tree_search`: exact PFSP branch-and-bound,
and N-Queens, TSP and 0/1 knapsack through the problem-plugin engine.

The package mirrors the JAX package's module names: `problems.taillard`,
`problems.base` (the plugin API and registry), `problems.pfsp`,
`problems.nqueens`, `problems.tsp`, `problems.knapsack`, `ops.reference`,
`ops.batched`, `ops.expand` (with the Hopper kernels of `csrc/` bound by
`ops.kernels`), `ops.nqueens_ops`, `engine.device` (with `generic_step`,
`run_problem` and `solve`), `engine.sequential` (the host oracles),
`engine.telemetry`,
`engine.checkpoint` (segmented, checkpointed runs), `parallel.balance`,
`obs.metrics`, `obs.tracelog`, `obs.audit`, `utils.config`,
`utils.retry`, `utils.faults`, `tune.defaults` and `cli`. It imports
torch and numpy, never jax and nothing of `tpu_tree_search`.

    python -m tpu_tree_search_torch pfsp -i 21 -l 2 -u 1
    python -m tpu_tree_search_torch nqueens -N 15 --chunk 65536
"""
