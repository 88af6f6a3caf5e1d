"""PyTorch/CUDA port of `tpu_tree_search`: exact PFSP branch-and-bound.

The package mirrors the JAX package's module names: `problems.taillard`,
`ops.reference`, `ops.batched`, `ops.expand` (with the Hopper kernels of
`csrc/` bound by `ops.kernels`), `engine.device`, `engine.telemetry`,
`engine.checkpoint` (segmented, checkpointed runs), `parallel.balance`,
`obs.metrics`, `obs.tracelog`, `obs.audit`, `utils.config`,
`utils.retry`, `utils.faults`, `tune.defaults` and `cli`. It imports
torch and numpy, never jax and nothing of `tpu_tree_search`.

    python -m tpu_tree_search_torch pfsp -i 21 -l 2 -u 1
"""
