"""Port of `tpu_tree_search.obs`: the flight recorder (`tracelog`), the
metrics registry (`metrics`) and its name table (`metric_names`), the
engine's invariant checks (`audit`), the device-memory sampler
(`resource`), the durable observability store (`store`), the health rules
(`health`), lane and capacity accounting (`capacity`) and the progress
estimator (`estimate`)."""
