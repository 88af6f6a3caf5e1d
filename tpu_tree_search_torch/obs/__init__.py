"""Port of `tpu_tree_search.obs`: the flight recorder (`tracelog`), the
metrics registry (`metrics`) and its name table (`metric_names`), the
engine's invariant checks (`audit`), the device-memory sampler
(`resource`), the durable observability store (`store`), the health rules
(`health`), lane and capacity accounting (`capacity`), the progress
estimator (`estimate`), and the server's live surface: the HTTP front end
(`httpd`), the Chrome trace export and profile parsing (`chrome_trace`),
the process's one profiler door on `torch.profiler` (`profiler`), OTLP
export (`otel`), the HTML dashboard (`dashboard`) and fleet aggregation
(`aggregate`)."""
