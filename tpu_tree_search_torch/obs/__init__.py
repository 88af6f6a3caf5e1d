"""Port of `tpu_tree_search.obs`: the flight recorder (`tracelog`), the
metrics registry (`metrics`) and the checkpoint round-trip check of
`audit` (see the package docstring)."""
