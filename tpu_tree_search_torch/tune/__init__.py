"""Port of `tpu_tree_search.tune` (see the package docstring)."""
