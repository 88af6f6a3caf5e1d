"""Port of `tpu_tree_search.parallel` (see the package docstring)."""
