"""Port of `tpu_tree_search.problems` (see the package docstring)."""
