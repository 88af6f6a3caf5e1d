"""Port of `tpu_tree_search.engine` (see the package docstring)."""
