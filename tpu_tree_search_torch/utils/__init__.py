"""Port of `tpu_tree_search.utils` (see the package docstring)."""
