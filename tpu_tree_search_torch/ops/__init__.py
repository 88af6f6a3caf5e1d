"""Port of `tpu_tree_search.ops` (see the package docstring)."""
