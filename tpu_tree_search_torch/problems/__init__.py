"""Problem plugins: the workload layer of the generic engine.

Reproduces `tpu_tree_search/problems/__init__.py`: importing the package
registers the built-in plugins (PFSP, N-Queens, TSP, 0/1 knapsack);
`get(name)` resolves a name. `problems/base.py` holds the protocol.
"""

from . import base, knapsack, nqueens, pfsp, taillard, tsp
from .base import BranchOut, Problem, get, names, register

__all__ = ["base", "taillard", "pfsp", "nqueens", "tsp", "knapsack",
           "BranchOut", "Problem", "get", "names", "register"]
