"""Port of `tpu_tree_search.tune`: the dispatch defaults (`defaults`,
`Params`). The tuner (`Autotuner`, `TuningCache`, `ProbeHarness`,
`ProbeError`, `measure_balance_periods`) is not ported yet: asking for it
raises NotImplementedError naming its ROADMAP item."""

from . import defaults
from .defaults import Params

__all__ = ["Params", "defaults"]

_NOT_PORTED = ("Autotuner", "TuningCache", "ProbeHarness", "ProbeError",
               "measure_balance_periods")


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"tune.{name}: the tuner is not ported yet (ROADMAP A6)")
    raise AttributeError(name)
