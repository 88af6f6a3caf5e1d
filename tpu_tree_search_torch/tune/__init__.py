"""Port of `tpu_tree_search.tune`: adaptive dispatch.

- `defaults`: the per-shape-class defaults table (`Params`, `params_for`)
- `TuningCache`: the fingerprint-checked, CRC-stamped persistent cache of
  probed optima (`cache.py`)
- `ProbeHarness` / `ProbeError` / `measure_balance_periods`: the warmed
  same-state measurement every knob sweep shares (`probe.py`)
- `Autotuner`: cache -> probe -> defaults resolution (`tuner.py`)

This `__init__` stays import-light: the heavy members resolve lazily, as
in the JAX package.
"""

from . import defaults
from .defaults import Params

__all__ = ["Autotuner", "Params", "ProbeError", "ProbeHarness",
           "TuningCache", "defaults", "measure_balance_periods"]

_LAZY = {
    "Autotuner": ("tuner", "Autotuner"),
    "TuningCache": ("cache", "TuningCache"),
    "ProbeHarness": ("probe", "ProbeHarness"),
    "ProbeError": ("probe", "ProbeError"),
    "measure_balance_periods": ("probe", "measure_balance_periods"),
}


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib
    mod = importlib.import_module(f".{mod_name}", __name__)
    return getattr(mod, attr)
