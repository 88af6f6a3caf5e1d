"""Carry bound tables and search states into and out of the port.

The system has no weights: what crosses between the JAX package and the
port is the `BoundTables` of an instance and a `SearchState` (the pool and
its counters). Both cross as plain numpy arrays keyed by field name, so
neither package imports the other: `{f: np.asarray(getattr(s, f))}` of a
JAX state is a valid input here, and `state_to_numpy` gives the same
keys back.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.batched import TABLE_FIELDS, BoundTables, sweep_tables
from .engine.device import (COUNTER_DTYPES, SearchState, counter_tensors,
                            counters, resolve_device)

# the fields held as tensors of their own shape
_DEVICE = ("prmu", "depth", "aux", "telemetry")


def tables_from_numpy(arrays: dict, device="cuda") -> BoundTables:
    """BoundTables on `device` from a dict of arrays keyed by field name
    (the JAX BoundTables' fields; the sweep kernel's packed tables are
    derived from them on `device`)."""
    dev = resolve_device(device)
    base = {f: torch.as_tensor(np.ascontiguousarray(arrays[f],
                                                    dtype=np.int32),
                               device=dev)
            for f in TABLE_FIELDS}
    steps, pairs = sweep_tables(base)
    return BoundTables(**base, sweep_steps=steps, sweep_pairs=pairs)


def state_from_numpy(arrays: dict, device="cuda") -> SearchState:
    """SearchState on `device` from a dict of arrays keyed by field name
    (pool arrays keep their dtypes: prmu/depth int16, aux int16 or int32;
    `telemetry` int64 of width 0 or telemetry.WIDTH, width 0 when the dict
    has none)."""
    dev = resolve_device(device)
    arrays = {**arrays, "telemetry": np.asarray(arrays.get("telemetry", ()),
                                                np.int64)}
    dev_arrays = {f: torch.as_tensor(np.array(arrays[f], copy=True),
                                     device=dev) for f in _DEVICE}
    counters = {f: np.asarray(arrays[f]).item() for f in COUNTER_DTYPES}
    return SearchState(**dev_arrays, **counter_tensors(dev, **counters))


def state_to_numpy(state: SearchState) -> dict:
    """The state's fields as numpy arrays (pool, telemetry) and numpy
    scalars of the counters' dtypes, the counters read in one
    transfer."""
    out = {f: getattr(state, f).cpu().numpy() for f in _DEVICE}
    for f, v in counters(state)._asdict().items():
        out[f] = np.asarray(v, dtype=str(COUNTER_DTYPES[f]).split(".")[-1])
    return out
