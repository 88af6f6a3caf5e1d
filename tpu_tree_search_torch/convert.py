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
from .engine.device import COUNTER_DTYPES, SearchState, resolve_device

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


def state_from_numpy(arrays: dict, device="cuda",
                     capacity: int | None = None) -> SearchState:
    """SearchState on `device` from a dict of arrays keyed by field name
    (pool arrays keep their dtypes: prmu/depth int16, aux int16 or int32;
    `telemetry` int64 of width 0 or telemetry.WIDTH, width 0 when the dict
    has none). A stacked (D, ...) dict of D workers' pools gives a state
    with (D,) counters. With `capacity`, each pool array's rows are placed
    at the front of a zero pool of that many rows (a checkpoint holds only
    the live rows)."""
    dev = resolve_device(device)
    arrays = {**arrays, "telemetry": np.asarray(arrays.get("telemetry", ()),
                                                np.int64)}
    out = {}
    for f in _DEVICE:
        a = torch.as_tensor(np.require(arrays[f], requirements="CW"))
        rows = a.shape[-1] if capacity is None or f == "telemetry" \
            else capacity
        out[f] = torch.zeros(a.shape[:-1] + (rows,), dtype=a.dtype,
                             device=dev)
        out[f][..., :a.shape[-1]] = a
    for f, dtype in COUNTER_DTYPES.items():
        out[f] = torch.tensor(np.asarray(arrays[f]), dtype=dtype,
                              device=dev)
    return SearchState(**out)


def state_to_numpy(state, rows: int | None = None) -> dict:
    """The state's fields as numpy arrays (pool, telemetry) and 0-d (or,
    for a stacked state, (D,)) arrays of the counters' dtypes, the
    counters read in one transfer. With `rows`, only each pool's first
    `rows` rows. A list of worker states (`engine/distributed.py`) gives
    the stacked (D, ...) arrays."""
    if isinstance(state, list):
        per = [state_to_numpy(s, rows) for s in state]
        return {f: np.stack([p[f] for p in per]) for f in per[0]}
    live = slice(None) if rows is None else slice(0, rows)
    out = {f: getattr(state, f)[..., live].cpu().numpy() for f in _DEVICE
           if f != "telemetry"}
    out["telemetry"] = state.telemetry.cpu().numpy()
    vals = torch.stack([getattr(state, f).long()
                        for f in COUNTER_DTYPES]).cpu().numpy()
    for v, (f, dtype) in zip(vals, COUNTER_DTYPES.items()):
        out[f] = np.asarray(v, dtype=np_dtype(dtype))
    return out


def np_dtype(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype ('int16', 'int64', 'bool', ...)."""
    return str(dtype).split(".")[-1]
