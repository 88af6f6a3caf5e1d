"""The workers of a multi-worker search and their devices.

Reproduces `worker_mesh` and `partition_submeshes` of
`tpu_tree_search/parallel/mesh.py`. The JAX package lays a 1-D mesh over
its devices and runs one `shard_map`ped program on it; here a search
drives a list of workers from one process, each with its pool on its own
`torch.device`, so a "mesh" is that list. A list may name one device more
than once: the counterpart of JAX's forced host device count, with which
the tests run several workers on the CPU and a one-card machine runs
several workers on its card.
"""

from __future__ import annotations

import torch


def worker_devices(n_devices: int | None = None,
                   devices: list | None = None) -> list[torch.device]:
    """The workers' devices: `devices` as given (any list, repeats allowed),
    else the visible CUDA devices; the first `n_devices` of them. Raises
    when there are fewer than `n_devices`, or no device at all."""
    if devices is None:
        from ..engine.device import resolve_device
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have "
                             f"{len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a search needs at least one worker device")
    return devices


def partition_submeshes(n_submeshes: int,
                        devices: list | None = None
                        ) -> list[list[torch.device]]:
    """Split the device list into `n_submeshes` equal, disjoint,
    contiguous worker lists (8 devices -> 2 of 4, 4 of 2, ...). The count
    must divide evenly: a dropped remainder would strand devices."""
    devices = worker_devices(devices=devices)
    if n_submeshes < 1:
        raise ValueError(f"n_submeshes must be >= 1, got {n_submeshes}")
    if len(devices) % n_submeshes:
        raise ValueError(
            f"{len(devices)} devices do not split into {n_submeshes} "
            f"equal submeshes; pick a divisor of the device count")
    per = len(devices) // n_submeshes
    return [devices[i * per:(i + 1) * per] for i in range(n_submeshes)]
