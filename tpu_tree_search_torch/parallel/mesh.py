"""The workers of a multi-worker search and their devices.

Reproduces `worker_mesh` and `partition_submeshes` of
`tpu_tree_search/parallel/mesh.py`. The JAX package lays a 1-D mesh over
its devices and runs one `shard_map`ped program on it; here a search
drives a list of workers from one process, each with its pool on its own
`torch.device`, so a "mesh" is that list. A list may name one device more
than once: the counterpart of JAX's forced host device count, with which
the tests run several workers on the CPU and a one-card machine runs
several workers on its card.

A multi-process job (the JAX package's multi-controller tier,
`--multihost`) joins a `torch.distributed` process group on the gloo
backend (`init_processes`): every collective runs on CPU tensors staged
through the host, as the reference's MPI tier does over host buffers. Rank
r drives the global workers `r*D_local ... r*D_local + D_local - 1`
(`local_worker_devices`), so striping, warm-up and the balance plan agree
with one process driving all D of them. `process_count` and
`process_index` read the group (1 and 0 without one), as
`jax.process_count` and `jax.process_index` do.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

# the backend of every multi-process job: the collectives run on CPU
# tensors (several ranks may share one card, which NCCL refuses)
BACKEND = "gloo"


def process_count() -> int:
    """The processes of this job: the process group's size, 1 without
    one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the job, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def init_processes() -> None:
    """Join the job's process group from the environment (`env://`: RANK,
    WORLD_SIZE, MASTER_ADDR and MASTER_PORT, as `python -m
    torch.distributed.run` sets them) on the gloo backend."""
    if not dist.is_initialized():
        dist.init_process_group(BACKEND, init_method="env://")


def local_worker_devices(n_devices: int, device="cuda"
                         ) -> list[torch.device]:
    """This rank's share of a job of `n_devices` workers in all:
    `n_devices / process_count()` workers, on the card `cuda:LOCAL_RANK %
    device_count` (or on the CPU for `device="cpu"`). Raises when the
    count does not divide evenly across the ranks."""
    ranks = process_count()
    if n_devices < ranks or n_devices % ranks:
        raise ValueError(f"{n_devices} workers do not split evenly across "
                         f"{ranks} processes; pick a multiple of {ranks}")
    dev = torch.device(device)
    if dev.type == "cuda":
        from ..engine.device import resolve_device
        resolve_device("cuda")
        local = int(os.environ.get("LOCAL_RANK", process_index()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return [dev] * (n_devices // ranks)


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


def gather_rows(arrays: tuple) -> tuple:
    """Every rank's worker-stacked numpy arrays (each with the rank's
    workers on axis 0, the same shapes on every rank), concatenated in
    rank order on every rank: one `all_gather` of their int64 values.
    Unchanged without a process group."""
    if process_count() == 1:
        return tuple(arrays)
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(a, np.int64).reshape(-1) for a in arrays]))
    parts = [torch.empty_like(flat) for _ in range(process_count())]
    dist.all_gather(parts, flat)
    out, at = [], 0
    for a in arrays:
        n = a.size
        out.append(np.concatenate(
            [p[at:at + n].numpy().reshape(a.shape) for p in parts])
            .astype(a.dtype))
        at += n
    return tuple(out)


def gather_stacked(arrays: dict, dst: int | None = None) -> dict | None:
    """Every rank's worker-stacked dict of numpy arrays (a state's fields,
    the rank's workers on axis 0) concatenated in rank order: on every rank
    (`dst=None`), or on rank `dst` only, the others getting None. Unchanged
    without a process group."""
    if process_count() == 1:
        return arrays
    if dst is None:
        parts = [None] * process_count()
        dist.all_gather_object(parts, arrays)
    else:
        parts = [None] * process_count() if process_index() == dst else None
        dist.gather_object(arrays, parts, dst=dst)
        if parts is None:
            return None
    return {f: np.concatenate([p[f] for p in parts]) for f in arrays}
