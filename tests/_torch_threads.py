"""Torch's CPU threads for the port's tests.

Under pytest-xdist several test processes share the host's cores. Each
torch process starts as many intra-op threads as the host has cores, and
those threads spin while they wait on each other: six such processes on
eight cores ran a 7 s search past 900 s. `share_cores` gives torch this
worker's share of the cores (at least one), less `reserve` cores for
threads of the test's own (the `-C` host tier's); outside xdist and with
nothing reserved it changes nothing.
"""

import os

import torch


def share_cores(reserve: int = 0) -> int:
    """Set torch's intra-op threads to this process's share; returns the
    count it replaced."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    cores = max(1, (os.cpu_count() or 1) - reserve)
    if workers > 1 or reserve:
        torch.set_num_threads(max(1, cores // workers))
    return before
