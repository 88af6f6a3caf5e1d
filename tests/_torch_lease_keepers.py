"""What the port's lease tests share: both packages' lease modules, a
wait with its own timeout, a lease's fields, and a keeper's death without
release."""

import time

from tpu_tree_search.service import lease as jlease
from tpu_tree_search_torch.service import lease as tlease

PKGS = {"jax": jlease, "torch": tlease}


def other(name):
    return "torch" if name == "jax" else "jax"


def wait_until(cond, timeout=30.0, msg="condition"):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, f"timeout: {msg}"
        time.sleep(0.01)


def fields(info):
    return (info.owner, info.epoch, info.ttl_s, info.renewed_unix,
            info.host, info.pid, info.released)


def stop(keeper):
    """A keeper that dies without releasing: its daemon stops, the file
    stays as it was."""
    keeper._stop.set()
    if keeper._thread is not None:
        keeper._thread.join(timeout=5.0)
