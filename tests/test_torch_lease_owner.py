"""Who may own the port's ledger lease (`service/lease.py`), against the
JAX package's: a live foreign lease refuses a boot, a dead pid's lease on
this host counts as expired, and one JAX keeper and one port keeper
racing `takeover` on one epoch give exactly one winner.
`suspend_renewals` (the hook of the port's `pause_server` drill) freezes a
keeper's renewals. Lease TTLs are 0.5-2 s; every wait has a timeout of
its own. Tolerance: exact (file bytes, epochs, owners)."""

import os
import socket
import subprocess
import sys
import threading
import time

import pytest

from tpu_tree_search.service import lease as jlease
from tpu_tree_search_torch.service import lease as tlease
from tpu_tree_search_torch.utils import faults as tfaults

import _torch_threads
from _torch_lease_keepers import PKGS, other, stop, wait_until

_torch_threads.share_cores()


@pytest.mark.parametrize("name", ["jax", "torch"])
def test_boot_refuses_a_live_foreign_lease(tmp_path, name):
    holder = PKGS[other(name)].LeaseKeeper(tmp_path, ttl_s=2.0)
    holder.acquire()
    try:
        with pytest.raises(PKGS[name].LeaseLost, match="held by"):
            PKGS[name].LeaseKeeper(tmp_path, ttl_s=2.0).acquire()
    finally:
        stop(holder)


def test_dead_pid_lease_expires_on_this_host(tmp_path):
    """Same host: a dead pid's lease is expired at once; a live pid's is
    not before its TTL; another host's dead pid waits out the TTL."""
    proc = subprocess.run([sys.executable, "-c", "import os;"
                           "print(os.getpid())"], capture_output=True,
                          text=True, check=True)
    dead = int(proc.stdout)
    now = time.time()
    host = socket.gethostname()
    for pid, h, want in ((dead, host, True), (os.getpid(), host, False),
                         (dead, host + "-elsewhere", False)):
        d = tmp_path / f"{pid}-{h}"
        d.mkdir()
        tlease._write_lease(d, tlease.LeaseInfo(
            owner="o", epoch=1, ttl_s=60.0, renewed_unix=now, host=h,
            pid=pid))
        for mod in PKGS.values():
            assert mod.read_lease(d).expired(now) is want, (pid, h)


@pytest.mark.parametrize("seed", range(4))
def test_takeover_race_has_exactly_one_winner(tmp_path, seed):
    """A JAX keeper and a port keeper race `takeover` of one expired
    epoch from two threads: exactly one claims it, and the lease names
    the winner."""
    seed_keeper = tlease.LeaseKeeper(tmp_path, ttl_s=0.5)
    seed_keeper.acquire()
    stop(seed_keeper)
    racers = [jlease.LeaseKeeper(tmp_path, ttl_s=2.0),
              tlease.LeaseKeeper(tmp_path, ttl_s=2.0)]
    if seed % 2:
        racers.reverse()
    gate = threading.Barrier(2)
    won = {}

    def race(k):
        gate.wait(timeout=10)
        won[k.owner] = k.takeover(1)

    threads = [threading.Thread(target=race, args=(k,)) for k in racers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    try:
        assert sorted(won.values()) == [False, True]
        winner = next(k for k in racers if won[k.owner])
        for mod in PKGS.values():
            info = mod.read_lease(tmp_path)
            assert (info.owner, info.epoch) == (winner.owner, 2)
    finally:
        for k in racers:
            stop(k)


def test_suspend_renewals_freezes_keepers_and_pause_server_calls_it(
        tmp_path, monkeypatch):
    """The port's `suspend_renewals` holds a keeper's daemon (its lease
    ages past the TTL while the process lives), and the port's
    `pause_server` drill calls it with the pause's seconds, then sleeps."""
    keeper = tlease.LeaseKeeper(tmp_path, ttl_s=0.5)
    keeper.acquire()
    try:
        wait_until(lambda: keeper.renewals >= 1, msg="first renewal")
        tlease.suspend_renewals(1.5)
        frozen = keeper.renewals
        wait_until(lambda: jlease.read_lease(tmp_path).expired(),
                   timeout=10, msg="the lease expires while suspended")
        assert keeper.renewals in (frozen, frozen + 1)
        wait_until(lambda: keeper.renewals > frozen + 1, timeout=10,
                   msg="renewals resume after the pause")
    finally:
        stop(keeper)
    called, slept = [], []
    monkeypatch.setattr(tlease, "suspend_renewals", called.append)
    monkeypatch.setattr(tfaults.time, "sleep", slept.append)
    plan = tfaults.FaultPlan.parse("pause_server=2:3.5")
    with tfaults.scoped(plan):
        tfaults.fire("segment_start", segment=1)
        tfaults.fire("segment_start", segment=2)
        tfaults.fire("segment_start", segment=2)
    assert called == [3.5] and slept == [3.5]
