"""The port's ledger lease (`service/lease.py`) against the JAX package's.

Both packages write the same `lease.json` bytes for the same lease, each
reads and renews the lease the other wrote, acquire/renew/takeover/fence
round-trip across them (a keeper of one package fenced by a takeover from
the other), and a corrupt lease is quarantined and acquired again above
every claimed epoch. Who may own a lease (a live foreign lease, a dead
pid, racing takeovers, suspended renewals) is test_torch_lease_owner.py's.
Lease TTLs are 0.5-2 s; every wait has a timeout of its own. Tolerance:
exact (file bytes, epochs, owners)."""

import os
import socket

import pytest

import _torch_threads
from _torch_lease_keepers import PKGS, fields, other, stop

_torch_threads.share_cores()


@pytest.mark.parametrize("released", [False, True])
def test_lease_file_bytes_equal(tmp_path, released):
    info = dict(owner="h:1:abcd", epoch=7, ttl_s=1.5,
                renewed_unix=1_700_000_000.25, host="h", pid=1,
                released=released)
    out = {}
    for name, mod in PKGS.items():
        (tmp_path / name).mkdir()
        mod._write_lease(tmp_path / name, mod.LeaseInfo(**info))
        out[name] = (tmp_path / name / "lease.json").read_bytes()
        assert fields(mod.read_lease(tmp_path / name)) == tuple(
            info.values())
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_reads_and_renews_the_others_lease(tmp_path, writer):
    """A keeper of `writer` acquires; the other package reads the same
    lease, and a keeper of the other package that takes the lease over at
    the next epoch is read back alike by both."""
    w, r = PKGS[writer], PKGS[other(writer)]
    keeper = w.LeaseKeeper(tmp_path, ttl_s=2.0)
    keeper.acquire()
    try:
        a, b = w.read_lease(tmp_path), r.read_lease(tmp_path)
        assert fields(a) == fields(b)
        assert (b.owner, b.epoch, b.pid, b.host) == (
            keeper.owner, 1, os.getpid(), socket.gethostname())
        assert not a.expired() and not b.expired()
        keeper.renew()
        assert keeper.renewals == 1
        assert r.read_lease(tmp_path).renewed_unix >= b.renewed_unix
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            "lease.claim-00000001", "lease.json"]
    finally:
        stop(keeper)


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_acquire_renew_takeover_fence_roundtrip(tmp_path, first):
    """Owner A (one package) holds epoch 1; peer B (the other package)
    takes over at epoch 2; A's next renew and check raise LeaseLost and
    fence it once (its callback fires once), A's release leaves B's file
    alone, B's release marks the lease released (expired for both)."""
    ma, mb = PKGS[first], PKGS[other(first)]
    lost = []
    a = ma.LeaseKeeper(tmp_path, ttl_s=2.0, on_lost=lost.append)
    a.acquire()
    b = mb.LeaseKeeper(tmp_path, ttl_s=2.0)
    try:
        assert a.epoch == 1
        assert b.takeover(1)
        assert b.epoch == 2
        with pytest.raises(ma.LeaseLost, match="epoch 2"):
            a.renew()
        assert a.fenced and len(lost) == 1
        with pytest.raises(ma.LeaseLost):
            a.check()
        assert len(lost) == 1
        a.release()
        info = mb.read_lease(tmp_path)
        assert (info.owner, info.epoch, info.released) == (b.owner, 2,
                                                          False)
        b.release()
        for mod in (ma, mb):
            got = mod.read_lease(tmp_path)
            assert got.released and got.expired()
        assert a.snapshot()["fenced"] and not b.snapshot()["fenced"]
    finally:
        stop(a)
        stop(b)


@pytest.mark.parametrize("name", ["jax", "torch"])
def test_corrupt_lease_quarantined_and_acquired_higher(tmp_path, name):
    """A torn lease file reads as absent in both packages and moves to
    `lease.json.corrupt`; the next acquire bids above every claim file
    (epoch 2 after a claim at 1), whichever package acquires."""
    mod, peer = PKGS[name], PKGS[other(name)]
    first = peer.LeaseKeeper(tmp_path, ttl_s=1.0)
    first.acquire()
    stop(first)
    (tmp_path / "lease.json").write_bytes(b'{"c": 12, "r": {"owner": "x"')
    assert peer.read_lease(tmp_path) is None
    assert (tmp_path / "lease.json.corrupt").exists()
    assert not (tmp_path / "lease.json").exists()
    again = mod.LeaseKeeper(tmp_path, ttl_s=1.0)
    again.acquire()
    try:
        assert again.epoch == 2
        assert peer.read_lease(tmp_path).epoch == 2
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            "lease.claim-00000002", "lease.json", "lease.json.corrupt"]
    finally:
        stop(again)
