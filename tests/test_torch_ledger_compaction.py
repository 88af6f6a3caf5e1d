"""Ledger compaction (`service/ledger.py`) against the JAX package's: with
both clocks pinned, terminal entries beyond `terminal_keep` leave the
compacted ledger (with `forget` tombstones) alike; live ones never.
Tolerance: exact (bytes and JSON)."""

import pytest

import _torch_threads
# `pinned` is a fixture: imported, pytest finds it here
from _torch_ledger_script import (  # noqa: F401
    PKGS, entry_snapshot, pinned, segments)

_torch_threads.share_cores()


@pytest.mark.parametrize("keep", [0, 1, 3, -1])
def test_compaction_and_terminal_keep_age_out_the_same(tmp_path, pinned,
                                                       keep):
    """Terminal entries beyond `terminal_keep` leave the compacted ledger
    (with `forget` tombstones) alike in both packages; live ones never."""
    got = {}
    for name, (m, _) in PKGS.items():
        led = m.RequestLedger(tmp_path / name, segment_records=4096,
                              terminal_keep=keep)
        for i in range(6):
            led.journal("admit", rid=f"r{i}", tag=f"t{i}", seq=i,
                        payload={"lb": 1}, spent_s=0.0)
            if i != 2:
                led.journal("terminal", rid=f"r{i}", state="DONE",
                            snapshot=entry_snapshot(f"r{i}", "DONE", i,
                                                    1.0))
        with led._lock:
            led._compact_locked()
        led.close()
        r = m.RequestLedger(tmp_path / name)
        got[name] = (segments(tmp_path / name), sorted(r.state.requests))
        r.close()
    assert got["torch"] == got["jax"]
    kept = got["torch"][1]
    assert "r2" in kept
    done = [f"r{i}" for i in (0, 1, 3, 4, 5)]
    want = done if keep < 0 else (done[-keep:] if keep else [])
    assert kept == sorted(["r2"] + want)
