"""The port's request ledger (`service/ledger.py`) against the JAX package's.

With both modules' clocks pinned to one settable clock, the same journal
calls (every record kind the server writes, with and without a lease's
epoch stamp, with and without compaction) give segment files equal byte
for byte. Each package replays the other's segments to equal
`to_records()` and snapshots; a torn tail is cut at the same byte offset
and a later segment quarantined alike. Compaction's ageing is
test_torch_ledger_compaction.py's, fencing and the epoch ratchet
test_torch_ledger_fence.py's. Tolerance: exact (bytes and JSON)."""

import json
import shutil

import pytest

from tpu_tree_search_torch.service import ledger as tledger

import _torch_threads
# `pinned` is a fixture: imported, pytest finds it here
from _torch_ledger_script import (  # noqa: F401
    PKGS, FakeLease, pinned, script, segments)

_torch_threads.share_cores()


@pytest.mark.parametrize("mode", ["plain", "compacting", "leased"])
def test_segments_byte_identical_under_pinned_clock(tmp_path, pinned,
                                                    mode):
    out, snaps, records = {}, {}, {}
    for name, (mod, lost) in PKGS.items():
        kw = {}
        if mode == "compacting":
            kw = dict(segment_records=6, terminal_keep=1)
        elif mode == "leased":
            kw = dict(lease=FakeLease(3, lost))
        led = mod.RequestLedger(tmp_path / name, **kw)
        script(led)
        led.close()
        out[name] = segments(tmp_path / name)
        snap = led.snapshot()
        snap.pop("dir")
        snap.pop("lag_s")
        snaps[name] = snap
        records[name] = led.state.to_records(led.terminal_keep)
    assert out["torch"] == out["jax"]
    assert snaps["torch"] == snaps["jax"]
    assert json.dumps(records["torch"]) == json.dumps(records["jax"])
    if mode == "compacting":
        assert snaps["torch"]["compactions"] >= 2
        assert len(out["torch"]) == 1


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_replays_the_others_segments(tmp_path, writer):
    """One package writes (compacting along the way), both replay copies
    of the directory: the same state, `to_records()` and counters."""
    mod = PKGS[writer][0]
    led = mod.RequestLedger(tmp_path / "w", segment_records=9)
    script(led)
    want = json.dumps(led.state.to_records())
    led.close()
    got = {}
    for name, (m, _) in PKGS.items():
        shutil.copytree(tmp_path / "w", tmp_path / name)
        r = m.RequestLedger(tmp_path / name)
        got[name] = (json.dumps(r.state.to_records()), r.replayed,
                     r.truncated, r.state.boots, r.state.epoch,
                     r.state.takeovers, r.snapshot()["last_shutdown"])
        r.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == want
    assert got["torch"][-1] == "clean"


@pytest.mark.parametrize("damage", ["garbage_tail", "torn_line",
                                    "crc_flip"])
def test_torn_tail_cut_at_the_same_offset(tmp_path, damage):
    """The first of two segments damaged: each package truncates it at the
    same byte, quarantines the later segment as `.corrupt`, and counts the
    same discarded records."""
    led = tledger.RequestLedger(tmp_path / "w", segment_records=1 << 20)
    script(led)
    led.close()
    seg1 = tmp_path / "w" / "seg-00000001.jsonl"
    raw = seg1.read_bytes()
    lines = raw.split(b"\n")
    if damage == "garbage_tail":
        raw += b'{"c": 1, "r": {"k": "terminal", "rid": "' + b"x" * 40
    elif damage == "torn_line":
        raw = b"\n".join(lines[:10]) + b"\n" + lines[10][:17]
    else:
        rec = json.loads(lines[12])
        rec["c"] ^= 1
        lines[12] = json.dumps(rec, sort_keys=True,
                               separators=(",", ":")).encode()
        raw = b"\n".join(lines)
    seg1.write_bytes(raw)
    (tmp_path / "w" / "seg-00000002.jsonl").write_bytes(lines[0] + b"\n")
    got = {}
    for name, (m, _) in PKGS.items():
        shutil.copytree(tmp_path / "w", tmp_path / name)
        r = m.RequestLedger(tmp_path / name)
        got[name] = (segments(tmp_path / name), r.replayed, r.truncated,
                     r.quarantined_segments,
                     json.dumps(r.state.to_records()))
        r.close()
    assert got["torch"] == got["jax"]
    files, replayed, truncated, quarantined, _ = got["torch"]
    assert quarantined == 1 and truncated >= 1
    assert set(files) == {"seg-00000001.jsonl",
                          "seg-00000002.jsonl.corrupt"}
    assert raw.startswith(files["seg-00000001.jsonl"])
