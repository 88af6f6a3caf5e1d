"""A fenced ledger (`service/ledger.py`) against the JAX package's: it
refuses appends (no byte written, `on_fenced` once), the epoch ratchet
discards the same stale records, and an unusable directory raises in
both. Tolerance: exact (bytes and JSON)."""

import json

import pytest

import _torch_threads
from _torch_ledger_script import PKGS, FakeLease, segments

_torch_threads.share_cores()


@pytest.mark.parametrize("name", ["jax", "torch"])
def test_fenced_ledger_refuses_appends(tmp_path, name):
    mod, lost = PKGS[name]
    lease = FakeLease(2, lost)
    fenced = []
    led = mod.RequestLedger(tmp_path, lease=lease, on_fenced=fenced.append)
    led.journal("admit", rid="r0", tag="t", seq=0, payload={}, spent_s=0.0)
    before = segments(tmp_path)
    lease.lost = True
    led.journal("dispatch", rid="r0", submesh=0, dispatch=1)
    led.journal("terminal", rid="r0", state="DONE", snapshot={})
    assert segments(tmp_path) == before
    assert led.fenced and len(fenced) == 1 and "epoch bumped" in fenced[0]
    assert led.state.requests["r0"]["state"] == "QUEUED"
    snap = led.snapshot()
    assert (snap["epoch"], snap["fenced"], snap["records"]) == (2, True, 1)
    led.close()


def test_epoch_ratchet_discards_the_same_records():
    recs = [{"k": "boot", "e": 1},
            {"k": "admit", "rid": "a", "seq": 0, "e": 1},
            {"k": "takeover", "e": 2},
            {"k": "dispatch", "rid": "a", "submesh": 0, "e": 1},
            {"k": "admit", "rid": "b", "seq": 1, "e": 2},
            {"k": "terminal", "rid": "a", "state": "DONE", "e": 1,
             "snapshot": {}},
            {"k": "budget", "rid": "b", "spent_s": 3.0},
            {"k": "preempt", "rid": "b", "preemptions": 1, "e": 3}]
    out = []
    for mod, _ in PKGS.values():
        st = mod.LedgerState()
        for r in recs:
            st.apply(dict(r))
        out.append((json.dumps(st.to_records()), st.epoch,
                    st.fenced_discards, st.takeovers))
    assert out[0] == out[1]
    assert out[1][1:] == (3, 2, 1)


@pytest.mark.parametrize("name", ["jax", "torch"])
def test_unusable_ledger_dir_raises(tmp_path, name):
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    with pytest.raises(OSError):
        PKGS[name][0].RequestLedger(blocker / "led")
