"""What the port's ledger tests share: both packages' ledger modules, a
settable clock pinned into each, a stand-in lease, and a script that
journals every record kind the server writes."""

import pytest

from tpu_tree_search.service import ledger as jledger
from tpu_tree_search.service.lease import LeaseLost as JLeaseLost
from tpu_tree_search_torch.service import ledger as tledger
from tpu_tree_search_torch.service.lease import LeaseLost as TLeaseLost

PKGS = {"jax": (jledger, JLeaseLost), "torch": (tledger, TLeaseLost)}


class Clock:
    """A stand-in for a module's `time`: wall time steps 0.25 s a call from
    a fixed start, monotonic time is real (it reaches no file)."""

    def __init__(self):
        import time as real
        self._real = real
        self.now = 1_700_000_000.0

    def time(self):
        self.now += 0.25
        return self.now

    def monotonic(self):
        return self._real.monotonic()


@pytest.fixture
def pinned(monkeypatch):
    """Each ledger module reads its own Clock (both start alike)."""
    for mod, _ in PKGS.values():
        monkeypatch.setattr(mod, "time", Clock())


class FakeLease:
    """What a ledger asks of its lease: the epoch, and a check that raises
    the package's LeaseLost once `lost` is set."""

    def __init__(self, epoch, lost_exc):
        self.epoch = epoch
        self.lost = False
        self._exc = lost_exc

    def check(self):
        if self.lost:
            raise self._exc("lease lost: epoch bumped")


def entry_snapshot(rid, state, best, spent):
    return {"id": rid, "state": state, "spent_s": spent, "tag": rid,
            "tenant": "-", "error": None,
            "result": {"best": best, "explored_tree": 100 + best,
                       "explored_sol": 3, "complete": state == "DONE"}}


def script(led):
    """Every record kind the server journals, in a serving order."""
    led.journal("boot", pid=4242, submeshes=2)
    for i in range(4):
        led.journal("admit", rid=f"req-{i:04d}", tag=f"t{i}", seq=i,
                    payload={"p_times": [[1, 2, 3], [4, 5, 6]], "lb": 1,
                             "chunk": 8, "faults": "delay_every=0.1"},
                    spool_id=f"sp{i}", tenant="team-a" if i % 2 else "-",
                    spent_s=0.5 * i)
    led.journal("batch", members=["req-0000", "req-0001"], reason="size",
                submesh=0)
    led.journal("dispatch", rid="req-0000", submesh=0, dispatch=1,
                batch="batch-0000", batch_size=2)
    led.journal("dispatch", rid="req-0002", submesh=1, dispatch=1)
    led.journal("budget", rid="req-0000", spent_s=5.125, progress=0.25)
    led.journal("preempt", rid="req-0000", preemptions=1, spent_s=6.5,
                hold=True)
    led.journal("release", rid="req-0000")
    led.journal("failure", rid="req-0002", submesh=1, attempt=1,
                error="transient: OSError()", failures=1, spent_s=1.0)
    led.journal("exclude", rid="req-0002", excluded=[1])
    led.journal("portfolio", rid="req-0003",
                members=[{"rid": "req-0001", "config": {"lb_kind": 0}},
                         {"rid": "req-0002", "config": {"lb_kind": 2}}])
    led.journal("quarantine", submesh=1, reason="3 failures")
    led.journal("pause", reason="compile storm")
    led.journal("readmit", submesh=1)
    led.journal("resume")
    led.journal("quarantine", submesh=0, reason="canary failed")
    led.journal("terminal", rid="req-0001", state="DONE",
                snapshot=entry_snapshot("req-0001", "DONE", 1234, 2.5))
    led.journal("terminal", rid="req-0003", state="CANCELLED",
                snapshot=entry_snapshot("req-0003", "CANCELLED", 99, 0.0))
    led.journal("unknown_kind_from_a_newer_binary", x=1)
    led.journal("takeover", owner="h:1:ab", from_epoch=1, pid=7,
                adopter="peer")
    led.journal("forget", rid="req-0003")
    led.journal("drain", pid=4242)


def segments(root) -> dict:
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())
            if p.is_file()}
