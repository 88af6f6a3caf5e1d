"""The fleet the port's journey tests read: journal calls scripting a
restart, a takeover's `origin_rid` link, a portfolio fan-out and a
megabatch terminal, written through either package's ledger module."""


def snap(rid, state, spent, **kw):
    return {"id": rid, "state": state, "spent_s": spent, "tenant": "acme",
            "result": {"best": 1234, "explored_tree": 99,
                       "explored_sol": 2, "complete": state == "DONE"},
            **kw}


def write_fleet(root, mod):
    """Owner `a` restarts once, then dies; `b` adopts its request (an
    `origin_rid` link), finishes it, and runs a portfolio race."""
    a = mod.RequestLedger(root / "a")
    a.journal("boot", pid=11, submeshes=1)
    a.journal("admit", rid="req-0000", tag="j1", seq=0, payload={"lb": 1},
              tenant="acme", spent_s=0.0)
    a.journal("dispatch", rid="req-0000", submesh=0, dispatch=1)
    a.journal("budget", rid="req-0000", spent_s=1.5, progress=0.25)
    a.journal("preempt", rid="req-0000", preemptions=1, spent_s=1.75,
              hold=False)
    a.journal("boot", pid=12, submeshes=1)
    a.journal("dispatch", rid="req-0000", submesh=0, dispatch=2)
    a.journal("budget", rid="req-0000", spent_s=2.5, progress=0.5)
    a.journal("failure", rid="req-0000", submesh=0, attempt=2,
              error="transient: OSError()", failures=1, spent_s=2.75)
    a.journal("takeover", owner="h:13:ab", from_epoch=1, pid=13,
              adopter="b")
    a.journal("forget", rid="req-0000")
    a.close()
    b = mod.RequestLedger(root / "b")
    b.journal("boot", pid=13, submeshes=1)
    b.journal("admit", rid="req-0003", tag="j1", seq=3, payload={"lb": 1},
              tenant="acme", spent_s=2.75, origin_rid="req-0000",
              origin_owner="a")
    b.journal("dispatch", rid="req-0003", submesh=0, dispatch=3,
              batch="batch-0001", batch_size=2)
    b.journal("terminal", rid="req-0003", state="DONE",
              snapshot=snap("req-0003", "DONE", 4.0, batch="batch-0001"))
    b.journal("admit", rid="req-0004", tag="pf", seq=4,
              payload={"lb": 1, "portfolio": 2}, spent_s=0.0)
    for i, lb in ((5, 1), (6, 0)):
        b.journal("admit", rid=f"req-{i:04d}", tag=f"pf.pf{i - 5}", seq=i,
                  payload={"lb": lb}, spent_s=0.0)
    b.journal("portfolio", rid="req-0004",
              members=[{"rid": "req-0005", "config": {"lb_kind": 1}},
                       {"rid": "req-0006", "config": {"lb_kind": 0}}])
    b.journal("dispatch", rid="req-0005", submesh=0, dispatch=1)
    b.journal("terminal", rid="req-0005", state="DONE",
              snapshot=snap("req-0005", "DONE", 0.5))
    b.journal("terminal", rid="req-0004", state="DONE",
              snapshot=snap("req-0004", "DONE", 0.0))
    b.journal("terminal", rid="req-0006", state="CANCELLED",
              snapshot=snap("req-0006", "CANCELLED", 0.0))
    b.journal("drain", pid=13)
    b.close()
