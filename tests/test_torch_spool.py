"""The port's spool, admission queue and batch-former against the JAX
package's.

The same request payloads (Taillard ids with `ub: "opt"`, raw tables of
every problem, tuned knobs, tenants, deadlines, checkpoint meta) go
through both packages' `request_from_payload` and `payload_from_request`:
the rebuilt requests and the JSON bytes are equal, and so are the
validation verdicts. `RequestQueue.pop_best` (with and without an
eligibility predicate), `waiting_ids`, `best_priority`,
`count_priority_above`, the admission bound and the peak depth agree on
a numpy-seeded stream of admits, requeues, cancels and pops;
`BatchFormer.pop_ready` gives the same groups and reasons under one
pinned clock (both modules' `time` patched). `submit_file`,
`unserved_requests` and `serve_spool` over a stub server write the same
result files, a malformed request gets a REJECTED result, and a paused
server's backlog waits in the spool. Exact."""

import json
import time

import numpy as np
import pytest

from tpu_tree_search.service import batching as jbatch
from tpu_tree_search.service import queueing as jqueue
from tpu_tree_search.service import request as jreq
from tpu_tree_search.service import spool as jspool
from tpu_tree_search_torch.service import batching as tbatch
from tpu_tree_search_torch.service import queueing as tqueue
from tpu_tree_search_torch.service import request as treq
from tpu_tree_search_torch.service import spool as tspool

import _torch_isolation

PKGS = (("jax", jreq, jqueue, jbatch, jspool),
        ("torch", treq, tqueue, tbatch, tspool))


@pytest.fixture(autouse=True)
def iso():
    with _torch_isolation.isolated():
        yield


def _tables(rng):
    pf = rng.integers(1, 99, size=(4, 9)).astype(np.int32)
    d = rng.integers(1, 50, size=(6, 6)).astype(np.int32)
    np.fill_diagonal(d, 0)
    ks = np.zeros((3, 8), np.int32)
    ks[0] = rng.integers(1, 20, 8)
    ks[1] = rng.integers(1, 30, 8)
    ks[2, 0] = 40
    nq = np.zeros((1, 7), np.int32)
    return {"pfsp": pf, "tsp": d, "knapsack": ks, "nqueens": nq}


def payloads(seed: int) -> list:
    rng = np.random.default_rng(seed)
    t = _tables(rng)
    out = [{"inst": int(rng.integers(1, 121)), "lb": 2, "ub": "opt"},
           {"inst": 21, "ub": None, "tuned": True, "priority": 3},
           {"inst": 7, "lb": 0, "chunk": 128, "tuned": True,
            "deadline_s": 2.5, "tag": "x", "tenant": "team-a"}]
    for name, table in t.items():
        out.append({"problem": name, "p_times": table.tolist(),
                    "capacity": int(rng.integers(1, 9)) << 12,
                    "min_seed": 4, "segment_iters": 16,
                    "checkpoint_every": 2, "share_group": "g",
                    "checkpoint_meta": {"inst": 3, "ub_mode": "opt"},
                    "balance_period": int(rng.integers(1, 9))})
    out.append({"p_times": t["pfsp"].tolist(), "lb": 7})        # invalid
    out.append({"p_times": t["pfsp"].tolist(), "deadline_s": -1.0})
    out.append({"p_times": t["pfsp"].tolist(), "portfolio": 3})
    out.append({"p_times": t["pfsp"].tolist(), "portfolio": 1,
                "tenant": ""})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_payloads_byte_for_byte(seed):
    for payload in payloads(seed):
        got = []
        for _, req, _, _, sp in PKGS:
            r = sp.request_from_payload(payload)
            back = sp.payload_from_request(r)
            got.append((json.dumps(back, sort_keys=False).encode(),
                        r.validate(), r.portfolio, r.tenant, r.chunk,
                        r.balance_period, r.init_ub,
                        np.asarray(r.p_times).tolist()))
        assert got[1] == got[0], payload


def test_payload_errors_as_jax():
    for bad in ({"lb": 1}, {"problem": "tsp", "inst": 3},
                {"p_times": [[1, 2], [3, 4]], "ub": "opt"}):
        msgs = []
        for _, _, _, _, sp in PKGS:
            with pytest.raises(ValueError) as e:
                sp.request_from_payload(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def _queue_run(req, queue, seed: int):
    rng = np.random.default_rng(seed)
    q = queue.RequestQueue(6)
    recs, out = [], []
    table = np.zeros((2, 3), np.int32)
    for step in range(80):
        r = rng.random()
        if r < 0.4:
            rec = req.RequestRecord(
                id=f"req-{step:04d}", seq=step,
                request=req.SearchRequest(
                    p_times=table, priority=int(rng.integers(-2, 3))))
            try:
                q.admit(rec)
                recs.append(rec)
                out.append(("admit", rec.id))
            except queue.AdmissionError as e:
                out.append(("rejected", str(e)))
        elif r < 0.55 and recs:
            rec = recs[int(rng.integers(0, len(recs)))]
            rec.state = req.PREEMPTED
            q.requeue(rec)
            out.append(("requeue", rec.id))
        elif r < 0.65 and recs:
            rec = recs[int(rng.integers(0, len(recs)))]
            rec.state = req.CANCELLED
            out.append(("cancel", rec.id))
        elif r < 0.8:
            excl = int(rng.integers(0, 3))
            for rec in recs:
                rec.excluded_submeshes = {excl} if int(rec.seq) % 3 == 0 \
                    else set()
            got = q.pop_best(eligible=lambda r: excl not in
                             r.excluded_submeshes)
            if got is not None:
                got.state = req.RUNNING
            out.append(("pop_eligible", got and got.id))
        else:
            got = q.pop_best()
            if got is not None:
                got.state = req.RUNNING
            out.append(("pop", got and got.id))
        q.observe_backlog(int(rng.integers(0, 3)))
        out.append((q.waiting_ids(), len(q), q.best_priority(),
                    q.count_priority_above(0), q.peak_depth, q.rejected,
                    q.peek_best() and q.peek_best().id))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queue_pop_order_as_jax(seed):
    got = [_queue_run(req, queue, seed) for _, req, queue, _, _ in PKGS]
    assert got[1] == got[0]


class Clock:
    def __init__(self):
        self.now = 50.0

    def monotonic(self):
        return self.now


def _former_run(req, batching, seed, monkeypatch):
    clock = Clock()
    monkeypatch.setattr(batching, "time", clock)
    rng = np.random.default_rng(seed)
    f = batching.BatchFormer(max_size=3, age_s=0.25)
    table = np.zeros((2, 3), np.int32)
    out, n = [], 0
    for step in range(120):
        r = rng.random()
        if r < 0.5:
            rec = req.RequestRecord(id=f"req-{n:04d}", seq=n,
                                    request=req.SearchRequest(p_times=table))
            n += 1
            if rng.random() < 0.1:
                rec.state = req.CANCELLED
            f.offer(("k", int(rng.integers(0, 3))), rec)
        elif r < 0.8:
            got = f.pop_ready()
            out.append(None if got is None
                       else ([x.id for x in got[0]], got[1]))
        else:
            clock.now += float(rng.choice([0.05, 0.1, 0.3]))
        out.append((len(f), f.waiting_ids()))
    out.append([x.id for x in f.drain()])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_former_groups_as_jax(seed, monkeypatch):
    got = [_former_run(req, batching, seed, monkeypatch)
           for _, req, _, batching, _ in PKGS]
    assert got[1] == got[0]
    assert any(isinstance(x, tuple) and x[1] == "age" for x in got[1])
    assert any(isinstance(x, tuple) and x[1] == "size" for x in got[1])


class StubServer:
    """Admits every request and turns it terminal at once (paused while
    `paused` is set)."""

    def __init__(self, req, queue):
        self.req, self.queueing = req, queue
        self.queue = queue.RequestQueue(8)
        self.slots = []
        self.paused = None
        self.snaps = {}

    def admission_paused(self):
        return self.paused

    def submit(self, request, spool_id=None):
        reason = request.validate()
        if reason is not None:
            raise self.queueing.AdmissionError(f"invalid request: {reason}")
        rid = f"req-{len(self.snaps):04d}"
        self.snaps[rid] = {"id": rid, "state": self.req.DONE,
                           "lb_kind": request.lb_kind,
                           "shape": list(np.asarray(request.p_times).shape)}
        return rid

    def status(self, rid):
        return self.snaps[rid]

    def status_snapshot(self):
        return {"requests": dict(self.snaps)}


def test_spool_serve_loop_as_jax(tmp_path):
    files = {}
    for name, req, queue, _, sp in PKGS:
        d = tmp_path / name
        srv = StubServer(req, queue)
        srv.paused = "storm"
        ids = [sp.submit_file(d, p, spool_id=f"s{i}")
               for i, p in enumerate(payloads(3)[:4] + [{"lb": 1}])]
        # paused: the backlog waits, nothing is written (a paused server
        # is not idle, so the loop runs until told to exit)
        t_end = time.monotonic() + 0.1
        assert sp.serve_spool(srv, d, idle_exit_s=0.05, poll_s=0.01,
                              should_exit=lambda: time.monotonic()
                              > t_end) == 0
        assert [s for s, _ in sp.unserved_requests(d)] == ids
        srv.paused = None
        served = sp.serve_spool(srv, d, idle_exit_s=0.05, poll_s=0.01)
        assert list(sp.unserved_requests(d)) == []
        files[name] = (served, {s: sp.wait_result(d, s, timeout=1)
                                for s in ids})
    assert files["torch"] == files["jax"]
    assert files["torch"][1]["s4"]["state"] == "REJECTED"
