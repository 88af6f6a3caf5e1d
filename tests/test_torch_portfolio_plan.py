"""Portfolio planning (`service/portfolio.plan_members`) against the JAX
package's: the configurations, member requests and tuner calls JAX's
gives for the same request and tuner answers (none, cached plans, a
tuner that raises), for several K. The races themselves are
test_torch_portfolio.py's.

Tolerance: exact (integer counts, JSON)."""

import dataclasses

import pytest

from tpu_tree_search.problems import get as jproblem
from tpu_tree_search.service import SearchRequest as JRequest
from tpu_tree_search.service.portfolio import plan_members as jplan
from tpu_tree_search_torch.problems import get as tproblem
from tpu_tree_search_torch.service import SearchRequest
from tpu_tree_search_torch.service.portfolio import plan_members as tplan

import _torch_isolation
import _torch_threads
from _torch_durable import small

_torch_threads.share_cores()


@pytest.fixture(autouse=True)
def iso(monkeypatch):
    for k in ("TTS_MEGABATCH", "TTS_OVERLAP", "TTS_SHARE_INCUMBENT",
              "TTS_REMEDIATE", "TTS_LEDGER", "TTS_FLEET_DIR",
              "TTS_PORTFOLIO", "TTS_PORTFOLIO_MAX", "TTS_FAILOVER",
              "TTS_OBS_STORE", "TTS_TUNE_CACHE", "TTS_TUNE", "TTS_PREWARM",
              "TTS_FAULTS", "TTS_PROGRESS", "TTS_CAPACITY"):
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    with _torch_isolation.isolated():
        yield


@dataclasses.dataclass
class Params:
    chunk: int
    balance_period: int
    source: str


class FakeTuner:
    """Cached per-tier plans (or a failing tuner), its calls recorded."""

    def __init__(self, mode):
        self.mode, self.calls = mode, []

    def resolve(self, jobs, machines, lb, **kw):
        self.calls.append((jobs, machines, lb, sorted(kw.items())))
        if self.mode == "failing":
            raise RuntimeError("tuning cache unreadable")
        return Params(chunk=16 << lb, balance_period=2 + lb,
                      source="cache")


@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("tuner", [None, "cached", "failing"])
def test_plan_members_equal_jax(k, tuner):
    plans, calls = {}, {}
    for name, plan, Request, problem in (("jax", jplan, JRequest, jproblem),
                                         ("torch", tplan, SearchRequest,
                                          tproblem)):
        fake = FakeTuner(tuner) if tuner else None
        req = Request(p_times=small(0).p_times, lb_kind=1, chunk=64,
                      balance_period=4, tag="t", share_group=None)
        out = plan(req, problem("pfsp"), k, parent_tag="t", tuner=fake,
                   n_workers=2)
        plans[name] = [(m.lb_kind, m.chunk, m.balance_period,
                        m.share_group, m.tag, m.portfolio, c)
                       for m, c in out]
        calls[name] = fake.calls if fake else None
    assert plans["torch"] == plans["jax"]
    assert calls["torch"] == calls["jax"]
    got = plans["torch"]
    assert len(got) == k and got[0][:3] == (1, 64, 4)
    assert len({g[:3] for g in got}) == k
    assert all(g[3] == "pf:t" and g[5] is None for g in got)
