"""The port's incumbent board (`engine/incumbent.py`) against the JAX
package's, exactly: `instance_key` and `share_key` on a grid of tables,
dtypes, groups and problems; `IncumbentBoard` and `BoardClient` driven by
the same seeded operation sequences (publish, peek, cap, eviction), every
return value, the board's contents, the fold counters and the events
equal; a broken board's looser value audited and clamped the same way;
and `distributed.search` on a board: a lone client bit-identical to no
board, and a second search folding the first's best, both against JAX's
on four CPU workers."""

import numpy as np
import pytest

from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.engine import incumbent as jinc
from tpu_tree_search.obs import audit as jaudit
from tpu_tree_search.obs import metrics as jmetrics
from tpu_tree_search.obs import tracelog as jtracelog
from tpu_tree_search_torch.engine import distributed as tdist
from tpu_tree_search_torch.engine import incumbent as tinc
from tpu_tree_search_torch.engine import sequential as tseq
from tpu_tree_search_torch.obs import audit as taudit
from tpu_tree_search_torch.obs import metrics as tmetrics
from tpu_tree_search_torch.obs import tracelog as ttracelog
from tpu_tree_search_torch.problems.pfsp import PFSPInstance

import _torch_isolation
import _torch_threads

_torch_threads.share_cores()


@pytest.fixture(autouse=True)
def _isolated():
    with _torch_isolation.isolated():
        yield


def _folds(metrics_mod):
    c = metrics_mod.default().counter("tts_incumbent_folds_total")
    return c.value(direction="in"), c.value(direction="out")


def _events(tracelog_mod, prefix):
    return [{k: v for k, v in r.items() if k not in ("t", "ts", "seq")}
            for r in tracelog_mod.get().records()
            if r.get("name", "").startswith(prefix)]


# ------------------------------------------------------------------ keys

def test_keys_match_jax():
    rng = np.random.default_rng(0)
    tables = [PFSPInstance.synthetic(jobs=j, machines=m, seed=s).p_times
              for j, m, s in ((8, 4, 0), (20, 5, 1), (20, 20, 2))]
    tables += [rng.integers(0, 100, (5, 7)), np.zeros((0, 3)),
               np.arange(12).reshape(3, 4), np.arange(12).reshape(4, 3)]
    for t in tables:
        for dt in (np.int16, np.int32, np.int64, np.float64):
            x = t.astype(dt)
            for group in (None, "", "tenant-a", "a/b"):
                assert tinc.instance_key(x, group) == \
                    jinc.instance_key(x, group)
                for problem in ("pfsp", "tsp", "knapsack", "nqueens"):
                    assert tinc.share_key(x, problem, group) == \
                        jinc.share_key(x, problem, group)
        assert tinc.instance_key(t.tolist()) == \
            jinc.instance_key(t.tolist())


# ----------------------------------------------------- board and clients

@pytest.mark.parametrize("seed", range(6))
def test_board_and_clients_match_jax_on_seeded_operations(seed,
                                                          monkeypatch):
    rng = np.random.default_rng(seed)
    max_keys = int(rng.integers(1, 4))
    if seed % 2:
        # the bound from the environment (monkeypatched: restored after)
        monkeypatch.setenv("TTS_INCUMBENT_MAX_KEYS", str(max_keys))
        boards = (tinc.IncumbentBoard(), jinc.IncumbentBoard())
    else:
        boards = (tinc.IncumbentBoard(max_keys), jinc.IncumbentBoard(max_keys))
    keys = [f"k{i}" for i in range(4)]
    clients = [(tinc.BoardClient(boards[0], k, source=f"s{i}"),
                jinc.BoardClient(boards[1], k, source=f"s{i}"))
               for i, k in enumerate(keys * 2)]
    for _ in range(300):
        op = rng.integers(0, 4)
        if op == 0:
            i = int(rng.integers(len(clients)))
            v = int(rng.choice([rng.integers(900, 1100),
                                np.iinfo(np.int32).max]))
            got, want = (c.publish(v) for c in clients[i])
        elif op == 1:
            i = int(rng.integers(len(clients)))
            got, want = (c.cap() for c in clients[i])
        elif op == 2:
            k = keys[int(rng.integers(len(keys)))]
            v = int(rng.integers(900, 1100))
            got, want = (b.publish(k, v, source="direct") for b in boards)
        else:
            k = keys[int(rng.integers(len(keys)))]
            got, want = (b.peek(k) for b in boards)
        assert got == want
        assert boards[0].snapshot() == boards[1].snapshot()
        assert list(boards[0].snapshot()) == list(boards[1].snapshot())
        assert len(boards[0]) == len(boards[1]) <= max_keys
    assert _folds(tmetrics) == _folds(jmetrics)
    assert _folds(tmetrics)[0] > 0 and _folds(tmetrics)[1] > 0
    assert _events(ttracelog, "incumbent.") == _events(jtracelog,
                                                       "incumbent.")


def test_lone_client_never_folds_its_own_best():
    for inc in (tinc, jinc):
        board = inc.IncumbentBoard(8)
        c = inc.BoardClient(board, "k")
        assert c.cap() is None                  # nothing published
        assert c.publish(np.iinfo(np.int32).max) is False   # the sentinel
        assert c.publish(1000) and c.cap() is None          # no self-fold
        assert c.publish(990) and c.cap() is None
        assert board.publish("k", 980)          # a peer's tighter value
        # folded once: the client's best is now the board's
        assert c.cap() == 980 and c.cap() is None
    assert _folds(tmetrics) == _folds(jmetrics) == (1, 3)


@pytest.mark.parametrize("hard", [False, True])
def test_looser_board_value_is_audited_and_clamped_as_jax(hard,
                                                          monkeypatch):
    if hard:
        monkeypatch.setenv("TTS_AUDIT_HARD", "1")
    got = []
    for inc, audit in ((tinc, taudit), (jinc, jaudit)):
        board = inc.IncumbentBoard(8)
        c = inc.BoardClient(board, "k")
        board.publish("k", 900)
        first = c.cap()
        # a broken exchange: the board hands out a looser value
        monkeypatch.setattr(board, "peek", lambda key: 950)
        c._last_best = 1000
        if hard:
            with pytest.raises(audit.AuditError, match="incumbent_monotone"):
                c.cap()
            got.append((first,))
        else:
            got.append((first, c.cap()))
    assert got[0] == got[1] == ((900,) if hard else (900, 900))
    for reg in (tmetrics, jmetrics):
        assert reg.default().counter("tts_audit_failures_total").value(
            invariant="incumbent_monotone") == 1
    monkeypatch.setenv("TTS_AUDIT", "0")
    assert taudit.enabled() is jaudit.enabled() is False


def test_check_incumbent_fold_matches_jax():
    for prev, new in ((None, 5), (7, 5), (5, 5), (5, 7)):
        got = taudit.check_incumbent_fold("k", prev, new)
        want = jaudit.check_incumbent_fold("k", prev, new)
        assert (got.invariant, got.ok, got.detail) == \
            (want.invariant, want.ok, want.detail)


# ------------------------------------------------ the board on a search

INST = PFSPInstance.synthetic(jobs=8, machines=4, seed=1)
# ub=inf: the incumbent moves during the search, so a fold that reached
# the workers would change their counts
RUN = dict(lb_kind=1, chunk=8, capacity=1 << 12, min_seed=4,
           segment_iters=4)


def _same_result(got, want):
    assert (got.explored_tree, got.explored_sol, got.best, got.complete) \
        == (want.explored_tree, want.explored_sol, want.best, want.complete)
    for f, v in want.per_device.items():
        np.testing.assert_array_equal(got.per_device[f], np.asarray(v),
                                      err_msg=f)


def test_lone_client_is_bit_identical_to_no_board():
    plain = tdist.search(INST.p_times, devices=["cpu"] * 4, **RUN)
    board = tinc.IncumbentBoard()
    shared = tdist.search(INST.p_times, devices=["cpu"] * 4,
                          incumbent_board=board, **RUN)
    _same_result(shared, plain)
    assert board.peek(tinc.share_key(INST.p_times)) == shared.best
    assert _folds(tmetrics)[0] == 0 and _folds(tmetrics)[1] >= 1


def test_second_search_folds_the_first_best_as_jax():
    """Two searches one after the other on one board: the second starts
    from the instance's known best (folded in before its first dispatch),
    proves it with a tree no larger than a solo run's, and every worker's
    counts equal JAX's doing the same on its board."""
    opt = tseq.pfsp_search(INST, lb=1).best
    runs = {}
    for name, inc, search, where in (
            ("port", tinc, tdist.search, dict(devices=["cpu"] * 4)),
            ("jax", jinc, jdist.search, dict(n_devices=4))):
        board = inc.IncumbentBoard()
        first = search(INST.p_times, incumbent_board=board, **where, **RUN)
        second = search(INST.p_times, incumbent_board=board,
                        init_ub=None, **where, **RUN)
        runs[name] = (first, second)
    solo = tdist.search(INST.p_times, devices=["cpu"] * 4, **RUN)
    for got, want in zip(runs["port"], runs["jax"]):
        _same_result(got, want)
    first, second = runs["port"]
    assert first.best == second.best == opt
    assert second.explored_tree <= solo.explored_tree
    assert _folds(tmetrics)[0] >= 1
    assert _folds(tmetrics) == _folds(jmetrics)
