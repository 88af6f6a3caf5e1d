"""The port's dispatch defaults (`tune/defaults.py`, `tune/__init__`)
against the JAX package's, exactly: the constants, `Params`,
`shape_class` and `params_for` on a grid of shapes, problems, batch
widths and every context (an unknown one raises the same error);
`distributed.search` with `chunk=None` / `balance_period=None` against
JAX's on four CPU workers, with its `tuner.resolve` event; and the tuner,
still refused, naming its ROADMAP item."""

import dataclasses
import itertools

import numpy as np
import pytest

from tpu_tree_search import tune as jtune
from tpu_tree_search.engine import distributed as jdist
from tpu_tree_search.tune import defaults as jdef
from tpu_tree_search_torch import tune as ttune
from tpu_tree_search_torch.engine import distributed as tdist
from tpu_tree_search_torch.obs import tracelog as ttracelog
from tpu_tree_search_torch.problems.pfsp import PFSPInstance
from tpu_tree_search_torch.tune import defaults as tdef

import _torch_isolation
import _torch_threads

_torch_threads.share_cores()


@pytest.fixture(autouse=True)
def _isolated():
    with _torch_isolation.isolated():
        yield


def _same_params(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_constants_and_params_fields_match_jax():
    for name in ("BALANCE_PERIOD_DEFAULT", "CLI_CHUNK_DEFAULT",
                 "SERVING_CHUNK_DEFAULT", "BENCH_CHUNK_DEFAULT",
                 "SERVING_BATCH_CHUNK_DEFAULT"):
        assert getattr(tdef, name) == getattr(jdef, name), name
    assert [(f.name, f.default) for f in dataclasses.fields(tdef.Params)] \
        == [(f.name, f.default) for f in dataclasses.fields(jdef.Params)]
    assert tdef.MEASURED.keys() == jdef.MEASURED.keys()
    for k, v in jdef.MEASURED.items():
        _same_params(tdef.MEASURED[k], v)
    assert tdef._FALLBACK.keys() == jdef._FALLBACK.keys()
    for k, v in jdef._FALLBACK.items():
        _same_params(tdef._FALLBACK[k], v)
    _same_params(tdef._FALLBACK_BATCHED, jdef._FALLBACK_BATCHED)
    assert ttune.Params is tdef.Params and ttune.defaults is tdef


PROBLEMS = ("pfsp", "nqueens", "tsp", "knapsack")
BATCHES = (None, 0, 1, 2, 4, 8, 16)


def test_shape_class_matches_jax():
    for jobs, machines, problem, batch in itertools.product(
            (1, 8, 20, 50, 500), (3, 5, 10, 20), PROBLEMS, BATCHES):
        assert tdef.shape_class(jobs, machines, problem, batch) == \
            jdef.shape_class(jobs, machines, problem, batch)
    # numpy integers label as Python ones
    assert tdef.shape_class(np.int64(20), np.int32(5)) == "20x5"


@pytest.mark.parametrize("context", ["bench", "serving", "cli"])
def test_params_for_matches_jax(context):
    shapes = [(None, None), (20, None), (None, 5)] + list(itertools.product(
        (8, 20, 50), (5, 10, 20)))
    for (jobs, machines), problem, batch in itertools.product(
            shapes, PROBLEMS, BATCHES):
        _same_params(
            tdef.params_for(context, jobs, machines, problem, batch),
            jdef.params_for(context, jobs, machines, problem, batch))


def test_unknown_context_raises_as_jax():
    with pytest.raises(ValueError) as want:
        jdef.params_for("batch", 20, 20)
    with pytest.raises(ValueError) as got:
        tdef.params_for("batch", 20, 20)
    assert str(got.value) == str(want.value)


def test_tuner_is_refused_naming_its_roadmap_item():
    """The tuner was refused here, naming ROADMAP A6, until it was ported:
    now each of its names resolves lazily, as in the JAX package, and
    `distributed.search` takes a tuner (with every knob given it runs the
    same search as without one)."""
    for name in ("Autotuner", "TuningCache", "ProbeHarness", "ProbeError",
                 "measure_balance_periods"):
        assert name in jtune.__all__ and name in ttune.__all__
        assert getattr(ttune, name).__name__ == name
    with pytest.raises(AttributeError):
        ttune.no_such_member
    table = PFSPInstance.synthetic(7, 3, 0).p_times
    kw = dict(devices=["cpu"] * 2, lb_kind=1, chunk=8, capacity=1 << 12,
              min_seed=4)
    got = tdist.search(table, tuner=ttune.Autotuner(device="cpu"), **kw)
    want = tdist.search(table, **kw)
    assert (got.explored_tree, got.best) == (want.explored_tree, want.best)


# ------------------------------------------- chunk=None on the search

SEARCH = dict(lb_kind=1, capacity=1 << 12, min_seed=4)


@pytest.mark.parametrize("open_knob", ["chunk", "balance_period", "both"])
def test_open_knobs_resolve_to_serving_defaults_as_jax(open_knob):
    table = PFSPInstance.synthetic(jobs=8, machines=4, seed=1).p_times
    kw = dict(SEARCH, chunk=8, balance_period=2)
    for k in (("chunk", "balance_period") if open_knob == "both"
              else (open_knob,)):
        kw[k] = None
    want = jdist.search(table, n_devices=4, **kw)
    got = tdist.search(table, devices=["cpu"] * 4, **kw)
    assert (got.explored_tree, got.explored_sol, got.best, got.complete) \
        == (want.explored_tree, want.explored_sol, want.best, want.complete)
    for f, v in want.per_device.items():
        np.testing.assert_array_equal(got.per_device[f], np.asarray(v),
                                      err_msg=f)
    ev = [r for r in ttracelog.get().records()
          if r.get("name") == "tuner.resolve"]
    serving = tdef.params_for("serving", 8, 4)
    assert len(ev) == 1 and ev[0]["source"] == "default"
    assert ev[0]["chunk"] == (serving.chunk if kw["chunk"] is None else 8)
    assert ev[0]["balance_period"] == (
        serving.balance_period if kw["balance_period"] is None else 2)
    assert ev[0]["fused"] == "off" and ev[0]["rung_profile"] is False
