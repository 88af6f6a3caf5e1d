"""The port's foundations against the JAX package: Taillard matrices,
bound tables (pair order included), the import boundary, the CLI and the
device rule. All comparisons are exact: this is integer data."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_tree_search.ops import batched as jbatched
from tpu_tree_search.problems import taillard as jtaillard
from tpu_tree_search_torch.ops import batched as tbatched
from tpu_tree_search_torch.problems import taillard as ttaillard

import _torch_threads

_torch_threads.share_cores()

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden" / "taillard_fnv.jsonl"
FNV_ROWS = [json.loads(l) for l in GOLDEN.read_text().splitlines()]


def fnv1a(values: np.ndarray) -> str:
    acc = 1469598103934665603
    for v in values.ravel():
        acc ^= int(np.uint32(v))
        acc = (acc * 0x100000001B3) % (1 << 64)
    return format(acc, "x")


@pytest.mark.parametrize("row", FNV_ROWS[::6], ids=lambda r: f"ta{r['inst']:03d}")
def test_taillard_fingerprint(row):
    p = ttaillard.processing_times(row["inst"])
    assert fnv1a(p) == row["fnv"]
    assert ttaillard.optimal_makespan(row["inst"]) == \
        jtaillard.optimal_makespan(row["inst"])
    assert p.shape == (ttaillard.nb_machines(row["inst"]),
                       ttaillard.nb_jobs(row["inst"]))


def _synthetic(jobs, machines, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 100, size=(machines, jobs)).astype(np.int32)


@pytest.mark.parametrize("name,p", [
    ("ta003", jtaillard.processing_times(3)),
    ("ta021", jtaillard.processing_times(21)),
    ("50x20", _synthetic(50, 20, 51)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_make_tables_equal_elementwise(name, p):
    want = jbatched.make_tables(p)
    got = tbatched.make_tables(p, device="cpu")
    for f in jbatched.BoundTables._fields:
        g = getattr(got, f)
        assert g.dtype == torch.int32, f
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f"{name}.{f}")


def test_pair_order_is_calibrated_and_split_matches():
    p = jtaillard.processing_times(21)
    got = tbatched.make_tables(p, device="cpu")
    # 190 pairs > 2*PAIR_PREFILTER: the order is the calibrated one, not
    # the lexicographic pair enumeration
    assert not np.array_equal(got.ma0.numpy(), np.sort(got.ma0.numpy()))
    head, tail = tbatched.pair_split(got, tbatched.PAIR_PREFILTER)
    jhead, jtail = jbatched.pair_split(jbatched.make_tables(p),
                                       jbatched.PAIR_PREFILTER)
    assert head.js.shape[0] == 24 and tail.js.shape[0] == 166
    np.testing.assert_array_equal(head.js.numpy(), np.asarray(jhead.js))
    np.testing.assert_array_equal(tail.lag_js.numpy(),
                                  np.asarray(jtail.lag_js))


def test_sweep_tables_pack_the_pair_fields():
    t = tbatched.make_tables(jtaillard.processing_times(21), device="cpu")
    head, tail = tbatched.pair_split(t, tbatched.PAIR_PREFILTER)
    for part in (t, head, tail):
        steps, pairs = part.sweep_steps, part.sweep_pairs
        assert steps.is_contiguous() and pairs.is_contiguous()
        for k, f in enumerate(("js", "ptm0_js", "ptm1_js", "lag_js")):
            assert torch.equal(steps[..., k], getattr(part, f)), f
        assert torch.equal(pairs[:, 0], part.ma0)
        assert torch.equal(pairs[:, 1], part.ma1)
        assert torch.equal(pairs[:, 2], t.min_tails[part.ma0.long()])
        assert torch.equal(pairs[:, 3], t.min_tails[part.ma1.long()])


@pytest.mark.parametrize("inst", [21, 71], ids=["J20", "J100"])
@pytest.mark.parametrize("part", ["full", "head", "tail"])
def test_sweep_tables_match_jax_fields(inst, part):
    """The pair-sweep kernel's packed tables, full and cut by `pair_split`,
    hold the JAX BoundTables' LB2 fields row for row: steps {js, ptm0_js,
    ptm1_js, lag_js} per (pair, step), pairs {ma0, ma1, tail[ma0],
    tail[ma1]}; the cut tables are contiguous row ranges."""
    p = jtaillard.processing_times(inst)
    jt = jbatched.make_tables(p)
    tt = tbatched.make_tables(p, device="cpu")
    k = tbatched.PAIR_PREFILTER
    if part != "full":
        want = jbatched.pair_split(jt, k)[part == "tail"]
        got = tbatched.pair_split(tt, k)[part == "tail"]
        rows = slice(k, None) if part == "tail" else slice(None, k)
        assert got.sweep_steps.data_ptr() == \
            tt.sweep_steps[rows].data_ptr()
    else:
        want, got = jt, tt
    steps, pairs = got.sweep_steps, got.sweep_pairs
    P, J = np.asarray(want.js).shape
    assert steps.shape == (P, J, 4) and pairs.shape == (P, 4)
    assert steps.is_contiguous() and pairs.is_contiguous()
    for col, f in enumerate(("js", "ptm0_js", "ptm1_js", "lag_js")):
        np.testing.assert_array_equal(steps[..., col].numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    tails = np.asarray(jt.min_tails)
    ma0, ma1 = np.asarray(want.ma0), np.asarray(want.ma1)
    np.testing.assert_array_equal(
        pairs.numpy(), np.stack([ma0, ma1, tails[ma0], tails[ma1]], 1))


def test_ceiling_check_matches():
    p = np.full((3, 4), 3_000_000, np.int32)
    with pytest.raises(ValueError, match="2\\^24") as jerr:
        jbatched.make_tables(p)
    with pytest.raises(ValueError, match="2\\^24") as terr:
        tbatched.make_tables(p, device="cpu")
    assert str(jerr.value) == str(terr.value)


def test_port_imports_no_jax():
    """Every module of the port (found by walking the package, so a new
    one is covered) imports no `jax` and nothing of `tpu_tree_search`;
    `chip_smoke.py`, which exits where there is no card, names neither."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpu_tree_search_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tpu_tree_search' or m.startswith('tpu_tree_search.')]\n"
        "assert not bad, bad\n"
        "print(' '.join(sorted(names)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    for want in ("cli", "convert", "engine.checkpoint", "engine.device",
                 "engine.sequential", "engine.telemetry", "kernel_times",
                 "obs.audit", "obs.capacity", "obs.estimate", "obs.health",
                 "obs.metric_names", "obs.metrics", "obs.resource",
                 "obs.store", "obs.tracelog", "obs.aggregate",
                 "obs.chrome_trace", "obs.dashboard", "obs.httpd",
                 "obs.otel", "obs.profiler", "ops.batched",
                 "ops.columns", "ops.expand", "ops.fused", "ops.kernels",
                 "ops.nqueens_ops", "ops.reference", "parallel.balance",
                 "problems.base", "problems.knapsack", "problems.nqueens",
                 "problems.pfsp", "problems.taillard", "problems.tsp",
                 "profile_step", "tune.defaults", "utils.config",
                 "utils.device_info", "utils.faults", "utils.retry"):
        assert f"tpu_tree_search_torch.{want}" in names, want
    smoke = (ROOT / "chip_smoke.py").read_text()
    for line in smoke.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            mod = words[1]
            assert mod != "jax" and not mod.startswith("jax."), line
            assert mod.split(".")[0] != "tpu_tree_search", line


def test_cli_cpu_ta002_lb1():
    out = subprocess.run(
        [sys.executable, "-m", "tpu_tree_search_torch", "pfsp", "-i", "2",
         "-l", "1", "-u", "1", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "Size of the explored tree: 30" in out.stdout
    assert "Optimal makespan: 1359" in out.stdout


def test_cuda_without_device_raises(monkeypatch):
    from tpu_tree_search_torch.engine import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.search(jtaillard.processing_times(2), lb_kind=1,
                      init_ub=1359, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatched.make_tables(jtaillard.processing_times(2), device="cuda")
