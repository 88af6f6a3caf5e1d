"""`ops/kernels.build`: one compiler call per missing library, and the
compiler's log kept beside each library, so that a cached library still
reports ptxas's registers, stack frame and spills (`chip_smoke.py` fails
on a stack frame or a spill in any sweep or fused instance).

`nvcc` is replaced by a small script that writes its `-o` target and
prints a log in ptxas's format; nothing is compiled."""

import sys

import pytest

from tpu_tree_search_torch.ops import kernels

import _torch_threads

_torch_threads.share_cores()

FAKE_NVCC = """\
import sys
from pathlib import Path
here = Path(sys.argv[0]).parent
args = sys.argv[1:]
with open(here / "calls.txt", "a") as calls:
    calls.write(args[-1] + "\\n")
if (here / "fail").exists():
    print("error: no")
    sys.exit(1)
Path(args[args.index("-o") + 1]).write_bytes(b"so")
print("ptxas info    : Compiling entry function '_Z4kernv' for 'sm_90a'")
print("ptxas info    : Function properties for _Z4kernv")
print("    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
print("ptxas info    : Used 40 registers")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """Point `build` at a scratch build directory and a fake compiler (a
    Python script run by this interpreter, its flags the script's path);
    returns (fail, compiled): fail() makes every later compile fail, and
    compiled() lists the sources compiled so far."""
    script = tmp_path / "fake_nvcc.py"
    script.write_text(FAKE_NVCC)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(kernels, "_nvcc", lambda: sys.executable)
    monkeypatch.setattr(kernels, "NVCC_FLAGS", (str(script),))

    def fail():
        (tmp_path / "fail").write_text("")

    def compiled():
        calls = tmp_path / "calls.txt"
        return calls.read_text().split() if calls.exists() else []
    return fail, compiled


@pytest.mark.parametrize("stem", ["expand_bound", "lb2_sweep",
                                  "fused_expand"])
def test_build_returns_the_kept_log_when_cached(fake_nvcc, stem):
    """The first build compiles and returns the compiler's log; the
    second compiles nothing and returns the same log, read from beside
    the library."""
    _, compiled = fake_nvcc
    first = kernels.build([stem])
    assert list(first) == [stem] and len(compiled()) == 1
    seconds, log = first[stem]
    assert seconds > 0 and "0 bytes spill stores" in log
    lib = kernels.library_path(stem)
    assert lib.exists() and lib.with_suffix(".log").read_text() == log
    again = kernels.build([stem])
    assert again == {stem: (0.0, log)} and len(compiled()) == 1


def test_build_rebuilds_a_library_whose_log_is_gone(fake_nvcc):
    """A library without its log is compiled again, so no caller ever
    sees a library whose compiler output it cannot check."""
    _, compiled = fake_nvcc
    kernels.build(["lb2_sweep"])
    kernels.library_path("lb2_sweep").with_suffix(".log").unlink()
    seconds, log = kernels.build(["lb2_sweep"])["lb2_sweep"]
    assert seconds > 0 and "Used 40 registers" in log
    assert len(compiled()) == 2


def test_build_compiles_every_source_once_and_raises_on_failure(fake_nvcc):
    """All missing sources build in one call (one compiler run each); a
    failed compile raises with the compiler's output and leaves no
    library behind."""
    fail, compiled = fake_nvcc
    built = kernels.build()
    assert sorted(built) == sorted(kernels._SOURCES)
    assert sorted(compiled()) == sorted(
        str(kernels.CSRC / f"{s}.cu") for s in kernels._SOURCES)
    kernels.library_path("fused_expand").unlink()
    fail()
    with pytest.raises(RuntimeError, match="nvcc failed on fused_expand.cu"):
        kernels.build(["fused_expand"])
    assert not kernels.library_path("fused_expand").exists()
    assert not list(kernels.BUILD_DIR.glob("*.tmp"))
