"""Process-wide state that the port's ladder, board and defaults tests
touch, saved and restored around each test.

Under pytest-xdist (`--dist loadfile`) test files share a worker process
one after another, so a test that leaves a flight recorder, a metrics
registry, an audit finding or the ladder's memory-pressure hint behind
changes what a later file's test reads. `isolated()` gives both packages
a fresh tracelog and default metrics registry for the test, clears both
ladders' memory-pressure hint, and on exit puts back the recorders, the
registries, the hints and both packages' audit findings rings as they
were. `TTS_*` variables are the tests' `monkeypatch`'s to restore."""

import contextlib

from tpu_tree_search.engine import ladder as jladder
from tpu_tree_search.obs import audit as jaudit
from tpu_tree_search.obs import metrics as jmetrics
from tpu_tree_search.obs import tracelog as jtracelog
from tpu_tree_search_torch.engine import ladder as tladder
from tpu_tree_search_torch.obs import audit as taudit
from tpu_tree_search_torch.obs import metrics as tmetrics
from tpu_tree_search_torch.obs import tracelog as ttracelog


@contextlib.contextmanager
def isolated():
    """Fresh recorders and registries for both packages; everything put
    back on exit."""
    hints = [(m, m.memory_pressure()) for m in (jladder, tladder)]
    rings = []
    for m in (jaudit, taudit):
        with m._LOCK:
            rings.append((m, list(m._FINDINGS)))
    logs = [(m, m.install(m.TraceLog(capacity=1 << 16)))
            for m in (jtracelog, ttracelog)]
    regs = [(m, m.install(m.Registry("tts"))) for m in (jmetrics, tmetrics)]
    for m, _ in hints:
        m.set_memory_pressure(False)
    try:
        yield
    finally:
        for m, prev in regs:
            m.install(prev)
        for m, prev in logs:
            m.install(prev)
        for m, on in hints:
            m.set_memory_pressure(on)
        for m, findings in rings:
            with m._LOCK:
                m._FINDINGS.clear()
                m._FINDINGS.extend(findings)
