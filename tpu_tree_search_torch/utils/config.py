"""Environment flags of the port.

Reproduces `env_flag` of `tpu_tree_search/utils/config.py` for the one
flag the port reads (`TTS_SEARCH_TELEMETRY`), with the same accepted
spellings. It defaults to off, as its row in the JAX package's registry
does.
"""

from __future__ import annotations

import os

_TRUTHY = ("1", "true", "on", "yes")


def env_flag(name: str) -> bool:
    """A boolean flag: '1'/'true'/'on'/'yes' (any case) is on; unset,
    empty or anything else is off."""
    return os.environ.get(name, "").strip().lower() in _TRUTHY
