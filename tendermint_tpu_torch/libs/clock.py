"""Process-wide time source seam (reference: libs/clock.py).

Code that reads the clock for control flow — here the breaker
cooldowns of crypto/batch.py — reads it through this module. By default
it is time.monotonic; a test (or chip_smoke.py) installs a source it
can advance, so a cooldown passes without waiting for it. Pure
measurements (perf_counter) do not go through here.
"""

from __future__ import annotations

import time as _time

# The installed source provides monotonic() -> float seconds.
_source = None


def install(source) -> None:
    """Install a time source (tests must uninstall)."""
    global _source
    _source = source


def uninstall() -> None:
    global _source
    _source = None


def monotonic() -> float:
    s = _source
    return _time.monotonic() if s is None else s.monotonic()
