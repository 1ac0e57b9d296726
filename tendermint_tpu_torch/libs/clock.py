"""Process-wide time source seam (reference: libs/clock.py).

Code that reads the clock for control flow — the breaker cooldowns of
crypto/batch.py, the consensus round start times, and the wall time
the state machine stamps on proposals, votes and WAL records — reads
it through this module. By default it is the stdlib's; a test (or
chip_smoke.py) installs a source it can advance, so a cooldown passes
without waiting for it and two state machines stamp the same times.
Pure measurements (perf_counter) do not go through here.
"""

from __future__ import annotations

import time as _time

# The installed source provides monotonic() -> float seconds and
# time_ns() -> int nanoseconds since the unix epoch, mutually coherent
# (the reference's install takes the same object).
_source = None


def install(source) -> None:
    """Install a time source (tests must uninstall)."""
    global _source
    _source = source


def uninstall() -> None:
    global _source
    _source = None


def installed():
    """The installed source, or None under real time."""
    return _source


def monotonic() -> float:
    s = _source
    return _time.monotonic() if s is None else s.monotonic()


def time_ns() -> int:
    s = _source
    return _time.time_ns() if s is None else s.time_ns()
