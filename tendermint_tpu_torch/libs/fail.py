"""Legacy failpoint shim (reference: tendermint_tpu/libs/fail.py; Go
libs/fail/fail.go).

The crash injection lives in libs/failpoints.py: the six fail() call
sites of the Go reference's commit path are named points
(consensus.commit.* / state.apply.*, failpoints.CRASH_SITES) hit
through the registry, which honours FAIL_TEST_INDEX with the original
ordinal semantics: the n-th legacy site reached in the process exits
hard (os._exit(1), no cleanup). This module keeps the old import
surface.

FAIL_TEST_INDEX is parsed once at first use; a malformed value is
logged and ignored instead of raising from inside consensus.
"""

from __future__ import annotations

from . import failpoints


def fail() -> None:
    failpoints.legacy_fail()


def reset() -> None:
    failpoints.reset()
