"""RFC3339 -> unix-ns conversion (reference: libs/timeenc.py; Go tmjson
encodes times as RFC3339 strings with nanosecond fractions, this
repo's native types carry ns ints)."""

from __future__ import annotations

import re
from datetime import datetime, timezone

NS = 1_000_000_000
_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)
_RX = re.compile(
    r"^(\d{4}-\d{2}-\d{2}[Tt ]\d{2}:\d{2}:\d{2})"   # date-time
    r"(\.\d+)?"                                       # optional fraction
    r"(?:[Zz]|([+-]\d{2}:\d{2}))$"                    # Z or UTC offset
)


def rfc3339_to_ns(s: str) -> int:
    """'2020-10-21T08:44:52.160326989Z' (up to ns fraction, Z or a
    numeric UTC offset — Go emits offsets for non-UTC locations) ->
    unix ns. The Go zero time ('0001-01-01T00:00:00Z') and any
    pre-1970 date yield a negative ns count."""
    m = _RX.match(s.strip())
    if m is None:
        raise ValueError(f"not an RFC3339 timestamp: {s!r}")
    base, frac, off = m.groups()
    dt = datetime.fromisoformat(base.replace("t", "T") + (off or "+00:00"))
    ns = round((dt - _EPOCH).total_seconds()) * NS
    if frac:
        ns += int(frac[1:].ljust(9, "0")[:9])
    return ns
