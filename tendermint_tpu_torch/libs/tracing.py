"""The consensus wire's origin tag (reference: libs/tracing.py:389-445),
as a plain codec.

A compact binary tag rides the consensus messages that define the
block lifecycle (Proposal, BlockPart, Vote; optional proto field 15):
the sender stamps (height, round, its node label, the span id active at
send time). The port has no span tracer yet, so it stamps span id 0,
which is what the reference stamps with no live span: the port's bytes
equal the reference's. The receiver decodes the tag and does not read
it. The reference's spans and their export come with the port's
tracing (ROADMAP Queue A item 5).
"""

from __future__ import annotations

import struct
from typing import NamedTuple

_ORIGIN_VERSION = 1
_ORIGIN_HDR = struct.Struct(">BQIQ")  # version, height, round, span_id
_ORIGIN_MAX_NODE = 64  # label bytes cap: tags stay wire-cheap


class OriginTag(NamedTuple):
    height: int
    round: int
    node: str
    span_id: int


def encode_origin(height: int, round_: int, node: str,
                  span_id: int = 0) -> bytes:
    """Binary origin tag: 21-byte fixed header + UTF-8 node label
    (truncated to 64 bytes). Total ≤ 85 bytes per stamped message."""
    label = node.encode("utf-8", "replace")[:_ORIGIN_MAX_NODE]
    return _ORIGIN_HDR.pack(
        _ORIGIN_VERSION, height & (2**64 - 1), round_ & (2**32 - 1),
        span_id & (2**64 - 1)) + label


def decode_origin(data: bytes | None) -> OriginTag | None:
    """Parse an origin tag; never raises. None on absent/short/
    unknown-version payloads — a garbled tag degrades to 'no tag',
    it must not take down message decode."""
    if not data or len(data) < _ORIGIN_HDR.size:
        return None
    try:
        ver, height, round_, span_id = _ORIGIN_HDR.unpack_from(data)
        if ver != _ORIGIN_VERSION:
            return None
        node = data[_ORIGIN_HDR.size:].decode("utf-8", "replace")
        return OriginTag(height, round_, node, span_id)
    except Exception:
        return None


def origin_stamp(node: str, height: int, round_: int) -> bytes:
    """Send-side: the tag for an outgoing lifecycle message (span id 0:
    no span is live in the port)."""
    return encode_origin(height, round_, node)
