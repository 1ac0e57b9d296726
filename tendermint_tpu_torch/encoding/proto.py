"""Minimal protobuf wire-format primitives.

Wire types: 0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit.
Only what the framework needs; deterministic by construction (fields
are written in the order the caller writes them — canonical encoders
write in ascending field order and skip zero values, matching proto3
canonical form).
"""

from __future__ import annotations

import struct


def encode_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64  # two's-complement, like protobuf int64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class Writer:
    """Append-only protobuf wire writer."""

    def __init__(self):
        self._buf = bytearray()

    def _tag(self, field: int, wire_type: int) -> None:
        self._buf += encode_varint((field << 3) | wire_type)

    def varint(self, field: int, v: int, *, skip_zero: bool = True) -> "Writer":
        if v == 0 and skip_zero:
            return self
        self._tag(field, 0)
        self._buf += encode_varint(v)
        return self

    def bool(self, field: int, v: bool) -> "Writer":
        return self.varint(field, 1 if v else 0)

    def sfixed64(self, field: int, v: int, *, skip_zero: bool = True) -> "Writer":
        if v == 0 and skip_zero:
            return self
        self._tag(field, 1)
        self._buf += struct.pack("<q", v)
        return self

    def bytes(self, field: int, v: bytes, *, skip_empty: bool = True) -> "Writer":
        if not v and skip_empty:
            return self
        self._tag(field, 2)
        self._buf += encode_varint(len(v))
        self._buf += v
        return self

    def string(self, field: int, v: str, *, skip_empty: bool = True) -> "Writer":
        return self.bytes(field, v.encode(), skip_empty=skip_empty)

    def message(self, field: int, sub: "Writer | bytes | None") -> "Writer":
        if sub is None:
            return self
        payload = sub.finish() if isinstance(sub, Writer) else sub
        self._tag(field, 2)
        self._buf += encode_varint(len(payload))
        self._buf += payload
        return self

    def finish(self) -> bytes:
        return bytes(self._buf)
